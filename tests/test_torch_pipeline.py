"""The port's pipeline and CLI against the JAX pipeline, end to end.

`monortm_tpu_torch.pipeline.run(device="cpu")` (plain line sums) against
`monortm_tpu.pipeline.run(engine="hybrid", mesh=None, dtype=float32)`
(the Pallas kernel in interpret mode, as tests/test_pipeline_mesh.py runs
it) on the same rundirs: `make_minimal_rundir(nprof=3)` (IATM=0, 4
wavenumbers, 2 layers) and an IATM=1 run (US standard, 0-30 km, 0.2-1.2
cm^-1).  Tb / radiance / TMR agree at rtol 5e-5, atol 1e-4 K, and so does
every numeric token of MONORTM.OUT, of the IOD=1 layer files and of the
NetCDF variables; every other token and the LOG's echo are equal.

In float64 the port's `run(dtype=float64)` (the dense engine) is held to
`monortm_tpu.pipeline.run(dtype=float64, engine="xla", mesh=None)` on both
rundirs at the e2e oracle's float64 budgets (tests/test_e2e_oracle.py):
Tb and TMR within 1e-9 K, radiance, transmittance and OD at rtol 1e-10
(atol 1e-14), every numeric token of MONORTM.OUT likewise.  A chunked run
writes the same bytes as a single chunk.

`pipeline._in_background`, the hand-off from the producer thread, raises
the producer's exception in the caller, and once closed after the caller
raised leaves neither its thread nor the producer's generator running.
"""

import contextlib
import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from monortm_tpu.pipeline import run as j_run
from monortm_tpu_torch import cli
from monortm_tpu_torch import pipeline
from monortm_tpu_torch.pipeline import run
from monortm_tpu_torch.testing import make_minimal_rundir
from monortm_tpu_torch.utils.trace import StageTimer
from tests.test_torch_io import iatm1_tape5

RTOL, ATOL = 5e-5, 1e-4
# float64: Tb / TMR in K, the rest relative (atol 1e-14)
F64_TB_ATOL, F64_RTOL, F64_ATOL = 1e-9, 1e-10, 1e-14


def _files(d):
    return dict(filein=d / "MONORTM.IN", fileprof=d / "MONORTM_PROF.IN",
                hfile=d / "TAPE3")


def _jax(d, outdir, **kw):
    return j_run(**_files(d), outdir=d / outdir, mesh=None,
                 engine="hybrid", dtype=jnp.float32, **kw)


def _port(d, outdir, **kw):
    return run(**_files(d), outdir=d / outdir, device="cpu", **kw)


def _with_iod(text):
    """The rundir's MONORTM.IN with IOD=1 on record 1.2."""
    lines = text.splitlines()
    k = next(i for i, s in enumerate(lines) if s.startswith("$")) + 1
    r = lines[k].ljust(70)
    lines[k] = r[:64] + "1" + r[65:]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def iatm0(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchpipe")
    make_minimal_rundir(d, nprof=3)
    return d, _jax(d, "jax"), _port(d, "port")


@pytest.fixture(scope="module")
def iod(tmp_path_factory):
    """IOD=1 and --netcdf: per-layer arrays come to the host."""
    d = tmp_path_factory.mktemp("torchiod")
    make_minimal_rundir(d, nprof=2)
    (d / "MONORTM.IN").write_text(_with_iod((d / "MONORTM.IN").read_text()))
    return d, _jax(d, "jax", netcdf=True), _port(d, "port", netcdf=True)


@pytest.fixture(scope="module")
def iatm1(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchiatm1")
    make_minimal_rundir(d, nprof=1)
    (d / "MONORTM.IN").write_text(iatm1_tape5())
    # both packages' default layering: their native helpers, built from
    # the same source (tests/test_torch_native.py)
    return d, _jax(d, "jax"), _port(d, "port")


def _same_results(mine, ref, f64=False):
    assert len(mine.results) == len(ref.results) > 0
    np.testing.assert_array_equal(mine.wn, ref.wn)
    for a, b in zip(mine.results, ref.results):
        for f in ("tb", "rad", "tmr", "trtot", "otot"):
            x = np.asarray(getattr(a, f))
            assert np.isfinite(x).all(), f
            if not f64:
                tol = dict(rtol=RTOL, atol=ATOL)
            elif f in ("tb", "tmr"):
                tol = dict(rtol=0.0, atol=F64_TB_ATOL)
            else:
                tol = dict(rtol=F64_RTOL, atol=F64_ATOL)
            np.testing.assert_allclose(x, np.asarray(getattr(b, f)),
                                       err_msg=f, **tol)


def _num(tok):
    try:
        return float(tok)
    except ValueError:
        return None


def _same_tokens(mine, ref, rtol=RTOL, atol=ATOL):
    """Equal non-numeric tokens, numeric ones at rtol / atol."""
    la, lb = mine.read_text().splitlines(), ref.read_text().splitlines()
    assert len(la) == len(lb), (mine, len(la), len(lb))
    for sa, sb in zip(la, lb):
        ta, tb = sa.split(), sb.split()
        assert len(ta) == len(tb), (sa, sb)
        for x, y in zip(ta, tb):
            fx, fy = _num(x), _num(y)
            if fy is None:
                assert x == y, (sa, sb)
            else:
                assert fx is not None, (x, y, sb)
                assert abs(fx - fy) <= atol + rtol * abs(fy), (x, y, sb)


def _log_head(path):
    return path.read_text().split("Modules and versions")[0]


def test_iatm0_same_tb(iatm0):
    d, ref, mine = iatm0
    assert len(mine.tb) == 3
    _same_results(mine, ref)


def test_iatm0_same_monortm_out(iatm0):
    d, _, _ = iatm0
    _same_tokens(d / "port" / "MONORTM.OUT", d / "jax" / "MONORTM.OUT")


def test_iatm0_log_echo_and_host_pull(iatm0):
    """The LOG's control echo, line-file stats and layer tables are the
    JAX pipeline's; the default path pulls no per-layer array (the
    HOST PULL line, as tests/test_pipeline_mesh.py checks it)."""
    d, _, _ = iatm0
    assert _log_head(d / "port" / "MONORTM.LOG") == \
        _log_head(d / "jax" / "MONORTM.LOG")
    log = (d / "port" / "MONORTM.LOG").read_text()
    m = re.search(r"HOST PULL: (\d+) bytes.*pulled: (\w+)", log)
    assert m, "HOST PULL accounting line missing from MONORTM.LOG"
    nwn, nprof = 4, 3
    assert m.group(2) == "False"
    # rup/rdn/trtot/radtmr + otot + by_mol[M=7] + 6 continuum species:
    # 18 float32 [B, W] arrays; one [B, W, L] array would add L-fold
    assert int(m.group(1)) == 18 * nprof * nwn * 4
    assert "ENGINE SPLIT: 3 profile(s)" in log


def test_iod_layer_files_and_netcdf(iod):
    d, ref, mine = iod
    _same_results(mine, ref)
    _same_tokens(d / "port" / "MONORTM.OUT", d / "jax" / "MONORTM.OUT")
    names = sorted(p.name for p in (d / "jax").glob("ODmono_*"))
    assert len(names) == 2 * 2
    assert names == sorted(p.name for p in (d / "port").glob("ODmono_*"))
    for n in names:
        _same_tokens(d / "port" / n, d / "jax" / n)
    from scipy.io import netcdf_file
    for npr in (1, 2):
        name = f"MONORTM.{npr:05d}.nc"
        with netcdf_file(str(d / "port" / name), mmap=False) as a, \
                netcdf_file(str(d / "jax" / name), mmap=False) as b:
            assert sorted(a.variables) == sorted(b.variables)
            assert a.dimensions == b.dimensions
            for v in b.variables:
                x, y = a.variables[v][:], b.variables[v][:]
                if y.dtype.kind in "SU":
                    np.testing.assert_array_equal(x, y, err_msg=v)
                else:
                    np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                               err_msg=v)
    log = (d / "port" / "MONORTM.LOG").read_text()
    assert "per-layer arrays pulled: True" in log


def test_iatm1_same_tb_and_tape7(iatm1):
    d, ref, mine = iatm1
    assert len(mine.tb) == 1 and len(mine.wn) == 11
    _same_results(mine, ref)
    _same_tokens(d / "port" / "MONORTM.OUT", d / "jax" / "MONORTM.OUT")
    assert _log_head(d / "port" / "MONORTM.LOG") == \
        _log_head(d / "jax" / "MONORTM.LOG")
    # IPUNCH=1 on record 3.1: the layering's TAPE7
    assert (d / "port" / "TAPE7").read_bytes() == \
        (d / "jax" / "TAPE7").read_bytes()


def test_chunked_run_equals_single_chunk(iatm0, monkeypatch):
    """_max_batch forced to 1: three chunks through the producer thread
    (dispatch of chunk N+1 before the pull of chunk N) write the bytes of
    one chunk, as the JAX package's chunked run does
    (tests/test_pipeline.py)."""
    d, _, single = iatm0
    monkeypatch.setattr(pipeline, "_max_batch", lambda *a, **k: 1)
    chunked = _port(d, "chunked")
    assert [n for n, _, _ in chunked.engines] == [1, 1, 1]
    assert [n for n, _, _ in single.engines] == [3]
    _same_results(chunked, single)
    assert (d / "chunked" / "MONORTM.OUT").read_bytes() == \
        (d / "port" / "MONORTM.OUT").read_bytes()


def test_cli_writes_the_same_output(iatm0):
    d, _, _ = iatm0
    f = _files(d)
    assert cli.main(["--in", str(f["filein"]), "--prof", str(f["fileprof"]),
                     "--tape3", str(f["hfile"]), "--outdir",
                     str(d / "cli"), "--device", "cpu"]) == 0
    assert (d / "cli" / "MONORTM.OUT").read_bytes() == \
        (d / "port" / "MONORTM.OUT").read_bytes()


def test_refusals(iatm0, tmp_path):
    """A float32 kernel engine asked for at float64 raises before any
    file is written; without a card the default device raises; nothing
    falls back to the CPU.  IXSECT >= 1, once refused, runs (an IATM=1
    cross-section rundir: tests/test_torch_xsec.py holds it to the JAX
    pipeline)."""
    d, _, _ = iatm0
    f = _files(d)
    args = ["--in", str(f["filein"]), "--prof", str(f["fileprof"]),
            "--tape3", str(f["hfile"]), "--outdir", str(tmp_path / "o")]
    import torch
    for engine in ("full", "hybrid"):
        with pytest.raises(ValueError, match="float64"):
            cli.main(args + ["--device", "cpu", "--precision", "float64",
                             "--engine", engine])
        with pytest.raises(ValueError, match="float64"):
            run(**f, outdir=tmp_path / "o", device="cpu",
                dtype=torch.float64, engine=engine)
    assert not (tmp_path / "o").exists()
    from tests.test_torch_xsec import _iatm1_xsec_rundir
    _iatm1_xsec_rundir(tmp_path / "x")
    res = run(filein=tmp_path / "x" / "MONORTM.IN",
              hfile=tmp_path / "x" / "TAPE3", outdir=tmp_path / "x" / "o",
              device="cpu")
    assert np.asarray(res.results[0].odx).min() > 0.0
    assert (tmp_path / "x" / "o" / "MONORTM.OUT").exists()
    assert not (tmp_path / "o" / "TAPE7").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run(**f, outdir=tmp_path / "o")
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args + ["--precision", "float64"])
    assert not (tmp_path / "o" / "MONORTM.OUT").exists()


def _f64_rundir(d, kind):
    make_minimal_rundir(d, nprof=3 if kind == "iatm0" else 1)
    if kind == "iatm1":
        (d / "MONORTM.IN").write_text(iatm1_tape5())


@pytest.mark.parametrize("kind", ["iatm0", "iatm1"])
def test_float64_run_matches_jax(kind, tmp_path):
    """run(dtype=float64) against the JAX float64 pipeline's dense
    engine, on make_minimal_rundir (3 profiles) and the IATM=1 rundir."""
    import torch
    _f64_rundir(tmp_path, kind)
    ref = j_run(**_files(tmp_path), outdir=tmp_path / "jax", mesh=None,
                engine="xla", dtype=jnp.float64)
    mine = run(**_files(tmp_path), outdir=tmp_path / "port", device="cpu",
               dtype=torch.float64)
    assert all(np.asarray(r.tb).dtype == np.float64 for r in mine.results)
    assert [e for _, e, _ in mine.engines] == ["dense"]
    _same_results(mine, ref, f64=True)
    _same_tokens(tmp_path / "port" / "MONORTM.OUT",
                 tmp_path / "jax" / "MONORTM.OUT", rtol=F64_RTOL,
                 atol=F64_TB_ATOL)
    assert _log_head(tmp_path / "port" / "MONORTM.LOG") == \
        _log_head(tmp_path / "jax" / "MONORTM.LOG")


def test_cli_float64_writes_the_same_output(tmp_path):
    import torch
    _f64_rundir(tmp_path, "iatm0")
    f = _files(tmp_path)
    run(**f, outdir=tmp_path / "run", device="cpu", dtype=torch.float64)
    assert cli.main(["--in", str(f["filein"]), "--prof", str(f["fileprof"]),
                     "--tape3", str(f["hfile"]), "--outdir",
                     str(tmp_path / "cli"), "--device", "cpu",
                     "--precision", "float64"]) == 0
    assert (tmp_path / "cli" / "MONORTM.OUT").read_bytes() == \
        (tmp_path / "run" / "MONORTM.OUT").read_bytes()


def test_emis_dir(tmp_path):
    """A negative leading emissivity coefficient reads EMISSION from
    emis_dir, as the JAX pipeline's emis_dir does; without it the run
    looks in the "in" directory beside MONORTM.IN and fails there."""
    make_minimal_rundir(tmp_path, nprof=2)
    text = (tmp_path / "MONORTM.IN").read_text()
    rec = "     0.    1.0       0.000E+00"
    assert rec in text
    (tmp_path / "MONORTM.IN").write_text(
        text.replace(rec, "     0.   -1.0       0.000E+00"))
    ed = tmp_path / "spectra"
    ed.mkdir()
    z = 0.9 - 0.01 * np.arange(21)
    (ed / "EMISSION").write_text(
        f"{0.0:10.3E}{2.0:10.3E}{0.1:10.3E}     {21:5d}\n"
        + "".join(f"{v:15.7E}\n" for v in z))
    ref = _jax(tmp_path, "jax", emis_dir=ed)
    mine = _port(tmp_path, "port", emis_dir=ed)
    _same_results(mine, ref)
    emis = np.asarray(mine.results[0].emis)
    np.testing.assert_allclose(emis, np.asarray(ref.results[0].emis))
    assert 0.8 < emis.min() and emis.max() < 0.9
    _same_tokens(tmp_path / "port" / "MONORTM.OUT",
                 tmp_path / "jax" / "MONORTM.OUT")
    with pytest.raises(FileNotFoundError):
        _port(tmp_path, "nodir")


def test_cloud_file_od(tmp_path):
    """A TES cloud OD file (in_lblrtm_cld) in the rundir: its OD is added
    to the total on the device and printed as XSEC_OD, as the JAX
    pipeline does."""
    make_minimal_rundir(tmp_path, nprof=2)
    (tmp_path / "in_lblrtm_cld").write_text(
        "3\n0.5 1.0 1.5\n2\n1 900.0\n0.1 0.2 0.3\n2 800.0\n0.05 0.0 0.01\n")
    ref, mine = _jax(tmp_path, "jax"), _port(tmp_path, "port")
    _same_results(mine, ref)
    for a, b in zip(mine.results, ref.results):
        assert np.asarray(b.odx).max() > 0.1
        np.testing.assert_allclose(a.odx, b.odx, rtol=RTOL, atol=ATOL)
    _same_tokens(tmp_path / "port" / "MONORTM.OUT",
                 tmp_path / "jax" / "MONORTM.OUT")


def test_stacked_iatm1_worker_pool(tmp_path):
    """Four '$' blocks layered by two pooled worker processes (streamed
    into the producer) write what one process writes."""
    text = iatm1_tape5(v1=0.5, v2=1.0, dvset=0.25)
    block = text[text.index("$"):text.index("%")]
    (tmp_path / "MONORTM.IN").write_text(block * 4 + "%%%%\n")
    (tmp_path / "cat").mkdir()
    make_minimal_rundir(tmp_path / "cat", nprof=1)
    kw = dict(filein=tmp_path / "MONORTM.IN",
              hfile=tmp_path / "cat" / "TAPE3", device="cpu")
    one = run(**kw, outdir=tmp_path / "one", workers=1)
    two = run(**kw, outdir=tmp_path / "two", workers=2)
    assert len(one.tb) == len(two.tb) == 4
    assert (tmp_path / "one" / "MONORTM.OUT").read_bytes() == \
        (tmp_path / "two" / "MONORTM.OUT").read_bytes()
    assert (tmp_path / "one" / "TAPE7").read_bytes() == \
        (tmp_path / "two" / "TAPE7").read_bytes()


@pytest.mark.parametrize("raiser", ["producer", "caller"])
def test_in_background_raises_and_retires_its_thread(raiser):
    ran_on, closed_on = [], []

    def produce():
        ran_on.append(threading.current_thread())
        try:
            yield 1
            if raiser == "producer":
                raise ValueError("producer")
            while True:
                yield 2
        finally:
            closed_on.append(threading.current_thread())

    items = pipeline._in_background(produce(), StageTimer())
    with pytest.raises(ValueError, match=raiser):
        with contextlib.closing(items):
            assert next(items) == 1
            if raiser == "caller":
                raise ValueError("caller")
            next(items)
    # the generator ran, and was closed, on the hand-off's own thread,
    # which is gone
    assert ran_on == closed_on
    assert ran_on[0] is not threading.current_thread()
    assert not ran_on[0].is_alive()
