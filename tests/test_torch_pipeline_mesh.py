"""The port's pipeline on a mesh: `python -m monortm_tpu_torch.cli
--distributed --mesh PxW[xL]` in gloo ranks on the CPU against the
single-device CLI (the JAX package's tests/test_pipeline_mesh.py and
tests/test_multihost.py, for the port).

The rundir is `make_minimal_rundir`'s (3 profiles, 2 layers) with 300
wavenumbers over 0.3-8.7 cm^-1, so that the 128-wavenumber tiles split
over two wn ranks.  Held: MONORTM.OUT and the NetCDF files the bytes of
the single-device run on meshes 1x2, 2x1 and 2x2 (2x1 and 2x2 pad the
3-profile chunk to 4); on a line axis (1x1x2) Tb within 2e-3 K and the
layer OD at rtol 2e-5, atol 2e-6 x max, and the same bytes twice; float64
on 1x2 the bytes of the float64 single-device run; "auto" on two ranks
the bytes of one; a mesh whose size is not the world's raises; a rank
that fails stops the others.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from monortm_tpu_torch.parallel.distributed import spawn
from monortm_tpu_torch.testing import _MIN_TAPE5, make_minimal_rundir

ROOT = Path(__file__).resolve().parents[1]
NWN = 300
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _wide_rundir(d: Path, nprof: int = 3) -> Path:
    """make_minimal_rundir with NWN wavenumbers in MONORTM.IN's list."""
    make_minimal_rundir(d, nprof=nprof)
    head, rest = _MIN_TAPE5.split("\n4\n", 1)
    tail = rest.split("1.051763\n", 1)[1]
    wn = np.linspace(0.3, 8.7, NWN)
    (d / "MONORTM.IN").write_text(
        head + f"\n{NWN}\n" + "".join(f"{w:.6f}\n" for w in wn) + tail)
    return d


def _cli_args(d: Path, out: str, *extra):
    return ["-m", "monortm_tpu_torch.cli", "--in", str(d / "MONORTM.IN"),
            "--prof", str(d / "MONORTM_PROF.IN"), "--tape3",
            str(d / "TAPE3"), "--outdir", str(d / out), "--device", "cpu",
            *extra]


def _single(d: Path, out: str, *extra):
    res = subprocess.run([sys.executable, *_cli_args(d, out, *extra)],
                         cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _ranks(d: Path, out: str, n: int, mesh: str, *extra, ok=True):
    outs = spawn(_cli_args(d, out, "--distributed", "--mesh", mesh, *extra),
                 n, env=ENV, cwd=ROOT, timeout=300)
    if ok:
        for r, (rc, text) in enumerate(outs):
            assert rc == 0, f"rank {r} of {mesh}:\n{text[-4000:]}"
    return outs


def _bytes(d: Path, out: str, name="MONORTM.OUT") -> bytes:
    return (d / out / name).read_bytes()


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    d = _wide_rundir(tmp_path_factory.mktemp("wide"))
    _single(d, "single", "--netcdf")
    return d


@pytest.mark.parametrize("mesh,n", [("1x2", 2), ("2x1", 2), ("2x2", 4)])
def test_mesh_cli_writes_the_single_device_bytes(wide, mesh, n):
    outs = _ranks(wide, mesh, n, mesh, "--netcdf")
    assert _bytes(wide, mesh) == _bytes(wide, "single")
    for i in (1, 2, 3):
        nc = f"MONORTM.{i:05d}.nc"
        assert _bytes(wide, mesh, nc) == _bytes(wide, "single", nc), nc
    for r, (_, text) in enumerate(outs):
        assert f"rank {r} of {n}: backend gloo, device cpu" in text
        assert ("PROCESSING PROFILE NUMBER" in text) == (r == 0)
    log = (wide / mesh / "MONORTM.LOG").read_text()
    p, w = mesh.split("x")
    assert f" MESH: prof {p} x wn {w} over {n} ranks, backend gloo" in log


def _netcdf(path: Path):
    from scipy.io import netcdf_file
    with netcdf_file(str(path), mmap=False) as nc:
        return (np.array(nc.variables["BT"][:]),
                np.array(nc.variables["LAYER_OPTICAL_DEPTH"][:]))


def test_line_axis_mesh_cli(wide):
    """1x1x2: the candidate columns split over two line ranks; float32
    partial sums, so the single-device tolerance, and the same bytes
    from run to run."""
    for out in ("line_a", "line_b"):
        _ranks(wide, out, 2, "1x1x2", "--netcdf")
    assert _bytes(wide, "line_a") == _bytes(wide, "line_b")
    for i in (1, 2, 3):
        nc = f"MONORTM.{i:05d}.nc"
        tb, od = _netcdf(wide / "line_a" / nc)
        tb0, od0 = _netcdf(wide / "single" / nc)
        assert np.abs(tb - tb0).max() <= 2e-3
        np.testing.assert_allclose(od, od0, rtol=2e-5,
                                   atol=2e-6 * np.abs(od0).max())


def test_float64_mesh_cli(wide):
    _single(wide, "single64", "--precision", "float64")
    _ranks(wide, "mesh64", 2, "1x2", "--precision", "float64")
    assert _bytes(wide, "mesh64") == _bytes(wide, "single64")


def test_auto_mesh_on_the_minimal_rundir(tmp_path):
    """Two ranks, --mesh auto: the JAX choice puts both on "prof" (3
    profiles), the chunk pads to 4, and the bytes are the single run's."""
    make_minimal_rundir(tmp_path, nprof=3)
    _single(tmp_path, "single")
    outs = _ranks(tmp_path, "auto", 2, "auto")
    assert _bytes(tmp_path, "auto") == _bytes(tmp_path, "single")
    assert " MESH: prof 2 x wn 1 over 2 ranks" in \
        (tmp_path / "auto" / "MONORTM.LOG").read_text()
    assert all(rc == 0 for rc, _ in outs)


def test_mesh_size_must_be_the_worlds(tmp_path):
    make_minimal_rundir(tmp_path)
    outs = _ranks(tmp_path, "bad", 2, "2x2", ok=False)
    assert all(rc != 0 for rc, _ in outs)
    assert any("needs 4 rank(s); the world has 2" in t for _, t in outs)
    for extra, msg in ((("--mesh", "1x2"), "the world has 1"),
                       (("--backend", "gloo"), "--backend needs "
                                               "--distributed")):
        res = subprocess.run(
            [sys.executable, *_cli_args(tmp_path, "one", *extra)], cwd=ROOT,
            env=ENV, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and msg in res.stderr, res.stderr
    assert not (tmp_path / "bad" / "MONORTM.OUT").exists()
    assert not (tmp_path / "one" / "MONORTM.OUT").exists()


FAILING_RANK = """
import time
import torch.distributed as dist
from monortm_tpu_torch.parallel.distributed import init_distributed
init_distributed("gloo")
if dist.get_rank() == 1:
    raise SystemExit(3)
time.sleep(120)
"""


def test_a_failing_rank_fails_the_run():
    """`spawn` stops every rank as soon as one fails."""
    import time
    t0 = time.monotonic()
    outs = spawn(["-c", FAILING_RANK], 2, env=ENV, cwd=ROOT, timeout=300)
    assert outs[1][0] == 3 and outs[0][0] != 0, outs
    assert time.monotonic() - t0 < 60
