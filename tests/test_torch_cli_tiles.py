"""The port's dense-engine tiles and engine names against the JAX CLI's.

`python -m monortm_tpu_torch.cli` takes every option of
`monortm_tpu.cli` with its meaning: `--wn-tile` / `--line-tile` set the
dense engine's block (the kernels keep their own plan), and `--engine`
takes the JAX names `xla` / `pallas` beside the port's `dense` / `full`.

Held here: both CLIs with `--engine xla` at tiles that split both axes
several ways, the last tile ragged (64 wavenumbers x 32 lines on the
300-wavenumber rundir; 64 x 512 on the minimal one), float64 within
1e-9 K on Tb and TMR and rtol 1e-10 on the rest (tests/
test_torch_pipeline.py's bounds), float32 at rtol 5e-5 / atol 1e-4 K;
an alias writes its port name's bytes; the tiles written out at their
defaults write the default bytes; a non-positive tile is refused; a
dense-only model (`kernels=False`, the JAX `use_pallas=False`) builds
no kernel plan; the dense block's bytes and `_max_batch` at the tiles;
and the entry surface: every JAX CLI option and choice, and every JAX
`run()` keyword, exists in the port.
"""

import argparse
import inspect

import numpy as np
import pytest
import torch

from monortm_tpu import cli as j_cli
from monortm_tpu.pipeline import run as j_run
from monortm_tpu_torch import cli, pipeline
from monortm_tpu_torch.models.od import (DENSE_LINE_TILE, DENSE_LIVE,
                                         DENSE_ROWS, DENSE_WN_TILE, ODModel,
                                         dense_block_bytes)
from monortm_tpu_torch.pipeline import run
from monortm_tpu_torch.testing import (make_minimal_rundir, make_wide_rundir,
                                       synthetic_catalog_mw, synthetic_state)
from tests.test_torch_pipeline import (ATOL, F64_ATOL, F64_RTOL, F64_TB_ATOL,
                                       RTOL, _same_tokens)

# options of the port's CLI that the JAX CLI has not, by intent: the
# torch device, and the torch.distributed backend
PORT_ONLY_OPTIONS = {"--device", "--backend"}
# keywords of the port's run() that the JAX run() has not: the device
PORT_ONLY_KEYWORDS = {"device"}
# NetCDF variables that hold brightness temperatures (K)
TB_VARS = {"BT", "TMR"}


def _args(d, out, *extra):
    return ["--in", str(d / "MONORTM.IN"), "--prof",
            str(d / "MONORTM_PROF.IN"), "--tape3", str(d / "TAPE3"),
            "--outdir", str(d / out), "--mesh", "off", *extra]


def _both(d, tag, precision, *extra):
    """The JAX CLI and the port's (on the CPU) on rundir `d`."""
    flags = ("--precision", precision, *extra)
    assert j_cli.main(_args(d, f"jax_{tag}", *flags)) == 0
    assert cli.main(_args(d, f"port_{tag}", "--device", "cpu", *flags)) == 0
    return d / f"port_{tag}", d / f"jax_{tag}"


def _same_out(mine, ref, precision):
    """MONORTM.OUT's tokens: float64 as test_float64_run_matches_jax holds
    them, float32 at the pipeline's tolerance."""
    tol = (F64_RTOL, F64_TB_ATOL) if precision == "float64" else (RTOL, ATOL)
    _same_tokens(mine / "MONORTM.OUT", ref / "MONORTM.OUT", *tol)


def _tols(precision, name):
    if precision == "float32":
        return dict(rtol=RTOL, atol=ATOL)
    if name in TB_VARS:
        return dict(rtol=0.0, atol=F64_TB_ATOL)
    return dict(rtol=F64_RTOL, atol=F64_ATOL)


def _same_netcdf(mine, ref, precision):
    """Every variable of two NetCDF files: strings equal, numbers at the
    precision's bounds; a variable stored in float32 within one float32
    rounding (2**-23 of its value) at float64, the file's own precision."""
    from scipy.io import netcdf_file
    with netcdf_file(str(mine), mmap=False) as a, \
            netcdf_file(str(ref), mmap=False) as b:
        assert sorted(a.variables) == sorted(b.variables)
        assert a.dimensions == b.dimensions
        assert TB_VARS <= set(b.variables)
        for v in b.variables:
            x, y = a.variables[v][:], b.variables[v][:]
            if y.dtype.kind in "SU":
                np.testing.assert_array_equal(x, y, err_msg=v)
                continue
            tol = _tols(precision, v)
            if precision == "float64" and y.dtype == np.float32:
                tol = dict(rtol=2.0 ** -23, atol=F64_ATOL)
            np.testing.assert_allclose(x, y, err_msg=v, **tol)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    return make_wide_rundir(tmp_path_factory.mktemp("tiles_wide"))


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_xla_tiles_match_the_jax_cli(wide, precision):
    """--engine xla --wn-tile 64 --line-tile 32 on the 300-wavenumber
    rundir: 5 wavenumber tiles (the last of 44), 3 windowed line tiles
    (the last of 2) and 2 O2 tiles (the last of 16)."""
    mine, ref = _both(wide, precision, precision, "--engine", "xla",
                      "--wn-tile", "64", "--line-tile", "32", "--netcdf")
    _same_out(mine, ref, precision)
    for i in (1, 2, 3):
        nc = f"MONORTM.{i:05d}.nc"
        _same_netcdf(mine / nc, ref / nc, precision)
    log = (mine / "MONORTM.LOG").read_text()
    assert " ENGINE SPLIT: 3 profile(s): dense, 0 all-Lorentz" in log


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_roadmap_a19_tiles_on_the_minimal_rundir(tmp_path, precision):
    """--engine xla --wn-tile 64 --line-tile 512 on make_minimal_rundir."""
    make_minimal_rundir(tmp_path, nprof=3)
    mine, ref = _both(tmp_path, "a19", precision, "--engine", "xla",
                      "--wn-tile", "64", "--line-tile", "512")
    _same_out(mine, ref, precision)


@pytest.mark.parametrize("alias,name", [("xla", "dense"), ("pallas", "full")])
def test_engine_aliases_write_the_port_names_bytes(wide, alias, name):
    out = {}
    for e in (alias, name):
        assert cli.main(_args(wide, f"engine_{e}", "--device", "cpu",
                              "--engine", e)) == 0
        out[e] = (wide / f"engine_{e}" / "MONORTM.OUT").read_bytes()
        log = (wide / f"engine_{e}" / "MONORTM.LOG").read_text()
        assert f" ENGINE SPLIT: 3 profile(s): {name}, 0 all-Lorentz" in log
    assert out[alias] == out[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_explicit_default_tiles_write_the_default_bytes(tmp_path, dtype):
    make_minimal_rundir(tmp_path, nprof=3)
    files = dict(filein=tmp_path / "MONORTM.IN",
                 fileprof=tmp_path / "MONORTM_PROF.IN",
                 hfile=tmp_path / "TAPE3", device="cpu", dtype=dtype)
    a = run(**files, outdir=tmp_path / "plain")
    b = run(**files, outdir=tmp_path / "explicit", wn_tile=128,
            line_tile=4096)
    assert a.engines == b.engines
    for f in ("MONORTM.OUT", "MONORTM.LOG"):
        x = (tmp_path / "plain" / f).read_text()
        y = (tmp_path / "explicit" / f).read_text()
        if f.endswith("LOG"):     # the stage timings differ run to run
            x, y = x.split(" STAGE")[0], y.split(" STAGE")[0]
        assert x == y, f


def test_non_positive_tiles_are_refused(tmp_path, capsys):
    make_minimal_rundir(tmp_path)
    for flag, value in (("--wn-tile", "0"), ("--line-tile", "-4"),
                        ("--wn-tile", "x")):
        with pytest.raises(SystemExit) as e:
            cli.main(_args(tmp_path, "o", "--device", "cpu", flag, value))
        assert e.value.code == 2
        assert "a tile must be a positive integer" in capsys.readouterr().err
    files = dict(filein=tmp_path / "MONORTM.IN",
                 fileprof=tmp_path / "MONORTM_PROF.IN",
                 hfile=tmp_path / "TAPE3", outdir=tmp_path / "o",
                 device="cpu")
    for kw in (dict(wn_tile=0), dict(line_tile=-1)):
        with pytest.raises(ValueError, match="must be positive"):
            run(**files, **kw)
    assert not (tmp_path / "o").exists()
    wn = np.linspace(0.3, 8.7, 20)
    for kw in (dict(dense_wn_tile=0), dict(dense_line_tile=0),
               dict(wn_tile=-128)):
        with pytest.raises(ValueError, match="tiles must be positive"):
            ODModel(wn, 0.1, synthetic_catalog_mw(), nmol=22, device="cpu",
                    **kw)


def test_dense_only_model_builds_no_kernel_plan():
    """kernels=False (the JAX use_pallas=False): no plan, the dense engine
    by default and from engine_split, a kernel engine refused; its dense
    output that of a kernel model's dense engine at the same tiles."""
    wn = np.linspace(0.3, 8.7, 20)
    kw = dict(nmol=22, device="cpu", dense_wn_tile=8, dense_line_tile=16)
    dense = ODModel(wn, 0.1, synthetic_catalog_mw(), kernels=False, **kw)
    both = ODModel(wn, 0.1, synthetic_catalog_mw(), **kw)
    assert not dense.kernels and dense.dev_plans == {}
    assert not hasattr(dense, "plan") and hasattr(both, "plan")
    assert dense.default_engine == "dense" and both.default_engine == "full"
    st = synthetic_state(nlay=3, batch=2, device="cpu", dtype=torch.float32)
    assert dense.engine_split(st) == ("dense", ())
    for engine in ("full", "lorentz", "hybrid"):
        with pytest.raises(ValueError, match="kernels=False"):
            dense(st, engine=engine, lor_layers=(0,))
    with torch.no_grad():
        a, b = dense(st), both(st, engine="dense")
    assert dense.dense["wt"] == 8
    assert torch.equal(a.od_total, b.od_total)


def test_dense_block_bytes_and_max_batch_at_the_tiles():
    """Phase 9's cell (1024 wn x 40 layers x 22 molecules x 3074 lines,
    float64) under a 2 GB budget: the default block (9.7 GB) leaves a
    chunk of 1, the 64 x 512 block (0.8 GB) a chunk of 65."""
    n, item = 3074, 8
    assert dense_block_bytes(n, item, 128, 4096) == \
        DENSE_ROWS * 128 * n * item * DENSE_LIVE
    assert dense_block_bytes(n, item, 64, 512) == \
        DENSE_ROWS * 64 * 512 * item * DENSE_LIVE == 805306368
    per = pipeline._profile_bytes(1024, 40, 22, n, item, dense=True)
    kw = dict(itemsize=item, dense=True)
    assert pipeline._max_batch(1024, 40, 22, n, 2e9, **kw) == 1
    assert pipeline._max_batch(1024, 40, 22, n, 2e9, wn_tile=128,
                               line_tile=4096, **kw) == 1
    small = pipeline._max_batch(1024, 40, 22, n, 2e9, wn_tile=64,
                                line_tile=512, **kw)
    assert small == int((2e9 - 805306368) // per) == 65
    # the kernels' cap does not read the dense tiles
    assert pipeline._max_batch(1024, 40, 22, n, 2e9, wn_tile=64,
                               line_tile=512) == \
        pipeline._max_batch(1024, 40, 22, n, 2e9)


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser `main` builds, caught at its parse_args."""
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return {s: a for a in seen[0]._actions for s in a.option_strings}


def test_the_port_cli_takes_every_jax_option(monkeypatch):
    """Every option string of the JAX CLI, each of its choices and its
    default; the port's own options are PORT_ONLY_OPTIONS alone."""
    jax_opts = _parser_of(j_cli.main, monkeypatch)
    mine = _parser_of(cli.main, monkeypatch)
    assert {"--wn-tile", "--line-tile", "--engine"} <= set(jax_opts)
    missing = sorted(set(jax_opts) - set(mine))
    assert not missing, f"the port's CLI lacks {missing}"
    assert set(mine) - set(jax_opts) - {"-h", "--help"} == PORT_ONLY_OPTIONS
    for opt, a in jax_opts.items():
        b = mine[opt]
        assert a.dest == b.dest, opt
        if a.choices is not None:
            lost = sorted(set(a.choices) - set(b.choices))
            assert not lost, f"{opt} lacks the JAX choices {lost}"
        want = a.default
        if isinstance(want, str) and b.type is not None:
            want = b.type(want)     # argparse types a string default
        assert b.default == want, opt


def test_the_port_run_takes_every_jax_keyword():
    """Every parameter of the JAX run(), with its default (dtype by
    name); the port's own keywords are PORT_ONLY_KEYWORDS alone."""
    theirs = inspect.signature(j_run).parameters
    mine = inspect.signature(run).parameters
    missing = sorted(set(theirs) - set(mine))
    assert not missing, f"the port's run() lacks {missing}"
    assert set(mine) - set(theirs) == PORT_ONLY_KEYWORDS
    for k, p in theirs.items():
        d = mine[k].default
        if k == "dtype":
            assert np.dtype(p.default).name == str(d).split(".")[-1]
        else:
            assert d == p.default, k
    assert (mine["wn_tile"].default, mine["line_tile"].default) == \
        (DENSE_WN_TILE, DENSE_LINE_TILE) == (128, 4096)
