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
on 1x2 the bytes of the float64 single-device run; the dense engine at
--wn-tile 64 (float64, and float32 --engine xla) on 1x2 the bytes of its
single-device run, a hybrid run with that flag the default-tile hybrid
bytes, and a kernel model's dense call split otherwise raises; "auto" on
two ranks the bytes of one; a mesh whose size is not the world's raises;
a rank that fails stops the others.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from monortm_tpu_torch.parallel.distributed import spawn
from monortm_tpu_torch.testing import make_minimal_rundir, make_wide_rundir

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


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
    d = make_wide_rundir(tmp_path_factory.mktemp("wide"))
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


@pytest.mark.parametrize("extra", [("--precision", "float64"),
                                   ("--engine", "xla")],
                         ids=["float64", "float32-xla"])
def test_dense_tile_mesh_cli(wide, extra):
    """--wn-tile 64 on 1x2: a dense-only run splits the grid by its own
    tile, [0, 192) | [192, 300) (the kernels' 128 would give [0, 256) |
    [256, 300)), and writes the single-device bytes at the same tiles."""
    tag = extra[-1]
    _single(wide, f"single64t_{tag}", *extra, "--wn-tile", "64")
    _ranks(wide, f"mesh64t_{tag}", 2, "1x2", *extra, "--wn-tile", "64")
    assert _bytes(wide, f"mesh64t_{tag}") == _bytes(wide, f"single64t_{tag}")


def test_hybrid_mesh_cli_takes_no_dense_tile(wide):
    """A float32 hybrid run never enters the dense engine: --wn-tile 64 on
    1x2 writes the bytes of the default-tile 1x2 hybrid run."""
    _ranks(wide, "hybrid", 2, "1x2", "--engine", "hybrid")
    _ranks(wide, "hybrid64t", 2, "1x2", "--engine", "hybrid",
           "--wn-tile", "64")
    assert _bytes(wide, "hybrid64t") == _bytes(wide, "hybrid")


def test_dense_call_on_a_kernel_model_split_otherwise_raises():
    """On rank 0 of a 1x2 mesh over 300 wavenumbers a kernel model built
    with dense_wn_tile=64 takes the kernels' columns [0, 256), and its
    dense engine raises naming both tiles; a dense-only model takes the
    dense tile's [0, 192).  (A stand-in for the mesh: neither model
    reaches a collective before the check.)"""
    from types import SimpleNamespace

    import torch

    from monortm_tpu_torch.models.od import ODModel
    from monortm_tpu_torch.testing import (synthetic_catalog_mw,
                                           synthetic_state)
    mesh = SimpleNamespace(shape={"prof": 1, "wn": 2},
                           coords={"prof": 0, "wn": 0}, size=lambda: 2)
    wn = np.linspace(0.3, 8.7, 300)
    kw = dict(nmol=22, device="cpu", dense_wn_tile=64, mesh=mesh)
    both = ODModel(wn, 0.03, synthetic_catalog_mw(), **kw)
    alone = ODModel(wn, 0.03, synthetic_catalog_mw(), kernels=False, **kw)
    assert both.wn_cols == (0, 256) and alone.wn_cols == (0, 192)
    st = synthetic_state(nlay=3, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match=r"tile 64 .* tiles \[128\].*"
                                         r"kernels=False.*dense_wn_tile=128"):
        both(st, engine="dense")
    assert both._dense is None


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
