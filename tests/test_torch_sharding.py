"""The port's (prof, wn[, line]) mesh against its single-device run and
against the JAX package's mesh functions on the 8-device virtual CPU mesh
(conftest).

The port's ranks are gloo processes on the CPU, each running this file
as `__main__` (so no rank ever imports jax): one launch per mesh computes
`shard_forward`'s Tb and `shard_forward_and_grad`'s loss and gradients
through the engine split (the model's hybrid: both kernel engines), and
the line OD of the kernel engines ("full", "lorentz") and of the float64
dense engine, gathered on rank 0 (and checks that `host_local_batch` /
`make_global_state` give `shard_state`'s block and `global_mesh` the
mesh's shape).  Held:

- the mesh shapes of `make_mesh` and `pipeline._auto_mesh` to the JAX
  functions', exactly; the mesh-padded kernel plans to the JAX
  `ODModel(mesh=)` plans, exactly;
- each mesh's line OD to the single-device run's, bitwise (every rank
  sweeps its own tiles of the same plan); on a line axis at rtol 2e-5,
  atol 1e-11 (the JAX package's tolerance, tests/test_pipeline_mesh.py:
  153-157);
- Tb to the JAX `shard_forward` at rtol 5e-6, atol 5e-6
  (tests/test_sharding.py:53) and to the single-device run at rtol 1e-6;
- the kernel engine's (prof, wn) line OD to the JAX XLA engine's on its
  mesh at rtol 2e-5, atol 1e-11; the float64 dense engine's at rtol 5e-7
  (tests/test_pipeline_mesh.py:125); a line axis's at rtol 2e-5;
- the gradients to the single-device ones at rtol 1e-5, atol 1e-6 x max
  (the sum over wn ranks reorders float32 sums), and to central
  differences of the JAX forward at rtol 2e-2 (tests/test_sharding.py:
  92-119).
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

# the model and state (tests/test_sharding.py's, on a 200-point grid so
# that the port's 128-wavenumber tiles split over two wn ranks)
NWN, NLAY, BATCH, IRT = 200, 8, 4, 3
WN = 0.3 + 0.05 * np.arange(NWN)
CATALOG = dict(n_h2o=16, n_o2=8, tile=64)
MESHES = ("1x1", "1x2", "2x1", "2x2", "1x1x2", "2x1x2")


def _inputs(torch):
    """The port's model inputs: catalog, state, tsfc, emis, refl."""
    from monortm_tpu_torch.testing import (synthetic_catalog_mw,
                                           synthetic_state)
    state = synthetic_state(nlay=NLAY, batch=BATCH, device="cpu",
                            dtype=torch.float32)
    emis = torch.full((NWN,), 0.95)
    return (synthetic_catalog_mw(**CATALOG), state,
            torch.full((BATCH, 1), 288.0), emis, 1.0 - emis)


def _rank_main(mesh_arg: str, out: str):
    """One rank of `mesh_arg`: every result gathered, saved by rank 0."""
    import torch

    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.models.od import ODModel
    from monortm_tpu_torch.parallel import distributed
    from monortm_tpu_torch.parallel.sharding import (make_mesh, shard_batch,
                                                     shard_forward,
                                                     shard_forward_and_grad,
                                                     shard_state)
    from monortm_tpu_torch.types import FIELDS

    torch.set_num_threads(2)
    dims = [int(v) for v in mesh_arg.split("x")] + [1]
    distributed.init_distributed("gloo")
    mesh = make_mesh(n_prof=dims[0], n_wn=dims[1], n_line=dims[2])
    cat, state, tsfc, emis, refl = _inputs(torch)
    model = MonoRTM(WN, 0.05, cat, nmol=22, device="cpu", line_tile=128,
                    mesh=mesh)
    od = model.od_model
    st, ts = shard_state(state, mesh), shard_batch(tsfc, mesh)
    # the multi-controller helpers give the same block and shape
    start, count = distributed.host_local_batch(BATCH, mesh)
    host = SimpleNamespace(**{f: getattr(state, f)[start:start + count]
                              .numpy() for f in FIELDS})
    local = distributed.make_global_state(host, BATCH, mesh, "cpu",
                                          torch.float32)
    assert all(torch.equal(getattr(local, f), getattr(st, f))
               for f in FIELDS)
    if dims[2] == 1:
        assert distributed.global_mesh(n_wn=dims[1]).shape == mesh.shape
    split = model.engine_split(st)
    res = {}
    with torch.no_grad():
        tb = shard_forward(model, mesh, IRT, *split)(st, ts, emis, refl,
                                                     gather=True)
    res["tb"] = tb
    obs = shard_batch(tb + 0.5, mesh)
    loss, grads = shard_forward_and_grad(model, mesh, IRT, *split)(
        st, ts, emis, refl, obs)
    res["loss"] = loss
    res.update({f"grad_{f}": distributed.gather(getattr(grads, f), mesh)
                for f in FIELDS})
    sc = torch.ones(st.p.shape + (351,))
    with torch.no_grad():
        for engine in ("full", "lorentz"):
            res[f"lod_{engine}"] = distributed.gather(
                od.line_od(st, sc, engine=engine), mesh, 2, od.wn_sizes)
        od64 = ODModel(WN, 0.05, cat, nmol=22, device="cpu",
                       dtype=torch.float64, mesh=mesh)
        st64 = shard_state(state.to("cpu", torch.float64), mesh)
        res["lod_dense64"] = distributed.gather(
            od64.line_od(st64, sc.double()), mesh, 2, od64.wn_sizes)
    if mesh.rank == 0:
        np.savez(out, **{k: v.detach().numpy() for k, v in res.items()})
    if mesh.size() > 1:
        torch.distributed.destroy_process_group()


def _launch(mesh: str, out: Path):
    """Run `mesh`'s ranks (one plain process for 1x1); raises with the
    ranks' output when one fails."""
    from monortm_tpu_torch.parallel.distributed import spawn
    n = int(np.prod([int(v) for v in mesh.split("x")]))
    argv = ["-m", "tests.test_torch_sharding", mesh, str(out)]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    if n == 1:
        res = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        outs = [(res.returncode, res.stdout + res.stderr)]
    else:
        outs = spawn(argv, n, env=env, cwd=ROOT, timeout=300)
    for r, (rc, text) in enumerate(outs):
        assert rc == 0, f"rank {r} of {mesh}:\n{text[-4000:]}"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    return {m: _launch(m, d / f"{m}.npz") for m in MESHES}


# ---- the JAX side, on the 8-device virtual CPU mesh --------------------

@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from monortm_tpu.models.monortm import MonoRTM as JMonoRTM
    from monortm_tpu.models.od import ODModel as JODModel
    from monortm_tpu.parallel.sharding import (make_mesh, shard_forward,
                                               shard_state)
    from monortm_tpu.testing import synthetic_catalog_mw, synthetic_state

    devs = jax.devices("cpu")[:8]
    cat = synthetic_catalog_mw(**CATALOG)
    state = synthetic_state(nlay=NLAY, batch=BATCH)
    state32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                     state)
    emis = jnp.full((NWN,), 0.95, jnp.float32)
    tsfc = jnp.full((BATCH, 1), 288.0, jnp.float32)
    model = JMonoRTM(WN, dvset=0.05, catalog=cat, nmol=22,
                     dtype=jnp.float32, wn_tile=8, line_tile=64,
                     use_pallas=False)
    mesh = make_mesh(n_prof=2, n_wn=4, devices=devs)
    with mesh:
        tb = shard_forward(model, mesh, irt=IRT)(
            shard_state(state32, mesh), tsfc, emis, 1.0 - emis)

    def sharded(x, m):
        return jax.device_put(x, NamedSharding(
            m, P("prof", *(None,) * (x.ndim - 1))))

    def line_od(dtype, m, **kw):
        od = JODModel(WN, 0.05, cat, nmol=22, dtype=dtype, use_pallas=False,
                      mesh=m, **kw)
        st = jax.tree_util.tree_map(
            lambda x: sharded(jnp.asarray(x, dtype), m), state)
        sc = sharded(jnp.ones((BATCH, NLAY, 351), dtype), m)
        return np.asarray(jax.jit(od.line_od)(st, sc))

    def tb_at(t):
        import dataclasses
        s = dataclasses.replace(state32, t=jnp.asarray(t, jnp.float32))
        return np.asarray(jax.jit(lambda s_: model.tb(
            s_, tsfc, emis, 1.0 - emis, IRT))(s))

    return {
        "tb": np.asarray(tb), "tb_at": tb_at,
        "t": np.asarray(state.t, np.float64),
        "lod32": line_od(jnp.float32, mesh, wn_tile=16, line_tile=64),
        "lod64": line_od(jnp.float64, mesh),
        "lod_line": line_od(jnp.float32,
                            make_mesh(n_prof=2, n_wn=2, n_line=2,
                                      devices=devs),
                            wn_tile=16, line_tile=64),
    }


# ---- shapes and plans ---------------------------------------------------

@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(n_prof=2)), (8, dict(n_wn=4)),
    (8, dict(n_prof=2, n_wn=4)), (8, dict(n_prof=2, n_wn=2, n_line=2)),
    (4, dict(n_line=2)), (1, {}), (6, dict(n_prof=3)),
])
def test_mesh_shape_matches_jax(n, kw):
    import jax
    from monortm_tpu.parallel.sharding import make_mesh as j_make_mesh
    from monortm_tpu_torch.parallel.sharding import mesh_shape

    want = dict(j_make_mesh(devices=jax.devices("cpu")[:n], **kw).shape)
    assert mesh_shape(n, **kw) == want


@pytest.mark.parametrize("n,kw", [(8, dict(n_prof=3)), (4, dict(n_wn=3)),
                                  (8, dict(n_prof=2, n_wn=2))])
def test_mesh_shape_refuses_what_jax_refuses(n, kw):
    import jax
    from monortm_tpu.parallel.sharding import make_mesh as j_make_mesh
    from monortm_tpu_torch.parallel.sharding import mesh_shape

    with pytest.raises(AssertionError):
        j_make_mesh(devices=jax.devices("cpu")[:n], **kw)
    with pytest.raises(ValueError):
        mesh_shape(n, **kw)


@pytest.mark.parametrize("n,nprof", [(8, 3), (8, 1), (8, 64), (6, 4),
                                     (4, 2), (1, 5)])
def test_auto_mesh_matches_jax(n, nprof, monkeypatch):
    import jax
    import monortm_tpu.pipeline as jp
    from monortm_tpu_torch.pipeline import _auto_mesh_shape

    devs = jax.devices("cpu")[:n]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    want = jp._auto_mesh(nprof)
    got = _auto_mesh_shape(n, nprof)
    assert (None if want is None else dict(want.shape)) == got


@pytest.mark.parametrize("n_prof,n_wn,n_line", [(2, 4, 1), (1, 8, 1),
                                                (2, 2, 2)])
def test_mesh_plans_match_jax(n_prof, n_wn, n_line):
    """The port's mesh-padded plans are the JAX ODModel(mesh=)'s."""
    import jax
    import torch
    from monortm_tpu.models.od import ODModel as JODModel
    from monortm_tpu.parallel.sharding import make_mesh as j_make_mesh
    from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
    from monortm_tpu_torch.models.od import build_plan
    from monortm_tpu_torch.ops.lineshape import catalog_to_host
    from monortm_tpu_torch.testing import synthetic_catalog_mw

    wn = np.linspace(0.3, 55.0, 700)
    mesh = j_make_mesh(n_prof=n_prof, n_wn=n_wn, n_line=n_line,
                       devices=jax.devices("cpu")[:8])
    jm = JODModel(wn, 0.05, j_catalog(n_h2o=300, n_o2=40, tile=128),
                  nmol=22, use_pallas=True, pallas_line_tile=256,
                  pallas_wn_tile=128, mesh=mesh)
    cat = synthetic_catalog_mw(n_h2o=300, n_o2=40, tile=128)
    for (nt, wt), jplan in (((256, 128), {k: getattr(jm, "pallas_" + k)
                                           for k in ("cand_map",
                                                     "cand_valid",
                                                     "wn_hi", "wn_lo")}),
                            ((128, 128), jm._plan_lorentz)):
        plan = build_plan(cat, catalog_to_host(cat, torch.float32), wn,
                          nt=nt, wt=wt, n_wn=n_wn, n_line=n_line)
        for k in ("cand_map", "cand_valid", "wn_hi", "wn_lo"):
            np.testing.assert_array_equal(plan[k], np.asarray(jplan[k]),
                                          err_msg=k)


# ---- the mesh runs -------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES[1:])
def test_mesh_line_od_matches_single_device(runs, mesh):
    one, got = runs["1x1"], runs[mesh]
    for k in ("lod_full", "lod_lorentz", "lod_dense64"):
        assert got[k].shape == one[k].shape, k
        if mesh.count("x") == 2:          # a line axis
            np.testing.assert_allclose(got[k], one[k], rtol=2e-5,
                                       atol=1e-11, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    np.testing.assert_allclose(got["tb"], one["tb"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_forward_matches_jax(runs, jax_side, mesh):
    tb = runs[mesh]["tb"]
    assert tb.shape == (BATCH, NWN)
    np.testing.assert_allclose(tb, jax_side["tb"], rtol=5e-6, atol=5e-6)


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
def test_prof_wn_line_od_matches_jax(runs, jax_side, mesh):
    got = runs[mesh]
    np.testing.assert_allclose(got["lod_full"], jax_side["lod32"],
                               rtol=2e-5, atol=1e-11)
    np.testing.assert_allclose(got["lod_dense64"], jax_side["lod64"],
                               rtol=5e-7, atol=0)


@pytest.mark.parametrize("mesh", ["1x1x2", "2x1x2"])
def test_line_axis_line_od_matches_jax(runs, jax_side, mesh):
    np.testing.assert_allclose(runs[mesh]["lod_full"], jax_side["lod_line"],
                               rtol=2e-5, atol=1e-11)


@pytest.mark.parametrize("mesh", MESHES[1:])
def test_mesh_grads_match_single_device(runs, mesh):
    one, got = runs["1x1"], runs[mesh]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    for f in ("p", "t", "tz", "wkl", "wbrodl", "clw"):
        g, ref = got[f"grad_{f}"], one[f"grad_{f}"]
        assert g.shape == ref.shape and np.isfinite(g).all(), f
        np.testing.assert_allclose(g, ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=f)
    assert np.abs(got["grad_t"]).max() > 0.0


@pytest.mark.parametrize("mesh", ["2x2", "2x1x2"])
def test_mesh_grad_matches_finite_difference(runs, jax_side, mesh):
    """tests/test_sharding.py:92-119 on the port's mesh gradient."""
    got = runs[mesh]
    obs = got["tb"] + 0.5
    t0 = jax_side["t"]
    eps, (i, j) = 1e-2, (1, 3)
    loss = []
    for d in (eps, -eps):
        t = t0.copy()
        t[i, j] += d
        tb = jax_side["tb_at"](t).astype(np.float64)
        loss.append(float(np.mean((tb - obs) ** 2)))
    fd = (loss[0] - loss[1]) / (2 * eps)
    assert np.isclose(fd, got["grad_t"][i, j], rtol=2e-2, atol=1e-8), \
        (fd, got["grad_t"][i, j])


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3])
