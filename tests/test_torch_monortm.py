"""The port's forward pass against the JAX package's, end to end.

`MonoRTM.forward` in float32 against JAX `MonoRTM(use_pallas=True)` (the
Pallas kernel in interpret mode on CPU) under the same hybrid engine
split: od_total at the line-sum tolerance (rtol=2e-5, atol=2e-6*max) and
brightness temperatures at atol=2e-3 K.  The RT solver is also held to
the JAX one in float64 at rtol=1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.models import rt as jrt
from monortm_tpu.models.monortm import MonoRTM as JMonoRTM
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu.testing import synthetic_state as j_state
from monortm_tpu.types import LayerState as JLayerState
from monortm_tpu_torch.convert import state_from_numpy
from monortm_tpu_torch.models import rt
from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.testing import synthetic_catalog_mw, synthetic_state

torch.set_num_threads(1)

WN = np.linspace(0.3, 55.0, 96)
NLAY = 6


def _host_state():
    """Six layers, 1000 -> 50 hPa, two profiles: the top layers fail the
    zeta > 0.99 test, so the hybrid split is genuinely mixed."""
    st = j_state(nlay=NLAY, batch=2)
    p = np.broadcast_to(np.geomspace(1000.0, 50.0, NLAY), (2, NLAY))
    return JLayerState(p=np.asarray(p, np.float32),
                       **{f: np.asarray(getattr(st, f), np.float32)
                          for f in ("t", "tz", "wkl", "wbrodl", "clw")})


def _models():
    """Each package with its own (identical) catalog."""
    kw = dict(dvset=float(WN[1] - WN[0]), nmol=22)
    return (JMonoRTM(WN, catalog=j_catalog(n_h2o=120, n_o2=24, tile=128),
                     dtype=jnp.float32, use_pallas=True, **kw),
            MonoRTM(WN, catalog=synthetic_catalog_mw(n_h2o=120, n_o2=24,
                                                     tile=128),
                    device="cpu", **kw))


@functools.lru_cache(maxsize=None)
def _forwards(irt):
    jm, pm = _models()
    host = _host_state()
    state = state_from_numpy(host, "cpu", torch.float32)

    rows = np.asarray(jm.od_model.all_lorentz(host, per_layer=True)
                      ).all(axis=0)
    lor = tuple(np.nonzero(rows)[0].tolist())
    engine, lor_layers = pm.engine_split(state)

    emis = np.full(len(WN), 0.95, np.float32)
    tsfc = np.full((2, 1), 288.0, np.float32)
    jfwd = jax.jit(lambda s: jm.forward(
        s, jnp.asarray(tsfc), jnp.asarray(emis), jnp.asarray(1.0 - emis),
        irt=irt, engine="hybrid", lor_layers=lor))
    want = jfwd(jax.tree_util.tree_map(jnp.asarray, host))
    got = pm.forward(state, torch.from_numpy(tsfc), torch.from_numpy(emis),
                     torch.from_numpy(1.0 - emis), irt=irt, engine=engine,
                     lor_layers=lor_layers)
    return want, got, (engine, lor_layers), lor


def test_engine_split_matches_jax():
    _, _, (engine, lor_layers), lor = _forwards(3)
    assert engine == "hybrid"
    assert lor_layers == lor and 0 < len(lor) < NLAY


@pytest.mark.parametrize("irt", [3, 1])
def test_forward_matches_jax(irt):
    want, got, _, _ = _forwards(irt)
    w_od = np.asarray(want.od.od_total)
    g_od = got.od.od_total.numpy()
    assert g_od.shape == w_od.shape == (2, len(WN), NLAY)
    scale = float(np.abs(w_od).max())
    np.testing.assert_allclose(g_od, w_od, rtol=2e-5, atol=2e-6 * scale)
    w_mol = np.asarray(want.od.od_by_mol)
    np.testing.assert_allclose(got.od.od_by_mol.numpy(), w_mol, rtol=2e-5,
                               atol=2e-6 * float(np.abs(w_mol).max()))
    tb = got.rt.tb.numpy()
    assert np.isfinite(tb).all() and tb.shape == (2, len(WN))
    np.testing.assert_allclose(tb, np.asarray(want.rt.tb), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("irt", [1, 2, 3])
def test_rt_matches_jax_f64(irt):
    rng = np.random.default_rng(irt)
    od = rng.uniform(0.0, 0.5, (2, 40, 7))
    t = rng.uniform(200.0, 300.0, (2, 1, 7))
    tz = rng.uniform(200.0, 300.0, (2, 1, 8))
    wn = np.linspace(0.3, 55.0, 40)
    emis = rng.uniform(0.5, 1.0, 40)
    tsfc = np.full((2, 1), 290.0)
    want = jrt.rtm(od, t, tz, wn, tsfc, emis, 1.0 - emis, irt)
    t_ = lambda a: torch.from_numpy(np.array(a))
    got = rt.rtm(t_(od), t_(t), t_(tz), t_(wn), t_(tsfc), t_(emis),
                 t_(1.0 - emis), irt)
    for f in rt.RTResult._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-12,
                                   err_msg=f)
    # the layer-recurrence half alone, and the standalone TMR
    want_parts = jrt.rt_parts(od, t, tz, wn)
    got_parts = rt.rt_parts(t_(od), t_(t), t_(tz), t_(wn))
    for f in rt.RTParts._fields:
        np.testing.assert_allclose(getattr(got_parts, f).numpy(),
                                   np.asarray(getattr(want_parts, f)),
                                   rtol=1e-12, err_msg=f)
    np.testing.assert_allclose(rt.calctmr(t_(od), t_(t), t_(tz), t_(wn)),
                               np.asarray(jrt.calctmr(od, t, tz, wn)),
                               rtol=1e-12)


def test_synthetic_fixtures_identical():
    """The port's fixtures draw the same numbers as the JAX package's."""
    a, b = synthetic_catalog_mw(n_h2o=40, n_o2=12), j_catalog(n_h2o=40,
                                                              n_o2=12)
    for f in ("nu0", "nu0_hi", "nu0_lo", "s0adj", "mol", "xg", "a1", "sdep",
              "valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for batch in (None, 3):
        mine = synthetic_state(nlay=5, batch=batch, seed=2, device="cpu")
        ref = j_state(nlay=5, batch=batch, seed=2)
        for f in ("p", "t", "tz", "wkl", "wbrodl", "clw"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          np.asarray(getattr(ref, f)))


def test_float64_model_not_ported():
    """A float64 model was once refused; now it is built, takes the dense
    engine by default, and refuses a float32 kernel engine, naming the
    dtype (tests/test_torch_dense.py holds its values)."""
    m = MonoRTM(WN, 0.5, synthetic_catalog_mw(n_h2o=8, n_o2=4), nmol=22,
                device="cpu", dtype=torch.float64)
    assert m.od_model.default_engine == "dense"
    st = synthetic_state(nlay=3, device="cpu")
    assert m.od_model(st).od_total.dtype == torch.float64
    with pytest.raises(ValueError, match="float64"):
        m.forward(st, 288.0, torch.ones(len(WN), dtype=torch.float64),
                  torch.zeros(len(WN), dtype=torch.float64), irt=3,
                  engine="full")
