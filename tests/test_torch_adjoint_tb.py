"""The retrieval adjoint end to end: d(sum Tb)/dT through the port.

The case of tests/test_pallas.py:287-341: 32 wavenumbers over 0.3-55
cm^-1, 4 layers with p geomspace(1000, 20) hPa (the top layers
SD-Voigt-active), catalog n_h2o=24 / n_o2=12, line and wavenumber tiles
128/128, irt=3.

- (c) the gradient of sum(tb) by the layer temperatures through the
  port's `MonoRTM.tb` (TIPS, the LINES prologue, the line sum and its
  plain adjoint on the CPU, RFT * W, continuum, cloud and RT), engines
  "full" and "hybrid", against `jax.grad` of the JAX `MonoRTM.tb` with
  the Pallas kernel (interpret mode) and its custom VJP; engine "lorentz"
  against the JAX all-Lorentz engine on the same state.  Tolerance
  rtol=1e-4, atol=1e-6: ten times tighter than test_pallas.py's rtol=5e-3,
  atol=1e-4 (the ports agree to ~3e-5 relative: float32 adjoints summed
  in other orders).
- (d) central differences through the port's own forward at eps=4 K, as
  test_pallas.py:328-341 does (rtol=5e-2, atol=3e-4: the float32 loss,
  ~1.6e4, carries ~1e-3 of noise).
- every float field of the state gets a finite gradient.
"""

import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.models.monortm import MonoRTM as JMonoRTM
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu.testing import synthetic_state as j_state
from monortm_tpu.types import LayerState as JLayerState
from monortm_tpu_torch.convert import state_from_numpy
from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.testing import synthetic_catalog_mw
from monortm_tpu_torch.types import FIELDS

torch.set_num_threads(1)

WN = np.linspace(0.3, 55.0, 32)
EMIS = np.full(len(WN), 0.95, np.float32)


@functools.lru_cache(maxsize=None)
def _setup():
    jm = JMonoRTM(WN, 0.25, j_catalog(n_h2o=24, n_o2=12, tile=64), nmol=22,
                  dtype=jnp.float32, wn_tile=32, line_tile=64,
                  use_pallas=True, pallas_wn_tile=128, pallas_line_tile=128)
    pm = MonoRTM(WN, 0.25, synthetic_catalog_mw(n_h2o=24, n_o2=12, tile=64),
                 nmol=22, device="cpu", wn_tile=128, line_tile=128)
    st = j_state(nlay=4)
    host = JLayerState(p=np.float32(np.geomspace(1000.0, 20.0, 4)), **{
        f: np.asarray(getattr(st, f), np.float32)
        for f in ("t", "tz", "wkl", "wbrodl", "clw")})
    rows = np.asarray(jm.od_model.all_lorentz(host, per_layer=True))
    assert rows.any() and not rows.all()      # genuinely mixed
    return jm, pm, host, tuple(np.nonzero(rows)[0].tolist())


def _port_loss(pm, host, engine, lor=None, t=None):
    state = state_from_numpy(host, "cpu", torch.float32)
    if t is not None:
        state = dc.replace(state, t=t)
    tb = pm.tb(state, 288.0, torch.from_numpy(EMIS),
               torch.from_numpy(1.0 - EMIS), irt=3, engine=engine,
               lor_layers=lor)
    return tb.sum()


@functools.lru_cache(maxsize=None)
def _jax_grad(engine):
    jm, _, host, lor = _setup()
    jstate = jax.tree_util.tree_map(jnp.asarray, host)

    def loss(t):
        return jnp.sum(jm.tb(dc.replace(jstate, t=t), jnp.float32(288.0),
                             jnp.asarray(EMIS), jnp.asarray(1.0 - EMIS),
                             irt=3, engine=engine))

    return np.asarray(jax.jit(jax.grad(loss))(jstate.t))


def _port_grad(engine):
    _, pm, host, lor = _setup()
    t = torch.from_numpy(host.t.copy()).requires_grad_()
    _port_loss(pm, host, engine, lor if engine == "hybrid" else None,
               t).backward()
    return t.grad.numpy()


@pytest.mark.parametrize("engine,j_engine", [("full", "pallas"),
                                             ("hybrid", "pallas"),
                                             ("lorentz", "lorentz-xla")])
def test_tb_gradient_matches_jax(engine, j_engine):
    want = _jax_grad(j_engine)
    got = _port_grad(engine)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_tb_gradient_central_differences():
    _, pm, host, _ = _setup()
    g = _port_grad("full")
    t0 = host.t.copy()
    with torch.no_grad():
        f = lambda t: float(_port_loss(pm, host, "full",
                                       t=torch.from_numpy(t)))
        for il in (int(np.argmax(np.abs(g))), 3):
            eps = 4.0
            tp, tm = t0.copy(), t0.copy()
            tp[il] += eps
            tm[il] -= eps
            fd = (f(tp) - f(tm)) / (2 * eps)
            np.testing.assert_allclose(g[il], fd, rtol=5e-2, atol=3e-4)


def test_every_state_field_gets_a_gradient():
    _, pm, host, lor = _setup()
    state = state_from_numpy(host, "cpu", torch.float32)
    for f in FIELDS:
        getattr(state, f).requires_grad_()
    tb = pm.tb(state, 288.0, torch.from_numpy(EMIS),
               torch.from_numpy(1.0 - EMIS), irt=3, engine="hybrid",
               lor_layers=lor)
    tb.sum().backward()
    for f in FIELDS:
        g = getattr(state, f).grad
        assert g is not None and bool(torch.isfinite(g).all()), f
        assert float(g.abs().max()) > 0.0, f
