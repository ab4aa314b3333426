"""The port's line-sum adjoint against the JAX package's, on the CPU.

- (a) `reverse_map` equals `linesum_pallas._reverse_map` on random packed
  candidate maps, and is the exact transpose of the map;
- (b) the gradient of sum(line OD * seeded weights) by p, t, wkl and
  wbrodl through the port's `ODModel.line_od` (its CPU backward is the
  plain adjoint, `line_sum_bwd_plain` / `lorentz_sum_bwd_plain`) against
  `jax.grad` of the JAX `ODModel.line_od_pallas`: engine "full" against
  the Pallas kernel's custom VJP (`_bwd_kernel`, interpret mode) and
  engine "lorentz" against the autodiff of the all-Lorentz XLA engine, at
  1013, 20 and 0.02 hPa.

Tolerance: rtol=1e-3, atol=1e-5 * max|ref| per field.  Both sides are
float32 reverse-mode adjoints of the same float32 forward, differing in
summation order and in the libraries' exp/cos/sin; rtol=1e-3 covers the
ill-conditioning of the Voigt partials by the Doppler width (two float32
adjoints of the Voigt sum differ by up to 3e-3 * max in d/daD at 20 hPa,
chip_smoke.py phase 5; it enters d/dt through aD ~ sqrt(T) only).  Near vacuum the JAX adjoint is NaN wherever a speed-dependent
lane has delta > 1e6 (its two-point construction is evaluated unselected
and 0 * NaN poisons the select's vjp); the port evaluates it at delta = 0
there.  So the 0.02 hPa case runs with the speed dependence off, as
tests/test_torch_linesum.py does for the forward.

The total column: JAX's float32 vjp of rho = rhorat * w_line / wtot
squares wtot (~1e23 molec/cm^2), which overflows, so its gradients drop
the path through wtot: d/dwbrodl, which runs through wtot only, comes out
0, and d/dwkl misses a term that is small beside the direct one.
PyTorch divides twice and keeps it.  So d/dwkl is held to JAX at
atol=1e-3 * max, and d/dwbrodl to central differences of the port's own
forward instead.
"""

import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.models.od import ODModel as JODModel
from monortm_tpu.ops.linesum_pallas import _reverse_map
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu.testing import synthetic_state as j_state
from monortm_tpu.types import LayerState as JLayerState
from monortm_tpu_torch.convert import state_from_numpy
from monortm_tpu_torch.models.od import ODModel
from monortm_tpu_torch.ops.linesum import reverse_map
from monortm_tpu_torch.ops.tips import tips_scor
from monortm_tpu_torch.testing import synthetic_catalog_mw

torch.set_num_threads(1)

WN = np.linspace(0.4, 50.0, 64)
GRAD_FIELDS = ("p", "t", "wkl")
ATOL = {"p": 1e-5, "t": 1e-5, "wkl": 1e-3}       # * max|ref|, see above


@pytest.mark.parametrize("seed", [3, 4])
def test_reverse_map_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_wt, n_cand, k_tiles = 11, 5, 9
    cm = rng.integers(0, k_tiles, (n_wt, n_cand)).astype(np.int32)
    cv = rng.random((n_wt, n_cand)) < 0.6
    order = np.argsort(~cv, axis=1, kind="stable")     # valid slots left
    cm = np.take_along_axis(cm, order, axis=1)
    cv = np.take_along_axis(cv, order, axis=1).astype(np.int32)
    rm, rv = reverse_map(cm, cv, k_tiles)
    jrm, jrv = _reverse_map(cm, cv, k_tiles)
    np.testing.assert_array_equal(rm, jrm)
    np.testing.assert_array_equal(rv, jrv)
    assert rm.dtype == rv.dtype == np.int32
    # the transpose, with multiplicity
    pairs = sorted((int(cm[i, j]), i) for i in range(n_wt)
                   for j in range(n_cand) if cv[i, j])
    assert pairs == sorted((k, int(rm[k, s])) for k in range(k_tiles)
                           for s in range(rm.shape[1]) if rv[k, s])


def test_plan_carries_the_reverse_map():
    cat = synthetic_catalog_mw(n_h2o=150, n_o2=24, tile=128)
    m = ODModel(WN, float(WN[1] - WN[0]), cat, nmol=22, device="cpu")
    for plan, dev in ((m.plan, m.dev_plans["full"]),
                      (m.plan_lorentz, m.dev_plans["lorentz"])):
        k_tiles = len(plan["cat"]["mol"]) // plan["nt"]
        rm, rv = _reverse_map(plan["cand_map"], plan["cand_valid"], k_tiles)
        np.testing.assert_array_equal(plan["rev_map"], rm)
        np.testing.assert_array_equal(plan["rev_valid"], rv)
        np.testing.assert_array_equal(dev["rev"][0].numpy(), rm)
        np.testing.assert_array_equal(dev["rev"][1].numpy(), rv)


# (engine, speed dependence on?, pressures of the profiles in hPa)
GROUPS = {
    "full": ("full", True, (1013.0, 20.0)),
    "full_vacuum": ("full", False, (0.02,)),
    "lorentz": ("lorentz", True, (1013.0, 20.0, 0.02)),
}


def _catalog(make, sd_on):
    cat = make(n_h2o=150, n_o2=24, tile=128)
    if not sd_on:
        cat.sdep[:] = 0.0
    return cat


@functools.lru_cache(maxsize=None)
def _grads(group):
    """(port, JAX) gradients of sum(line OD * w) by GRAD_FIELDS, as numpy,
    for profiles of 3 layers at each of the group's pressures."""
    engine, sd_on, pressures = GROUPS[group]
    nlay = 3
    st = j_state(nlay=nlay, batch=len(pressures))
    p = np.repeat(np.asarray(pressures)[:, None], nlay, axis=1)
    host = JLayerState(p=np.float32(p), **{
        f: np.asarray(getattr(st, f), np.float32)
        for f in ("t", "tz", "wkl", "wbrodl", "clw")})
    scor = tips_scor(torch.from_numpy(host.t), torch.float32)
    scor = scor.reshape(scor.shape[:-2] + (39 * 9,)).numpy()
    w = np.random.default_rng(7).uniform(
        0.5, 1.5, (len(pressures), nlay, len(WN), 22)).astype(np.float32)

    kw = dict(dvset=float(WN[1] - WN[0]), nmol=22)
    jm = JODModel(WN, catalog=_catalog(j_catalog, sd_on), dtype=jnp.float32,
                  use_pallas=True, pallas_wn_tile=128, pallas_line_tile=128,
                  **kw)
    pm = ODModel(WN, catalog=_catalog(synthetic_catalog_mw, sd_on),
                 device="cpu", wn_tile=128, line_tile=128, **kw)

    jstate = jax.tree_util.tree_map(jnp.asarray, host)
    j_engine = "pallas" if engine == "full" else "lorentz-xla"

    def jloss(*fields):
        s = dc.replace(jstate, **dict(zip(GRAD_FIELDS, fields)))
        return jnp.sum(jm.line_od_pallas(s, jnp.asarray(scor),
                                         engine=j_engine) * w)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(GRAD_FIELDS)))))(
        *(getattr(jstate, f) for f in GRAD_FIELDS))

    state = state_from_numpy(host, "cpu", torch.float32)
    for f in GRAD_FIELDS:
        getattr(state, f).requires_grad_()
    od = pm.line_od(state, torch.from_numpy(scor), engine=engine)
    (od * torch.from_numpy(w)).sum().backward()
    got = [getattr(state, f).grad.numpy() for f in GRAD_FIELDS]
    return got, [np.asarray(x) for x in want]


@pytest.mark.parametrize("group", list(GROUPS))
def test_line_od_gradient_matches_jax(group):
    got, want = _grads(group)
    for f, g, ref in zip(GRAD_FIELDS, got, want):
        assert np.isfinite(ref).all() and np.isfinite(g).all(), f
        scale = float(np.abs(ref).max())
        assert scale > 0.0, f
        np.testing.assert_allclose(g, ref, rtol=1e-3, atol=ATOL[f] * scale,
                                   err_msg=f"{group}: d/d{f}")


@pytest.mark.parametrize("engine,p_const", [("lorentz", None),
                                            ("full", 1013.0)])
def test_broadening_gradient_matches_central_differences(engine, p_const):
    """d/dwbrodl of sum(line OD * w), which runs only through the total
    column wtot, against central differences of the port's own forward:
    a 20% step (smaller steps drown in the float32 rounding of the OD),
    the sum accumulated in float64, rtol=2e-2.  The response must be
    smooth over the step, so no lane may switch between the Lorentz and
    SD-Voigt branches: the all-Lorentz engine on 1000-50 hPa, and the
    full one at 1013 hPa, where every lane is Lorentz."""
    cat = synthetic_catalog_mw(n_h2o=150, n_o2=24, tile=128)
    m = ODModel(WN, float(WN[1] - WN[0]), cat, nmol=22, device="cpu",
                wn_tile=128, line_tile=128)
    state = state_from_numpy(j_state(nlay=3), "cpu", torch.float32)
    if p_const is not None:
        state = dc.replace(state, p=torch.full_like(state.p, p_const))
    scor = tips_scor(state.t, torch.float32).reshape(3, 39 * 9)
    w = torch.from_numpy(np.random.default_rng(8).uniform(
        0.5, 1.5, (3, len(WN), 22)))
    od_sum = lambda s: float((m.line_od(s, scor, engine=engine).double()
                              * w).sum())
    wb = state.wbrodl.clone().requires_grad_()
    (m.line_od(dc.replace(state, wbrodl=wb), scor, engine=engine).double()
     * w).sum().backward()
    grad = wb.grad.numpy()
    assert np.isfinite(grad).all() and np.abs(grad).min() > 0.0
    for il in range(3):
        h = 0.2 * float(state.wbrodl[il])
        sp, sm = (dc.replace(state, wbrodl=state.wbrodl.clone())
                  for _ in range(2))
        sp.wbrodl[il] += h
        sm.wbrodl[il] -= h
        fd = (od_sum(sp) - od_sum(sm)) / (2 * h)
        np.testing.assert_allclose(grad[il], fd, rtol=2e-2)
