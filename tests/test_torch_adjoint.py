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

- (c) the plain float32 adjoint `line_sum_bwd_plain` takes an SD-Voigt
  lane's partials in float64 (as the adjoint kernel does): at 0.02 hPa
  with speed dependence on, the SD-Voigt lanes' share of each cotangent
  (the cotangent less that of the Lorentz lanes, which keep their float32
  reverse mode) is within 1.5e-6 * max of the same share of the plain
  adjoint run in float64 (with float32's branch, f32_fallback=True), the
  limit the kernel meets (chip_smoke.py phase 5); the float32 reverse
  mode's share of dshift, dhw and dad is off by more than 1e-3 * max.
  The Lorentz lanes' own float32 reverse mode is off float64 by up to
  2.6e-6 * max in dhw on this state (wing lanes near 25 cm^-1, where the
  shape and its pedestal cancel), as it was: so the whole dhw is not
  within 1.5e-6 * max, since (d) keeps those lanes bitwise.  stild's cotangent is the
  float32 value of the line shape, which near vacuum is itself off
  float64 by ~2.7e-4 * max here (the forward's documented looser case), so it
  is held bitwise to the float32 reverse mode, and within 1e-3 * max of
  float64 (the forward's limit there, tests/test_torch_linesum.py);
- (d) where a lane is Lorentz nothing changes: every cotangent at 1013
  hPa (every lane Lorentz), and stild, k3v, ya and yb at 20 and 0.02 hPa,
  are bitwise the float32 reverse mode's.
"""

import dataclasses as dc
import functools
from unittest import mock

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
from monortm_tpu_torch.ops import linesum
from monortm_tpu_torch.ops.linesum import (PER_LN, _contrib_voigt,
                                           line_sum_bwd_plain, precompute,
                                           reverse_map, sweep_bwd_plain)
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


@functools.lru_cache(maxsize=None)
def _plain_adjoints(p_hpa):
    """The seven cotangents, each a dict, for 3 layers at p_hpa with speed
    dependence on and a seeded cotangent: "new", the float32 plain
    adjoint; "ref", its float64 reference; "old", the float32 reverse mode
    without float64 partials; "lor32" / "lor64", the float32 reverse mode
    and its float64 reference with the SD-Voigt shape's own partials cut
    (the Lorentz lanes' share, and the operands')."""
    m = ODModel(WN, float(WN[1] - WN[0]),
                synthetic_catalog_mw(n_h2o=150, n_o2=24, tile=128), nmol=22,
                device="cpu")
    st = state_from_numpy(j_state(nlay=3), "cpu", torch.float32)
    p = torch.full_like(st.p, p_hpa)
    scor = m.tips.scor(st.t).reshape(3, 39 * 9)
    plan = m.dev_plans["full"]
    with torch.no_grad():
        pre = precompute(plan["cat"], p, st.t, st.wkl, st.wbrodl, scor,
                         m.line_cfg)
    args = (plan["cat"]["mol"], plan["wn_hi"], plan["wn_lo"],
            plan["cand_map"], plan["cand_valid"], plan["nt"], plan["wt"], 22)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, plan["wn_hi"].shape[0], 22)).astype(np.float32))
    d = lambda v: (v.double() if torch.is_tensor(v)
                   else {k: x.double() for k, x in v.items()})
    pre64 = {k: d(v) for k, v in pre.items()}
    args64 = (args[0], d(args[1]), d(args[2])) + args[3:]
    out = {"new": dict(zip(PER_LN, line_sum_bwd_plain(pre, *args, g))),
           "ref": dict(zip(PER_LN, line_sum_bwd_plain(
               pre64, *args64, d(g), f32_fallback=True))),
           "old": sweep_bwd_plain(_contrib_voigt, pre, *args, g)}
    sd = linesum.sdvoigt
    cut = lambda *a, **k: sd(*(x.detach() for x in a), **k)
    with mock.patch.object(linesum, "sdvoigt", cut):
        out["lor32"] = sweep_bwd_plain(_contrib_voigt, pre, *args, g)
        out["lor64"] = sweep_bwd_plain(
            functools.partial(_contrib_voigt, f32_fallback=True), pre64,
            *args64, d(g))
    return out


@pytest.mark.parametrize("name", PER_LN)
def test_plain_adjoint_near_vacuum_sdvoigt_share_matches_float64(name):
    """Each cotangent's SD-Voigt share (the cotangent less the Lorentz
    lanes' share) against float64's at 1.5e-6 * max|ref|; the Lorentz
    lanes keep their float32 reverse mode (test below), whose own error
    against float64 stays what it was."""
    c = _plain_adjoints(0.02)
    a, b = c["new"][name], c["ref"][name]
    assert a.dtype == torch.float32 and torch.isfinite(a).all()
    scale = float(b.abs().max())
    assert scale > 0.0
    if name == "stild":
        assert torch.equal(a, c["old"][name])
        assert float((a.double() - b).abs().max()) / scale < 1e-3
        return
    share = lambda x, lor: x.double() - lor.double()
    err = float((share(a, c["lor32"][name])
                 - share(b, c["lor64"][name])).abs().max()) / scale
    assert err <= 1.5e-6, f"d{name}: {err:.3e} of max"
    if name in ("shift", "hw", "ad"):
        # the float32 reverse mode's share is far off here: the repair
        # matters
        old = float((share(c["old"][name], c["lor32"][name])
                     - share(b, c["lor64"][name])).abs().max()) / scale
        assert old > 1e-3, f"d{name}: {old:.3e} of max"


@pytest.mark.parametrize("p_hpa", [1013.0, 20.0, 0.02])
def test_plain_adjoint_lorentz_lanes_unchanged(p_hpa):
    """Every cotangent at 1013 hPa (every lane Lorentz), and at 20 and
    0.02 hPa stild, k3v, ya and yb, which take no partial of an SD-Voigt
    shape, are bitwise the float32 reverse mode's."""
    c = _plain_adjoints(p_hpa)
    names = PER_LN if p_hpa == 1013.0 else ("stild", "k3v", "ya", "yb")
    for name in names:
        assert torch.equal(c["new"][name], c["old"][name]), name
