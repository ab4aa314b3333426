"""The port's line sum against the JAX package's, on the same inputs.

- the block-sparse plans (tiled catalog, candidate maps, two-float wn
  split) are identical for the full plan and the 128/128 Lorentz plan;
- the LINES prologue (`line_params` via `precompute`, IBRD=0 and 1)
  agrees at rtol=2e-6 in float32;
- the plain line sums agree with the JAX engines — the VOIGT=true one
  with `line_od_pallas` (the Pallas `_kernel` in interpret mode on CPU),
  the VOIGT=false one with `line_od_lorentz_xla` — at rtol=2e-5,
  atol=2e-6 * max|ref| (tests/test_pallas.py's tolerance): batched,
  all-Lorentz at 1013 hPa, near-vacuum at 0.02 hPa and far-detuned;
- the per-layer all-Lorentz predicate is identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.models.od import ODModel as JODModel
from monortm_tpu.ops.lineshape import LineConfig as JLineConfig
from monortm_tpu.ops.linesum_lorentz import (
    all_lorentz_predicate as j_predicate, line_od_lorentz_xla)
from monortm_tpu.ops.linesum_pallas import line_od_pallas
from monortm_tpu.ops.linesum_pallas import precompute as j_precompute
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu.testing import synthetic_state
from monortm_tpu_torch.models.od import ODModel
from monortm_tpu_torch.ops.lineshape import LineConfig, catalog_to_device
from monortm_tpu_torch.ops.tips import tips_scor
from monortm_tpu_torch.ops.linesum import (FLAGS, PER_L, PER_LN,
                                           VOIGT_KERNEL, line_od_forward,
                                           line_sum_bwd_plain, precompute)
from monortm_tpu_torch.ops.linesum_kernel import _LineSum
from monortm_tpu_torch.ops.linesum_lorentz import (LORENTZ_KERNEL,
                                                   all_lorentz_predicate)
from monortm_tpu_torch.testing import synthetic_catalog_mw

torch.set_num_threads(1)

WN = np.linspace(0.4, 50.0, 64)


def _catalog(kind, make=synthetic_catalog_mw):
    """The test catalog `kind`, built by the port's fixture or (make=
    j_catalog) the JAX package's: each package gets its own."""
    if kind == "far":
        # every line far above the grid, no O2: nothing inside 25 cm^-1
        cat = make(n_h2o=48, n_o2=0, seed=3, tile=128)
        cat.nu0[:] = cat.nu0 + 500.0
        cat.nu0_hi[:] = cat.nu0.astype(np.float32)
        cat.nu0_lo[:] = (cat.nu0 - cat.nu0_hi.astype(np.float64)).astype(
            np.float32)
        return cat
    cat = make(n_h2o=150, n_o2=24, tile=128)
    if kind == "no_sd":
        cat.sdep[:] = 0.0
    if kind == "ibrd":
        cat.brd_flg[::3, :3] = 1
        cat.brd_hw[::3, :3] = 0.07
        cat.brd_tmp[::3, :3] = 0.7
        cat.brd_shft[::3, :3] = 0.01
    return cat


def _models(kind, line_tile=256, ibrd=0):
    kw = dict(dvset=float(WN[1] - WN[0]), nmol=22)
    jm = JODModel(WN, catalog=_catalog(kind, j_catalog), dtype=jnp.float32,
                  use_pallas=True, pallas_wn_tile=128,
                  pallas_line_tile=line_tile,
                  line_cfg=JLineConfig(ibrd=ibrd), **kw)
    pm = ODModel(WN, catalog=_catalog(kind), device="cpu", wn_tile=128,
                 line_tile=line_tile, line_cfg=LineConfig(ibrd=ibrd), **kw)
    return jm, pm


def _state(p_top=None, p_const=None, nlay=4, batch=None):
    """Flat-layer f32 inputs (p, t, wk, wbrod, scor_flat) as numpy."""
    st = synthetic_state(nlay=nlay, batch=batch)
    p = np.asarray(st.p)
    if p_top is not None:
        p = np.broadcast_to(np.geomspace(1000.0, p_top, nlay), p.shape)
    if p_const is not None:
        p = np.full_like(p, p_const)
    f = lambda a, *trail: np.asarray(a, np.float32).reshape((-1,) + trail)
    t = f(st.t)
    # any TIPS ratios serve, as long as both packages get the same ones
    scor = tips_scor(torch.from_numpy(t), torch.float32).numpy()
    return (f(p), t, f(st.wkl, 39), f(st.wbrodl),
            scor.reshape(scor.shape[0], 39 * 9))


def _torch(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _jax_plan(jm, lorentz):
    if lorentz:
        return jm._plan_lorentz
    return {k: getattr(jm, "pallas_" + k)
            for k in ("cat", "nt", "wt", "wn_hi", "wn_lo", "cand_map",
                      "cand_valid")}


@pytest.mark.parametrize("line_tile", [256, 128])
def test_plans_identical(line_tile):
    jm, pm = _models("plain", line_tile=line_tile)
    for lorentz, mine in ((False, pm.plan), (True, pm.plan_lorentz)):
        ref = _jax_plan(jm, lorentz)
        assert (ref["nt"], ref["wt"]) == (mine["nt"], mine["wt"])
        for k in ("wn_hi", "wn_lo", "cand_map", "cand_valid"):
            np.testing.assert_array_equal(np.asarray(ref[k]), mine[k],
                                          err_msg=k)
        assert ref["cat"].keys() == mine["cat"].keys()
        for k in ref["cat"]:
            np.testing.assert_array_equal(ref["cat"][k], mine["cat"][k],
                                          err_msg=k)
    assert pm.plan["cand_valid"].sum() > pm.plan["cand_map"].shape[0]


@pytest.mark.parametrize("ibrd", [0, 1])
def test_precompute_matches(ibrd):
    """line_params / precompute over the tiled catalog, across pressure
    regimes (Lorentz, SD-Voigt, near vacuum), in float32."""
    jm, pm = _models("ibrd" if ibrd else "plain", ibrd=ibrd)
    args = _state(p_top=0.02, nlay=6, batch=2)
    # eager, op by op as the port runs: under jit XLA fuses the prologue
    # and rounds differently from the JAX package's own eager ops
    want = j_precompute(jm.pallas_cat, *(jnp.asarray(a) for a in args),
                        JLineConfig(ibrd=ibrd), jnp.float32)
    got = precompute(catalog_to_device(pm.plan["cat"], "cpu"), *_torch(args),
                     LineConfig(ibrd=ibrd), torch.float32)
    for k in PER_LN + PER_L:
        # k3v, the SD-Voigt pedestal at 25 cm^-1, is a difference of two
        # nearly equal Humlicek values: near vacuum a 1-ulp change of hw
        # or ad changes its float32 value entirely, in both packages.  It
        # only enters within 100 aD of a line centre, subtracted from a
        # profile of peak sqrt(ln2/pi)/aD, so it is held to that scale.
        g, w = got[k].numpy(), np.asarray(want[k])
        atol = 2e-6 * 0.4697186 / np.asarray(want["ad"]) if k == "k3v" \
            else 0.0
        bad = np.abs(g - w) > 2e-6 * np.abs(w) + atol
        assert not bad.any(), (k, g[bad][:5], w[bad][:5])
    for k in FLAGS:
        np.testing.assert_array_equal(got["flags"][k].numpy(),
                                      np.asarray(want["flags"][k]))


# atol is relative to max|ref|.  Near vacuum the speed-dependent Voigt is
# ill-conditioned in float32: its two-point difference w(x1) - w(x2)
# cancels ~1e3-fold, so the 1-ulp differences between the two libraries'
# exp/cos/sin in Humlicek region 4 (the only ops that are not bitwise
# equal between the packages) reach ~2e-4 of a line's peak.  The vacuum
# case is therefore run with the speed dependence off at the kernel
# tolerance, and with it on at the float32 reference's own noise.
CASES = {
    "batched": dict(cat="plain", state=dict(batch=2), atol=2e-6),
    "lorentz_1013hPa": dict(cat="plain", state=dict(p_const=1013.0),
                            atol=2e-6),
    "vacuum_0.02hPa": dict(cat="no_sd", state=dict(p_const=0.02),
                           atol=2e-6),
    "vacuum_sd_0.02hPa": dict(cat="plain", state=dict(p_const=0.02),
                              atol=1e-3),
    "far_detuned": dict(cat="far", state={}, atol=2e-6),
}


def _group_state(cat_kind):
    """The flat-layer inputs of every case on one catalog, concatenated,
    and each case's slice of the layer axis."""
    parts, slices, l0 = [], {}, 0
    for case, spec in CASES.items():
        if spec["cat"] == cat_kind:
            parts.append(_state(**spec["state"]))
            slices[case] = slice(l0, l0 + len(parts[-1][0]))
            l0 = slices[case].stop
    return [np.concatenate(a) for a in zip(*parts)], slices


@functools.lru_cache(maxsize=None)
def _jax_line_sum(cat_kind, lorentz, line_tile):
    """The JAX engine's sf and its prologue's operands (numpy) for all
    cases on one catalog in one call: the interpret-mode Pallas call
    dominates this file's time."""
    jm, _ = _models(cat_kind, line_tile=line_tile)
    args, _ = _group_state(cat_kind)
    jargs = [jnp.asarray(a) for a in args]
    plan = _jax_plan(jm, lorentz)
    jfn = line_od_lorentz_xla if lorentz else line_od_pallas
    # jitted: one XLA compile is faster than eager interpret-mode dispatch
    want = np.asarray(jax.jit(lambda *a: jfn(
        plan["cat"], plan["wn_hi"], plan["wn_lo"], plan["cand_map"],
        plan["cand_valid"], plan["nt"], plan["wt"], *a, cfg=JLineConfig(),
        n_mol=22))(*jargs))
    # the operands the jitted kernel call saw
    jpre = jax.jit(lambda *a: j_precompute(plan["cat"], *a, JLineConfig(),
                                           jnp.float32))(*jargs)
    pre = {k: np.array(jpre[k]) for k in PER_LN + PER_L}
    pre["flags"] = {k: np.array(jpre["flags"][k]) for k in FLAGS}
    return want, pre


def _line_sums(case, lorentz, line_tile=256, jax_operands=True):
    """(port, JAX) sf [L, Wp, n_mol] for one case.  jax_operands: feed the
    port's sum the JAX prologue's operands, so the comparison is of the
    sums alone; otherwise the port runs its own prologue too."""
    kind = CASES[case]["cat"]
    _, pm = _models(kind, line_tile=line_tile)
    args, slices = _group_state(kind)
    ls = slices[case]
    args = [a[ls] for a in args]
    want, jpre = _jax_line_sum(kind, lorentz, line_tile)
    want = want[ls]
    dp = pm.dev_plans["lorentz" if lorentz else "full"]
    plan_args = (dp["wn_hi"], dp["wn_lo"], dp["cand_map"], dp["cand_valid"],
                 dp["nt"], dp["wt"])
    kernel = LORENTZ_KERNEL if lorentz else VOIGT_KERNEL
    if jax_operands:
        pre = {k: torch.from_numpy(jpre[k][ls]) for k in PER_LN}
        pre.update({k: torch.from_numpy(jpre[k]) for k in PER_L})
        pre["flags"] = {k: torch.from_numpy(v)
                        for k, v in jpre["flags"].items()}
        got = kernel(pre, dp["cat"]["mol"], *plan_args, 22)
    else:
        got = line_od_forward(dp["cat"], *plan_args, *_torch(args),
                              cfg=LineConfig(), n_mol=22, kernel=kernel)
    return got.numpy(), want


def _check_sums(got, want, case):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=CASES[case]["atol"] * scale)
    if case == "far_detuned":
        assert float(np.abs(got).max()) == 0.0
    else:
        assert scale > 1e-30


@pytest.mark.parametrize("lorentz", [False, True], ids=["voigt", "lorentz"])
@pytest.mark.parametrize("case", list(CASES))
def test_line_sum_matches_jax(case, lorentz):
    """The plain sums on the JAX prologue's operands."""
    launches = (VOIGT_KERNEL.launches, LORENTZ_KERNEL.launches)
    _check_sums(*_line_sums(case, lorentz), case)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (VOIGT_KERNEL.launches, LORENTZ_KERNEL.launches) == launches


# near vacuum the float32 pedestal k3v is ill-conditioned (see
# test_precompute_matches), so prologue-plus-sum runs at the other cases
@pytest.mark.parametrize("lorentz", [False, True], ids=["voigt", "lorentz"])
@pytest.mark.parametrize("case", ["batched", "lorentz_1013hPa",
                                  "far_detuned"])
def test_line_od_forward_matches_jax(case, lorentz):
    """The port's prologue and sum together."""
    _check_sums(*_line_sums(case, lorentz, jax_operands=False), case)


def test_line_sum_multi_tile_plan():
    """nt=128 splits the windowed lines over two tiles plus an O2 tile."""
    _check_sums(*_line_sums("batched", lorentz=False, line_tile=128,
                            jax_operands=False), "batched")


@pytest.mark.parametrize("p_top", [400.0, 50.0, 0.02])
def test_predicate_identical(p_top):
    jm, pm = _models("plain")
    args = _state(p_top=p_top, nlay=6, batch=2)
    want = np.asarray(j_predicate(jm.host_cat,
                                  *(jnp.asarray(a) for a in args),
                                  JLineConfig(), jnp.float32,
                                  per_layer=True))
    got = all_lorentz_predicate(pm.dev_cat, *_torch(args), LineConfig(),
                                torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    if p_top == 50.0:
        assert want.any() and not want.all()


def test_backward_raises():
    """Off the CPU the adjoint launches its kernel or raises; on CPU
    tensors it takes the plain adjoint and launches nothing, giving the
    gradient of the plain sum: autograd's own on the Lorentz lanes, with
    float64 partials on the SD-Voigt lanes as the kernel takes them, so
    it is held to the plain adjoint run in float64 (float32's branch)."""
    _, pm = _models("plain")
    dp = pm.dev_plans["full"]
    args = _torch(_state())
    pre = precompute(dp["cat"], *args, LineConfig(), torch.float32)
    plan = (dp["cat"]["mol"], dp["wn_hi"], dp["wn_lo"], dp["cand_map"],
            dp["cand_valid"], dp["nt"], dp["wt"], 22)
    leaves = {k: pre[k].detach().requires_grad_() for k in PER_LN}
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, len(dp["wn_hi"]), 22)).astype(np.float32))
    launches = VOIGT_KERNEL.bwd_launches
    (VOIGT_KERNEL({**pre, **leaves}, *plan) * w).sum().backward()
    assert VOIGT_KERNEL.bwd_launches == launches
    d = lambda v: v.double() if torch.is_tensor(v) else v
    pre64 = {k: d(v) for k, v in pre.items() if k != "flags"}
    ref = dict(zip(PER_LN, line_sum_bwd_plain(
        {**pre64, "flags": pre["flags"]}, plan[0], d(plan[1]), d(plan[2]),
        *plan[3:], w.double(), f32_fallback=True)))
    for k in PER_LN:
        np.testing.assert_allclose(leaves[k].grad.numpy(),
                                   ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(ref[k].abs().max()),
                                   err_msg=k)
    meta = {k: v.to("meta") if torch.is_tensor(v) else v
            for k, v in pre.items()}
    meta["flags"] = {k: v.to("meta") for k, v in pre["flags"].items()}
    ctx = type("Ctx", (), {})()
    ctx.kernel, ctx.static = VOIGT_KERNEL, {k: meta[k] for k in PER_L}
    ctx.static["flags"] = meta["flags"]
    ctx.plan = tuple(v.to("meta") if torch.is_tensor(v) else v
                     for v in plan) + (None, None)
    ctx.saved_tensors = tuple(meta[k] for k in PER_LN)
    with pytest.raises(RuntimeError, match="no kernel"):
        _LineSum.backward(ctx, torch.zeros(4, len(dp["wn_hi"]), 22,
                                           device="meta"))


def test_no_kernel_for_other_devices():
    """Off the CPU the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    n, L = 128, 2
    pre = {k: torch.zeros(L, n, device="meta") for k in PER_LN}
    pre.update({k: torch.zeros(n, device="meta") for k in PER_L})
    pre["flags"] = {k: torch.zeros(n, device="meta") for k in FLAGS}
    cm = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    wn = torch.zeros(128, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        VOIGT_KERNEL(pre, torch.ones(n, dtype=torch.int64, device="meta"),
                     wn, wn, cm, cm, 128, 128, 22)


@pytest.mark.parametrize("engine,j_engine,j_pallas",
                         [("full", "pallas", True),
                          ("lorentz", "lorentz-xla", True),
                          ("dense", None, False)])
def test_chi_fn_hook_matches_jax(engine, j_engine, j_pallas):
    """LineConfig.chi_fn, the CO2 chi hook (modm.f90:1253-1290, identity
    in the reference), on CPU tensors: with tests/test_pallas.py's
    test_chi_fn_hook catalog (a third of the H2O lines made CO2) and chi
    = 0.5, the port's line OD by molecule agrees with the JAX engine's
    (the Pallas kernel in interpret mode, the all-Lorentz XLA engine, the
    dense XLA engine) at the forward tolerance; its CO2 OD is half of
    its own without the hook (rtol 1e-6) and every other molecule
    bitwise unchanged.  (On CUDA tensors the line-sum kernels refuse the
    hook: chip_smoke.py phase 3.)"""
    import dataclasses as dc
    from monortm_tpu import lines as j_lines
    from monortm_tpu_torch import lines
    from monortm_tpu_torch.convert import state_from_numpy

    def co2_catalog(make, pkg):
        raw = make(n_h2o=48, n_o2=16, raw_lines=True)
        m, iso = raw.mol % 100, raw.mol // 100
        sel = (m == 1) & (np.arange(len(raw.mol)) % 3 == 0)
        raw.mol[sel] = (2 + 100 * iso[sel]).astype(np.int32)
        return pkg.pack(pkg.resolve(pkg.group(raw)), tile=128)

    wn = np.linspace(0.4, 50.0, 64)
    dv = float(wn[1] - wn[0])
    st = synthetic_state(nlay=3)
    half = lambda d: d * 0.0 + 0.5

    j_cat = co2_catalog(j_catalog, j_lines)
    ref = np.asarray(JODModel(
        wn, dvset=dv, catalog=j_cat, nmol=22, dtype=jnp.float32, wn_tile=32,
        line_tile=128, use_pallas=j_pallas,
        line_cfg=JLineConfig(chi_fn=half))(st, engine=j_engine).od_by_mol)

    cat = co2_catalog(synthetic_catalog_mw, lines)
    state = state_from_numpy(st, "cpu", torch.float32)
    got = {}
    for chi in (None, half):
        m = ODModel(wn, dv, cat, nmol=22, device="cpu", wn_tile=128,
                    line_tile=128, line_cfg=dc.replace(LineConfig(),
                                                       chi_fn=chi))
        with torch.no_grad():
            got[chi] = m(state, engine=engine).od_by_mol.numpy()
    a, b = got[None], got[half]
    assert np.abs(a[:, 1, :]).max() > 0
    np.testing.assert_allclose(b, ref, rtol=2e-5,
                               atol=2e-6 * float(np.abs(ref).max()))
    np.testing.assert_allclose(b[:, 1, :], 0.5 * a[:, 1, :], rtol=1e-6)
    keep = [i for i in range(a.shape[1]) if i != 1]
    np.testing.assert_array_equal(b[:, keep, :], a[:, keep, :])
