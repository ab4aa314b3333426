"""The port's elementwise ops against the JAX package's, on the same inputs.

Line shapes (every W4 region and the SD fallbacks), TIPS, Planck/RADFN,
cloud, XINT and the four ported MT_CKD sub-continua, at rtol=1e-12 in
float64 and rtol=2e-6 in float32.  Inputs come from numpy seeds and go
through both packages as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.ops import cloud as jcloud
from monortm_tpu.ops import continuum as jcont
from monortm_tpu.ops import planck as jplanck
from monortm_tpu.ops import tips as jtips
from monortm_tpu.ops import voigt as jvoigt
from monortm_tpu.ops import xint as jxint
from monortm_tpu.testing import synthetic_state as j_synthetic_state
from monortm_tpu_torch.ops import cloud, continuum, planck, tips, voigt, xint

torch.set_num_threads(1)

RTOL = {np.float64: 1e-12, np.float32: 2e-6}
DTYPES = [np.float64, np.float32]
TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}


def _t(a, dt):
    return torch.from_numpy(np.array(a, dt))


def _close(got, want, dt, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL[dt], atol=atol)


def _w4_points(rng):
    """(x, y) hitting every W4 region (s = |x| + y split at 15 / 5.5 and
    the region-4 wedge y < 0.195|x| - 0.176)."""
    x = np.concatenate([rng.uniform(-40, 40, 200), rng.uniform(-5, 5, 200),
                        rng.uniform(-14, 14, 200)])
    y = np.concatenate([rng.uniform(0, 20, 200), rng.uniform(1e-4, 3, 200),
                        rng.uniform(1e-4, 0.5, 200)])
    return x, y


@pytest.mark.parametrize("dt", DTYPES)
def test_w4_and_voigt(dt):
    rng = np.random.default_rng(0)
    x, y = _w4_points(rng)
    s = np.abs(x) + y
    in4 = (s < 5.5) & (y < 0.195 * np.abs(x) - 0.176)
    assert (s >= 15).any() and ((s >= 5.5) & (s < 15)).any() and in4.any() \
        and ((s < 5.5) & ~in4).any()
    _close(voigt.w4_real(_t(x, dt), _t(y, dt)),
           jvoigt.w4_real(x.astype(dt), y.astype(dt)), dt)

    d = rng.uniform(-30, 30, 500).astype(dt)
    al = rng.uniform(1e-4, 0.1, 500).astype(dt)
    ad = rng.uniform(1e-5, 1e-3, 500).astype(dt)
    ad[::7] = 0.0                                  # Lorentz fallback
    _close(voigt.voigt(_t(d, dt), _t(al, dt), _t(ad, dt)),
           jvoigt.voigt(d, al, ad), dt)
    _close(voigt.xlorentz(_t(d, dt)), jvoigt.xlorentz(d), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_sdvoigt(dt):
    """SD-Voigt over near-centre, wing and far points, with the plain
    Voigt fallbacks (|sdep| <= 1e-4 and, in float32, delta > 1e6)."""
    rng = np.random.default_rng(1)
    n = 600
    d = np.concatenate([rng.uniform(-1e-3, 1e-3, n // 3),
                        rng.uniform(-0.5, 0.5, n // 3),
                        rng.uniform(-30, 30, n // 3)]).astype(dt)
    al = rng.uniform(1e-5, 0.1, n).astype(dt)
    ad = rng.uniform(1e-5, 1e-3, n).astype(dt)
    sdep = rng.uniform(0, 0.12, n).astype(dt)
    sdep[::5] = 0.0                                # plain-Voigt fallback
    sdep[1::11] = 1.01e-4                          # delta > 1e6 (f32)
    got = voigt.sdvoigt(_t(d, dt), _t(al, dt), _t(ad, dt), _t(sdep, dt))
    want = jvoigt.sdvoigt(d, al, ad, sdep)
    # the two-point difference cancels near line centre: compare against
    # the magnitude of the profile there
    scale = np.abs(np.asarray(want)).max()
    _close(got, want, dt, atol=RTOL[dt] * scale)


@pytest.mark.parametrize("dt", DTYPES)
def test_tips(dt):
    t = np.concatenate([np.linspace(60.0, 400.0, 37), [70.0, 296.0, 3000.0]])
    got = tips.tips_scor(_t(t, dt), dtype=TORCH_DT[dt])
    want = jtips.tips_scor(jnp.asarray(t, dt), dtype=dt)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_planck_radfn(dt):
    rng = np.random.default_rng(2)
    # atmospheric temperatures over the whole grid, the 2.75 K cosmic
    # background over the microwave (where B stays a normal f32 number)
    wn = np.concatenate([rng.uniform(0.3, 3000.0, 250),
                         rng.uniform(0.3, 60.0, 50)]).astype(dt)
    temp = np.concatenate([rng.uniform(150.0, 330.0, 250),
                           np.full(50, 2.75)]).astype(dt)
    b = np.asarray(jplanck.planck(wn, temp))
    _close(planck.planck(_t(wn, dt), _t(temp, dt)), b, dt)
    _close(planck.brightness_temperature(_t(wn, dt), _t(b, dt)),
           jplanck.brightness_temperature(wn, b), dt)
    # RADFN's three branches: v/kT <= 0.01, <= 10, above; and kT = 0
    xkt = (temp / 1.4387752).astype(dt)
    xkt[::9] = 0.0
    wn_r = np.concatenate([rng.uniform(1e-3, 1.0, 100),
                           rng.uniform(1.0, 500.0, 100),
                           rng.uniform(500.0, 5e4, 100)]).astype(dt)
    _close(planck.radfn(_t(wn_r, dt), _t(xkt, dt)), jplanck.radfn(wn_r, xkt),
           dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_cloud(dt):
    rng = np.random.default_rng(3)
    wn = rng.uniform(0.3, 16.0, 200).astype(dt)       # 9-480 GHz
    temp = rng.uniform(233.0, 320.0, 200).astype(dt)
    clw = rng.uniform(0.0, 0.5, 200).astype(dt)
    # TKC forms Im[(eps-1)/(eps+2)] = 3 eps2 / |eps+2|^2 as a difference
    # of products |eps+2|/3 ~ 30x larger than the result, so in float32 a
    # 1-ulp difference between the two libraries' exp grows to ~30 ulp
    rtol = {np.float64: 1e-12, np.float32: 1e-5}[dt]
    np.testing.assert_allclose(
        cloud.od_clw(_t(wn, dt), _t(temp, dt), _t(clw, dt)).numpy(),
        np.asarray(jcloud.od_clw(wn, temp, clw)), rtol=rtol)
    f = (wn * 29.9792458).astype(dt)
    tc = (temp - 273.15).astype(dt)
    np.testing.assert_allclose(
        cloud.tkc_mass_absorption(_t(f, dt), _t(tc, dt)).numpy(),
        np.asarray(jcloud.tkc_mass_absorption(f, tc)), rtol=rtol)


@pytest.mark.parametrize("dt", DTYPES)
def test_xint_plans_and_apply(dt):
    rng = np.random.default_rng(4)
    wn = np.sort(rng.uniform(2.0, 60.0, 50))
    jp = jxint.build_xint_plan(-3.0, 1.0, 70, 0.3, 0.05, 1, 900, 1100)
    pp = xint.build_xint_plan(-3.0, 1.0, 70, 0.3, 0.05, 1, 900, 1100)
    jq = jxint.build_xint_plan_points(-3.0, 1.0, 70, wn)
    pq = xint.build_xint_plan_points(-3.0, 1.0, 70, wn)
    for a, b in ((jp, pp), (jq, pq)):
        for f in ("target_idx", "src_idx", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_src, a.n_target) == (b.n_src, b.n_target)
    src = rng.uniform(0.0, 2.0, (3, 70)).astype(dt)
    out0 = rng.uniform(0.0, 1.0, (3, 1100)).astype(dt)
    dev = xint.DeviceXintPlan(pp, "cpu")
    _close(dev.apply(_t(src, dt), _t(out0, dt)),
           jp.apply(src, jnp.asarray(out0)), dt)
    _close(dev.apply(_t(src, dt)), jp.apply(src), dt)
    _close(dev.gather(_t(src, dt)), jp.gather(src), dt)


def _layer_args(dt, nlay=6):
    st = j_synthetic_state(nlay=nlay, batch=2)
    return [np.asarray(getattr(st, f), dt) for f in ("p", "t", "wkl",
                                                     "wbrodl")]


@pytest.mark.parametrize("dvset", [0.05, 0.0])
@pytest.mark.parametrize("dt", DTYPES)
def test_continuum_microwave(dt, dvset):
    """h2o_self, h2o_frgn, co2_frgn and n2_rt on a 0.3-55 cm^-1 grid:
    identical host plans, matching sub-continuum values and species ODs
    (dvset=0 takes the per-point stage-2 plan)."""
    wn = np.linspace(0.3, 55.0, 120)
    jc = jcont.ContinuumPlan(wn, dvset=dvset, nmol=22)
    pc = continuum.ContinuumPlan(wn, dvset=dvset, nmol=22, device="cpu")
    assert [s.name for s in pc.subs] == [s.name for s in jc.subs] == [
        "h2o_self", "h2o_frgn", "co2_frgn", "n2_rt"]
    for js, ps in zip(jc.subs, pc.subs):
        for f in ("target_idx", "src_idx", "weights"):
            np.testing.assert_array_equal(getattr(js.plan, f),
                                          getattr(ps.plan, f))
        assert js.static.keys() == ps.static.keys()
        for k in js.static:
            np.testing.assert_array_equal(js.static[k], ps.static[k])
    np.testing.assert_array_equal(jc.stage2.weights, pc.stage2.weights)

    p, t, wk, wb = _layer_args(dt)
    layer_j = jcont._Layer(p, t, wk, wb, 22)
    layer_p = continuum._Layer(*(_t(a, dt) for a in (p, t, wk, wb)), 22)
    for js, ps in zip(jc.subs, pc.subs):
        s = {k: v.to(TORCH_DT[dt]) for k, v in ps.dstatic.items()}
        want = js.fn({k: np.asarray(v, dt) for k, v in js.static.items()},
                     layer_j)
        _close(ps.fn(s, layer_p), want, dt)

    want = jc(p, t, wk, wb, dtype=dt)
    got = pc(*(_t(a, dt) for a in (p, t, wk, wb)), dtype=TORCH_DT[dt])
    for sp in continuum.SPECIES:
        _close(got[sp], want[sp], dt)
    assert float(np.abs(np.asarray(want["h2o"])).max()) > 0


@pytest.mark.parametrize("v1,v2,name", [(800.0, 900.0, "rayleigh"),
                                        (1300.0, 1400.0, "o2_fund"),
                                        (2100.0, 2200.0, "n2_fund"),
                                        (9000.0, 9100.0, "o3_chap")])
def test_unported_continuum_raises(v1, v2, name):
    """Grids that once made the plan raise for a sub-continuum not yet
    ported: the sub-continuum (or Rayleigh) is now built, and the species
    ODs equal the JAX plan's in float64 (rtol=1e-12) and are not zero."""
    wn = np.linspace(v1, v2, 16)
    pc = continuum.ContinuumPlan(wn, dvset=float(wn[1] - wn[0]), nmol=22,
                                 device="cpu")
    jc = jcont.ContinuumPlan(wn, dvset=float(wn[1] - wn[0]), nmol=22)
    assert [s.name for s in pc.subs] == [s.name for s in jc.subs]
    assert name in [s.name for s in pc.subs] or (
        name == "rayleigh" and pc.rayleigh_base is not None)
    p, t, wk, wb = _layer_args(np.float64)
    want = jc(p, t, wk, wb, dtype=np.float64)
    got = pc(*(_t(a, np.float64) for a in (p, t, wk, wb)),
             dtype=torch.float64)
    for sp in continuum.SPECIES:
        _close(got[sp], want[sp], np.float64)
    species = {"rayleigh": "rayleigh", "o2_fund": "o2", "n2_fund": "n2",
               "o3_chap": "o3"}[name]
    assert float(got[species].abs().max()) > 0.0
