"""The port's infrared-to-UV MT_CKD sub-continua, Rayleigh and the legacy
cloud model against the JAX package's.

- each of the twelve sub-continua that a microwave grid leaves off (O3
  Chappuis/Wulf, Hartley-Huggins and UV; O2 fundamental, 1.27 um,
  1.06 um, A-band, visible, Herzberg and far UV; N2 fundamental and
  overtone) and Rayleigh, on a grid inside its activation range: the
  same host plan and window as the JAX `ContinuumPlan`, its evaluated
  window and every species OD on the grid, in float64 at rtol=1e-10 and
  in float32 (the plan run with float32 layers and tables, as a float32
  model runs it) at tests/test_torch_ops.py's float32 continuum
  tolerance rtol=2e-6, both with atol=1e-14 * max|ref|; and a band OD
  that is not zero;
- a grid across the Hartley-Huggins / UV seam at 40800 cm^-1, where each
  merge is masked to its side of the seam (contnm.f90:579-640), in both
  dtypes;
- `ops.cloud.od_clw_lhm` against `monortm_tpu.ops.cloud.od_clw_lhm`,
  float64 at rtol=1e-12 and float32 at rtol=1e-5 (the same product
  structure as TKC, see tests/test_torch_ops.py::test_cloud).
"""

import numpy as np
import pytest
import torch

from monortm_tpu.ops import cloud as jcloud
from monortm_tpu.ops import continuum as jcont
from monortm_tpu.testing import synthetic_state as j_state
from monortm_tpu_torch.ops import cloud, continuum

torch.set_num_threads(1)

# sub-continuum -> (species, a grid range inside its activation test)
BANDS = {
    "o3_chap": ("o3", 9000.0, 24000.0),
    "o3_hh": ("o3", 27500.0, 40700.0),
    "o3_uv": ("o3", 40900.0, 53900.0),
    "o2_fund": ("o2", 1400.0, 1800.0),
    "o2_inf1": ("o2", 7600.0, 8400.0),
    "o2_inf2": ("o2", 9200.0, 10900.0),
    "o2_aband": ("o2", 13000.0, 13200.0),
    "o2_vis": ("o2", 15100.0, 29800.0),
    "o2_herz": ("o2", 36100.0, 40000.0),
    "o2_fuv": ("o2", 56800.0, 60000.0),
    "n2_fund": ("n2", 2050.0, 2850.0),
    "n2_overtone": ("n2", 4400.0, 4900.0),
    "rayleigh": ("rayleigh", 830.0, 900.0),
}


RTOL = {np.float64: 1e-10, np.float32: 2e-6}
TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}
DTYPES = [np.float64, np.float32]


def _close(got, want, rtol=RTOL[np.float64]):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-14 * float(np.abs(want).max()))


def _plans(v1, v2, n=37):
    wn = np.linspace(v1, v2, n)
    kw = dict(dvset=float(wn[1] - wn[0]), nmol=22)
    return (jcont.ContinuumPlan(wn, **kw),
            continuum.ContinuumPlan(wn, device="cpu", **kw))


def _layers(dt):
    st = j_state(nlay=4, batch=2, seed=7)
    return [np.asarray(getattr(st, f), dt)
            for f in ("p", "t", "wkl", "wbrodl")]


def _same_plans_and_species(jc, pc, dt):
    """Identical host plans and windows, equal windows evaluated, equal
    species ODs on the grid in dtype `dt`; returns the port's species
    ODs."""
    assert [s.name for s in pc.subs] == [s.name for s in jc.subs]
    for js, ps in zip(jc.subs, pc.subs):
        assert js.species == ps.species
        for f in ("target_idx", "src_idx", "weights"):
            np.testing.assert_array_equal(getattr(js.plan, f),
                                          getattr(ps.plan, f))
        assert js.static.keys() == ps.static.keys()
        for k in js.static:
            np.testing.assert_array_equal(js.static[k], ps.static[k])
    p, t, wk, wb = _layers(dt)
    layer_j = jcont._Layer(p, t, wk, wb, 22)
    layer_p = continuum._Layer(*(torch.from_numpy(a) for a in (p, t, wk,
                                                               wb)), 22)
    for js, ps in zip(jc.subs, pc.subs):
        s = {k: v.to(TORCH_DT[dt]) for k, v in ps.dstatic.items()}
        want = js.fn({k: np.asarray(v, dt) for k, v in js.static.items()},
                     layer_j)
        _close(ps.fn(s, layer_p), want, RTOL[dt])
    want = jc(p, t, wk, wb, dtype=dt)
    got = pc(*(torch.from_numpy(a) for a in (p, t, wk, wb)),
             dtype=TORCH_DT[dt])
    for sp in continuum.SPECIES:
        assert got[sp].dtype == TORCH_DT[dt]
        _close(got[sp], want[sp], RTOL[dt])
    return got


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", sorted(BANDS))
def test_subcontinuum_matches_jax(name, dt):
    species, v1, v2 = BANDS[name]
    jc, pc = _plans(v1, v2)
    names = [s.name for s in pc.subs]
    assert name in names or name == "rayleigh"
    got = _same_plans_and_species(jc, pc, dt)
    if name == "rayleigh":
        assert pc.rayleigh_base is not None
    assert float(got[species].abs().max()) > 0.0
    # with its scale factor off, the band's OD is gone
    fac = {"o3": "xo3cn", "o2": "xo2cn", "n2": "xn2cn",
           "rayleigh": "xrayl"}[species]
    off = continuum.ContinuumPlan(
        jc.wn, dvset=float(jc.wn[1] - jc.wn[0]), nmol=22, device="cpu",
        factors=continuum.ContinuumFactors(**{fac: 0.0}))
    assert name not in [s.name for s in off.subs]


@pytest.mark.parametrize("dt", DTYPES)
def test_hartley_huggins_uv_seam(dt):
    jc, pc = _plans(40700.0, 40900.0, n=21)
    assert [s.name for s in pc.subs if s.species == "o3"] == ["o3_hh",
                                                              "o3_uv"]
    got = _same_plans_and_species(jc, pc, dt)["o3"]
    below = torch.from_numpy(jc.wn < 40800.0)
    assert float(got[..., below].min()) > 0.0       # Hartley-Huggins
    assert float(got[..., ~below].max()) > 0.0      # UV


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_od_clw_lhm_matches_jax(dt):
    rng = np.random.default_rng(11)
    wn = rng.uniform(0.3, 16.0, 200).astype(dt)       # 9-480 GHz
    temp = rng.uniform(233.0, 320.0, 200).astype(dt)
    clw = rng.uniform(0.0, 0.5, 200).astype(dt)
    got = cloud.od_clw_lhm(*(torch.from_numpy(a) for a in (wn, temp, clw)))
    want = np.asarray(jcloud.od_clw_lhm(wn, temp, clw))
    assert got.dtype == torch.from_numpy(wn).dtype
    assert float(np.abs(want).max()) > 0.0
    np.testing.assert_allclose(got.numpy(), want,
                               rtol={np.float64: 1e-12, np.float32: 1e-5}[dt])
