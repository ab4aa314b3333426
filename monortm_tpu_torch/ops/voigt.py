"""Voigt / speed-dependent Voigt line shapes on tensors.

Port of `monortm_tpu.ops.voigt`: Humlicek W4 and SD_Humlicek with the
reference's region boundaries and coefficients, complex arithmetic
written as (re, im) pairs, every branch a `torch.where` over guarded
inputs.  The operation order follows the JAX version so float32 results
agree to round-off.  These are the plain versions of the device
functions in `csrc/linesum.cu`.

  W4          -> modm.f90:1100-1130  (regions split at s=15 / s=5.5)
  SD_Humlicek -> modm.f90:1150-1251  (regions split at s=15 / s=6)
  VOIGT       -> modm.f90:900-962
  SDVOIGT     -> modm.f90:965-1087   (Boone et al. 2011 two-point form)
  XLORENTZ    -> modm.f90:888-895
"""

from __future__ import annotations

import math

import torch

from monortm_tpu_torch import constants as c

_SQRT_LN2 = c.SQRT_LN2
_RSQRT_PI_LN2 = (c.LN2 / c.PI) ** 0.5   # sqrt(ln2/pi)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _w_region1(tr, ti):
    # t*0.5641896/(0.5+t*t)
    ur, ui = _cmul(tr, ti, tr, ti)
    return _cdiv(0.5641896 * tr, 0.5641896 * ti, 0.5 + ur, ui)


def _w_region2(tr, ti):
    # t*(1.410474+u*0.5641896)/(0.75+u*(3.+u))
    ur, ui = _cmul(tr, ti, tr, ti)
    nr, ni = _cmul(tr, ti, 1.410474 + 0.5641896 * ur, 0.5641896 * ui)
    dr, di = _cmul(ur, ui, 3.0 + ur, ui)
    return _cdiv(nr, ni, 0.75 + dr, di)


def _horner(tr, ti, coeffs):
    """p(t) with p = c0 + t(c1 + t(...)); coeffs given highest-order first."""
    pr = torch.zeros_like(tr) + coeffs[0]
    pi = torch.zeros_like(tr)
    for a in coeffs[1:]:
        pr, pi = _cmul(pr, pi, tr, ti)
        pr = pr + a
    return pr, pi


def _w_region3(tr, ti):
    nr, ni = _horner(tr, ti, (0.5642236, 3.778987, 11.96482, 20.20933,
                              16.4955))
    dr, di = _horner(tr, ti, (1.0, 6.699398, 21.69274, 39.27121, 38.82363,
                              16.4955))
    return _cdiv(nr, ni, dr, di)


def _w_region4(tr, ti):
    ur, ui = _cmul(tr, ti, tr, ti)

    # polynomials in u with alternating signs as written in the reference
    def alt(coeffs):
        pr = torch.zeros_like(ur) + coeffs[0]
        pi = torch.zeros_like(ur)
        for a in coeffs[1:]:
            qr, qi = _cmul(ur, ui, pr, pi)
            pr, pi = a - qr, -qi
        return pr, pi

    nr, ni = alt((0.56419, 1.320522, 35.76683, 219.0313, 1540.787,
                  3321.9905, 36183.31))
    dr, di = alt((1.0, 1.841439, 61.57037, 364.2191, 2186.181,
                  9022.228, 24322.84, 32066.6))
    fr, fi = _cdiv(nr, ni, dr, di)
    pr, pi = _cmul(tr, ti, fr, fi)
    # cexp(u) - t*num/den
    eu = torch.exp(ur)
    return eu * torch.cos(ui) - pr, eu * torch.sin(ui) - pi


def _region_real(mask, fn, tr, ti, guard_r, guard_i):
    """Re[fn(t)] where `mask`, evaluated on guarded inputs elsewhere."""
    return fn(torch.where(mask, tr, guard_r), torch.where(mask, ti, guard_i))[0]


def w4_real(x, y):
    """Re[w(z)] for z = x + i y via Humlicek W4 (modm.f90:1100-1130)."""
    tr, ti = y, -x
    s = torch.abs(x) + y

    in1 = s >= 15.0
    in2 = (~in1) & (s >= 5.5)
    in34 = ~(in1 | in2)
    in4 = in34 & (y < 0.195 * torch.abs(x) - 0.176)
    in3 = in34 & ~in4

    one = torch.ones_like(tr)
    zero = torch.zeros_like(tr)
    w = torch.where(in1, _region_real(in1, _w_region1, tr, ti, one, zero),
                    0.0)
    w = torch.where(in2, _region_real(in2, _w_region2, tr, ti, one, zero), w)
    w = torch.where(in3, _region_real(in3, _w_region3, tr, ti, one, zero), w)
    w = torch.where(in4, _region_real(in4, _w_region4, tr, ti, zero, zero),
                    w)
    return w


def voigt(deltnu, alphal, alphad):
    """Voigt profile value (modm.f90:900-962), Lorentz at aD == 0."""
    ad_safe = torch.where(alphad > 0.0, alphad, 1.0)
    x = _SQRT_LN2 * deltnu / ad_safe
    y = _SQRT_LN2 * alphal / ad_safe
    v = w4_real(x, y) * _RSQRT_PI_LN2 / ad_safe

    lor = alphal / (c.PI * (alphal * alphal + deltnu * deltnu))
    return torch.where(alphad > 0.0, v, lor)


def xlorentz(z):
    """Normalised Lorentz in units of halfwidths (modm.f90:888-895)."""
    return 1.0 / (c.PI * (1.0 + z * z))


def _sd_region_id(s, x_h, y_h):
    """Region per SD_Humlicek (boundaries 15/6; modm.f90:1160-1179)."""
    r = torch.where(s >= 15.0, 1, torch.where(s >= 6.0, 2, 3))
    return torch.where((r == 3) & (y_h < 0.195 * torch.abs(x_h) - 0.176),
                       4, r)


def _w_by_region_real(tr, ti, r, own_region4):
    """Re[w] for combined region r; per-point region-4/3 fallback inside r=4
    (modm.f90:1217-1247)."""
    one = torch.ones_like(tr)
    zero = torch.zeros_like(tr)
    use4 = (r == 4) & own_region4
    use3 = (r == 3) | ((r == 4) & ~own_region4)
    m1, m2 = r == 1, r == 2
    w = torch.where(m1, _region_real(m1, _w_region1, tr, ti, one, zero), 0.0)
    w = torch.where(m2, _region_real(m2, _w_region2, tr, ti, one, zero), w)
    w = torch.where(use3, _region_real(use3, _w_region3, tr, ti, one, zero),
                    w)
    w = torch.where(use4, _region_real(use4, _w_region4, tr, ti, zero, zero),
                    w)
    return w


def _safe_sqrt(u):
    # sqrt(where(u>0, u, 1)) selected only where u > 0: the JAX version's
    # autodiff-safe form, kept so forward values stay bit-identical
    return torch.where(u > 0.0, torch.sqrt(torch.where(u > 0.0, u, 1.0)), 0.0)


def sdvoigt(deltnu, alphal, alphad, sdep, sdep_tiny: float = 1.0e-4,
            f32_fallback: bool = False):
    """Speed-dependent Voigt (Boone et al. 2011 two-point difference).

    Falls back to the plain Voigt where |sdep| <= 1e-4 (modm.f90:1017-1081)
    and, in float32, where delta > 1e6 (the two-point construction cancels
    catastrophically there; the speed-dependent correction is negligible).
    f32_fallback takes that fallback in float64 too: a float64 evaluation
    of what float32 computes, as a reference for it.
    """
    use_sd = torch.abs(sdep) > sdep_tiny
    sdep_safe = torch.where(use_sd, sdep, 1.0)
    ad_safe = torch.where(alphad > 0.0, alphad, 1.0)

    # operation order mirrors modm.f90:1029-1053: the x1 subtraction
    # cancels near line centre
    gamma2 = alphal * sdep_safe
    g2_safe = torch.where(gamma2 != 0.0, gamma2, 1.0)
    alfa = alphal / g2_safe - 1.5
    beta = deltnu / g2_safe
    delta = (1.0 / 4.0 / c.LN2) * (alphad * alphad / g2_safe / g2_safe)
    dtype = torch.promote_types(torch.promote_types(deltnu.dtype,
                                                    alphal.dtype),
                                alphad.dtype)
    if dtype != torch.float64 or f32_fallback:
        use_sd = use_sd & (delta < 1.0e6)
    # the two-point construction is evaluated at delta = 0 where it is not
    # selected: at delta > 1e6 its float32 value can be NaN, and the
    # backward of the select below would turn 0 * NaN into a NaN gradient
    # (the JAX version's gradient is NaN there).  Selected values are
    # unchanged.
    delta = torch.where(use_sd, delta, 0.0)
    alfadelta = alfa + delta

    tmp = _safe_sqrt(alfadelta * alfadelta + beta * beta)
    sqrt_delta = _safe_sqrt(delta)
    x1 = (1.0 / math.sqrt(2.0)) * _safe_sqrt(tmp + alfadelta) - sqrt_delta
    x2 = x1 + 2.0 * sqrt_delta
    # (tmp - delta - alfa) >= 0 in exact arithmetic; clamp the rounding
    # residue at line centre (sign(0)*sqrt(-eps) would be NaN)
    y1 = torch.sign(beta) * _safe_sqrt(
        torch.clamp_min((tmp - delta - alfa) / 2.0, 0.0))
    y2 = y1

    # Humlicek plane: SD_Humlicek(y1, x1, ...) gives t = x - i*y and
    # s = |y| + x (modm.f90:1058,1155-1158)
    s1 = torch.abs(y1) + x1
    s2 = torch.abs(y2) + x2
    r1 = _sd_region_id(s1, y1, x1)
    r2 = _sd_region_id(s2, y2, x2)
    r = torch.maximum(r1, r2)

    w1 = _w_by_region_real(x1, -y1, r, r1 == 4)
    w2 = _w_by_region_real(x2, -y2, r, r2 == 4)
    v_sd = (w1 - w2) * _RSQRT_PI_LN2 / ad_safe

    v_plain = voigt(deltnu, alphal, alphad)
    return torch.where(use_sd, v_sd, v_plain)
