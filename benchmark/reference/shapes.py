"""Line shapes of the reference: Lorentz, Voigt (Humlicek's W4) and the
speed-dependent Voigt (SD_Humlicek), modm.f90:900-1251.

Vectorised transliterations of the scalar NumPy oracles (test_voigt.py's
`w4_ref`, `voigt_ref`, `sd_region`, `_w_formula`, `sdvoigt_ref`) in plain
PyTorch of any float dtype.  Complex values are (real, imaginary) pairs
of real tensors, so that the arithmetic runs in the dtype asked for,
bfloat16 included.  Each region's formula is evaluated only on the
lanes in that region, so no overflow of another region's formula reaches
a result or a gradient.
"""

from __future__ import annotations

import math

import torch

SQL2 = math.sqrt(math.log(2.0))
NORM = math.sqrt(math.log(2.0) / math.pi)


def cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def cdiv(a, b):
    """a / b by Smith's scaling (no square of |b|, so no overflow below
    float64's range)."""
    big = b[0].abs() >= b[1].abs()
    p = torch.where(big, b[0], b[1])
    r = torch.where(big, b[1], b[0]) / p
    den = p + torch.where(big, b[1], b[0]) * r
    u = torch.where(big, a[0], a[1])
    v = torch.where(big, a[1], a[0])
    return (u + v * r) / den, torch.where(big, 1.0, -1.0) * (v - u * r) / den


def cscal(c, a):
    return c + a[0], a[1]


def cexp(a):
    m = torch.exp(a[0])
    return m * torch.cos(a[1]), m * torch.sin(a[1])


def _nested(t, first, coefs):
    """first + t*(c0 + t*(c1 + ...)) with complex t, real coefficients."""
    acc = (torch.full_like(t[0], coefs[-1]), torch.zeros_like(t[0]))
    for c in reversed(coefs[:-1]):
        acc = cscal(c, cmul(t, acc))
    return cscal(first, cmul(t, acc))


def _alternating(u, coefs):
    """c0 - u*(c1 - u*(c2 - ...)) with complex u."""
    acc = (torch.full_like(u[0], coefs[-1]), torch.zeros_like(u[0]))
    for c in reversed(coefs[:-1]):
        m = cmul(u, acc)
        acc = (c - m[0], -m[1])
    return acc


def w_formula(t, region: int):
    """Humlicek's rational approximations by region (1..4)."""
    if region == 1:
        return cdiv((t[0] * 0.5641896, t[1] * 0.5641896),
                    cscal(0.5, cmul(t, t)))
    if region == 2:
        u = cmul(t, t)
        num = cmul(t, cscal(1.410474, (u[0] * 0.5641896, u[1] * 0.5641896)))
        return cdiv(num, cscal(0.75, cmul(u, cscal(3.0, u))))
    if region == 3:
        num = _nested(t, 16.4955, [20.20933, 11.96482, 3.778987, 0.5642236])
        den = _nested(t, 16.4955, [38.82363, 39.27121, 21.69274, 6.699398,
                                   1.0])
        return cdiv(num, den)
    u = cmul(t, t)
    p = _alternating(u, [36183.31, 3321.9905, 1540.787, 219.0313, 35.76683,
                         1.320522, 0.56419])
    q = _alternating(u, [32066.6, 24322.84, 9022.228, 2186.181, 364.2191,
                         61.57037, 1.841439, 1.0])
    e = cexp(u)
    r = cdiv(cmul(t, p), q)
    return e[0] - r[0], e[1] - r[1]


def _by_region(region, fn, out):
    """out[region == r] = fn(r, mask) for each region present."""
    for r in range(1, 5):
        m = region == r
        if bool(m.any()):
            out = out.index_put((m.nonzero(as_tuple=True)), fn(r, m))
    return out


def lorentz(d, hw):
    """XLORENTZ(d / hw) / hw: the normalised Lorentz profile."""
    z = d / hw
    return 1.0 / (math.pi * (1.0 + z * z)) / hw


def voigt(d, hw, ad):
    """voigt_ref: Humlicek W4 (regions at |x| + y of 15 and 5.5)."""
    x = SQL2 * d / ad
    y = SQL2 * hw / ad
    s = x.abs() + y
    region = torch.where(s >= 15.0, 1, torch.where(
        s >= 5.5, 2, torch.where(y >= 0.195 * x.abs() - 0.176, 3, 4)))
    out = torch.zeros_like(x)

    def fn(r, m):
        return w_formula((y[m], -x[m]), r)[0]

    return _by_region(region, fn, out) * NORM / ad


def sdvoigt(d, hw, ad, sdep):
    """sdvoigt_ref: the speed-dependent Voigt; the plain Voigt where
    |sdep| <= 1e-4.  Arguments broadcast to one shape."""
    d, hw, ad, sdep = torch.broadcast_tensors(d, hw, ad, sdep)
    plain = sdep.abs() <= 1e-4
    out = torch.zeros_like(d)
    if bool(plain.any()):
        i = plain.nonzero(as_tuple=True)
        out = out.index_put(i, voigt(d[i], hw[i], ad[i]))
    sd = ~plain
    if not bool(sd.any()):
        return out
    i = sd.nonzero(as_tuple=True)
    d, hw, ad, sdep = d[i], hw[i], ad[i], sdep[i]
    gamma2 = hw * sdep
    alfa = hw / gamma2 - 1.5
    beta = d / gamma2
    delta = (1.0 / 4.0 / math.log(2.0)) * ad * ad / gamma2 / gamma2
    a_ = alfa + delta
    s = a_ + torch.sqrt(a_ * a_ + beta * beta)
    # the oracle's x1 = sqrt((tmp + a_) / 2) - sqrt(delta) and y1 =
    # sign(beta) sqrt((tmp - delta - alfa) / 2), tmp = sqrt(a_^2 + beta^2),
    # rewritten without their differences of near equals (the same values
    # in exact arithmetic), which cancel below float64 at small widths
    y1 = beta / torch.sqrt(2.0 * s)
    x1 = (alfa + beta * beta / (2.0 * s)) / (torch.sqrt(s / 2.0)
                                             + torch.sqrt(delta))
    x2 = x1 + 2.0 * torch.sqrt(delta)

    def region(s, x, y):
        return torch.where(s >= 15.0, 1, torch.where(
            s >= 6.0, 2, torch.where(y < 0.195 * x.abs() - 0.176, 4, 3)))

    r1 = region(y1.abs() + x1, y1, x1)
    r2 = region(y1.abs() + x2, y1, x2)
    r = torch.maximum(r1, r2)
    reg1 = torch.where(r < 4, r, torch.where(r1 == 4, 4, 3))
    reg2 = torch.where(r < 4, r, torch.where(r2 == 4, 4, 3))
    w1 = _by_region(reg1, lambda k, m: w_formula((x1[m], -y1[m]), k)[0],
                    torch.zeros_like(x1))
    w2 = _by_region(reg2, lambda k, m: w_formula((x2[m], -y1[m]), k)[0],
                    torch.zeros_like(x2))
    return out.index_put(i, (w1 - w2) * NORM / ad)
