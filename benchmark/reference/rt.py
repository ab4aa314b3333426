"""The reference's liquid cloud OD and radiative transfer: ODCLW_TKC
(CloudOptProp.f90:29-157), RAD_UP_DN and RTM (RTMmono.f90:13-221).

Rewrites of tests/reference_e2e.py's `odclw_tkc_ref`, `rad_up_dn_ref`
and `rtm_ref` over tensors [..., W, L] (layers last, surface first).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import data as D
from benchmark.reference.shapes import cdiv


def cloud_od(wn, t, clw):
    """Liquid water OD [R, W]: the TKC permittivity of water at the
    layer's temperature (t, clw [R]; wn [W])."""
    frq = wn[None, :] * D.CLIGHT          # Hz
    tc = t[:, None] - 273.15
    eps_s = (87.9144 - 0.404399 * tc + 9.58726e-4 * tc ** 2
             - 1.32802e-6 * tc ** 3)
    d1 = 8.110808e+01 * torch.exp(-4.433736e-03 * tc)
    tau1 = 1.301700e-13 * torch.exp(6.627126e+02 / (tc + 1.342433e+02))
    d2 = 2.025164e+00 * torch.exp(-1.072976e-02 * tc)
    tau2 = 1.011945e-14 * torch.exp(6.089168e+02 / (tc + 1.342433e+02))
    w = 2.0 * math.pi * frq
    den1, den2 = 1.0 + (w * tau1) ** 2, 1.0 + (w * tau2) ** 2
    eps1 = eps_s - w ** 2 * (tau1 ** 2 * d1 / den1 + tau2 ** 2 * d2 / den2)
    eps2 = w * (tau1 * d1 / den1 + tau2 * d2 / den2)
    re = cdiv((eps1 - 1.0, eps2), (eps1 + 2.0, eps2))
    alpha = 6.0 * math.pi * re[1] * frq * 1.0e-3 / (D.CLIGHT / 100.0)
    return alpha * clw[:, None]


def planck(v, t):
    """The Planck function; exp(x) - 1 as expm1, which keeps its digits at
    microwave x ~ 1e-3 in any precision (the Fortran's exp(x) - 1 loses
    them below float64)."""
    return D.RADCN1 * v ** 3 / torch.expm1(v * D.RADCN2 / t)


def rtm(o, t, tz, wn, tsfc, emis, refl, irt: int):
    """Radiance and Tb [..., W] of layer ODs o [..., W, L]; t [..., L],
    tz [..., L + 1] (surface first); emis, refl [W]; irt 1 up, 2 limb,
    3 down (RTMmono.f90:108-153)."""
    v = wn[:, None]
    bb = planck(v, t[..., None, :])
    bba = planck(v, tz[..., None, :])
    tri = torch.exp(-o)
    pade = 0.193 * o + 0.013 * o * o
    below = torch.cumsum(o, -1) - o          # OD under layer l
    above = o.sum(-1, keepdim=True) - below - o
    rdn = (torch.exp(-below) * (1.0 - tri) * (bb + pade * bba[..., :-1])
           / (1.0 + pade)).sum(-1)
    trtot = torch.exp(-o.sum(-1))
    cosmos = planck(wn, torch.full_like(wn, D.TSKY))
    if irt in (2, 3):
        tsfc = D.TSKY
    if irt == 1:
        rup = (torch.exp(-above) * (1.0 - tri) * (bb + pade * bba[..., 1:])
               / (1.0 + pade)).sum(-1)
        surf = planck(wn, torch.full_like(wn, tsfc))
        rad = rup + trtot * (emis * surf + refl * (rdn + trtot * cosmos))
    elif irt == 2:
        rup = (torch.exp(-above) * (1.0 - tri) * (bb + pade * bba[..., 1:])
               / (1.0 + pade)).sum(-1)
        rad = rup + trtot * (rdn + trtot * cosmos)
    else:
        rad = rdn + trtot * cosmos
    tb = D.RADCN2 * wn / torch.log1p(D.RADCN1 * wn ** 3 / rad)
    return rad, tb
