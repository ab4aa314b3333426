"""Cloud liquid water optics — Turner-Kneifel-Cadeddu double-Debye model.

Port of `monortm_tpu.ops.cloud` (ODCLW_TKC / Forward_TKC,
CloudOptProp.f90:29-157, and the legacy Liebe-Hufford-Manabe model
ODCLW_LHM, CloudOptProp.f90:162-195), elementwise on tensors.
"""

from __future__ import annotations

import torch

from monortm_tpu_torch import constants as c
from monortm_tpu_torch.ops.arith import rdiv

_HZ_PER_GHZ = 1.0e9

# TKC empirical coefficients (CloudOptProp.f90:91-99)
_A1 = 8.110808e+01
_B1 = 4.433736e-03
_C1 = 1.301700e-13
_D1 = 6.627126e+02
_A2 = 2.025164e+00
_B2 = 1.072976e-02
_C2 = 1.011945e-14
_D2 = 6.089168e+02
_TC = 1.342433e+02


def tkc_mass_absorption(freq_ghz, temp_c):
    """Mass absorption coefficient of cloud liquid water [m^2/kg]."""
    frq = freq_ghz * _HZ_PER_GHZ
    t = temp_c
    cl = c.CLIGHT / 100.0  # m/s

    eps_s = 87.9144 - 0.404399 * t + 9.58726e-4 * t**2 - 1.32802e-6 * t**3

    delta1 = _A1 * torch.exp(-_B1 * t)
    tau1 = _C1 * torch.exp(rdiv(_D1, t + _TC))
    delta2 = _A2 * torch.exp(-_B2 * t)
    tau2 = _C2 * torch.exp(rdiv(_D2, t + _TC))

    om = 2.0 * c.PI * frq
    den1 = 1.0 + (om * tau1) ** 2
    den2 = 1.0 + (om * tau2) ** 2

    eps1 = eps_s - om**2 * (tau1**2 * delta1 / den1 + tau2**2 * delta2 / den2)
    eps2 = om * (tau1 * delta1 / den1 + tau2 * delta2 / den2)

    # Im[(eps-1)/(eps+2)] without complex arithmetic
    re_n, im_n = eps1 - 1.0, eps2
    re_d, im_d = eps1 + 2.0, eps2
    im_ratio = (im_n * re_d - re_n * im_d) / (re_d * re_d + im_d * im_d)

    return 6.0 * c.PI * im_ratio * frq * 1.0e-3 / cl


def od_clw(wn, temp, clw):
    """Cloud liquid-water optical depth (ODCLW_TKC, CloudOptProp.f90:29-53).

    wn [cm^-1], temp [K], clw [kg/m^2 = mm].  Broadcasts over all inputs.
    """
    freq_ghz = wn * c.CLIGHT / _HZ_PER_GHZ
    return tkc_mass_absorption(freq_ghz, temp - 273.15) * clw


def od_clw_lhm(wn, temp, clw):
    """Legacy Liebe-Hufford-Manabe 1991 model (CloudOptProp.f90:162-195).

    Kept for parity with the reference's ODCLW_LHM; microwave only.
    """
    freq = wn * c.CLIGHT / 1.0e9
    theta1 = 1.0 - rdiv(300.0, temp)
    eps0 = 77.66 - 103.3 * theta1
    eps1 = 0.0671 * eps0
    eps2 = 3.52 + 7.52 * theta1
    fp = 20.1 * torch.exp(7.88 * theta1)
    fs = 39.8 * fp
    # eps = (eps0-eps1)/(1+i f/fp) + (eps1-eps2)/(1+i f/fs) + eps2, expanded
    # into real pairs
    xp_, xs_ = freq / fp, freq / fs
    dp_, ds_ = 1.0 + xp_ * xp_, 1.0 + xs_ * xs_
    eps_re = (eps0 - eps1) / dp_ + (eps1 - eps2) / ds_ + eps2
    eps_im = -(eps0 - eps1) * xp_ / dp_ - (eps1 - eps2) * xs_ / ds_
    # Im[(eps-1)/(eps+2)]
    den = (eps_re + 2.0) ** 2 + eps_im**2
    im_ratio = (eps_im * (eps_re + 2.0) - (eps_re - 1.0) * eps_im) / den
    return -(6.0 * c.PI / 299.792458) * clw * im_ratio * freq
