"""Planck / radiation-field primitives on tensors (port of
`monortm_tpu.ops.planck`).

  bb_fn        -> RTMmono.f90:223-237   B(v,T) = RADCN1 v^3 / (exp(v RADCN2/T)-1)
  Tb inversion -> RTMmono.f90:149-152   T = RADCN2 v / log(RADCN1 v^3 / R + 1)
  RADFN        -> lblrtm_sub.f90:36-97  piecewise v*tanh(v/2kT) radiation term
"""

from __future__ import annotations

import torch

from monortm_tpu_torch import constants as c
from monortm_tpu_torch.ops.arith import rdiv


def planck(wn, temp):
    """Planck radiance B(wn, T) in W/(cm^2 sr cm^-1); broadcasts."""
    beta = rdiv(c.RADCN2, temp)
    return c.RADCN1 * wn**3 / torch.expm1(wn * beta)


def brightness_temperature(wn, rad):
    """Exact Planck inversion: radiance -> brightness temperature [K]."""
    x = c.RADCN1 * wn**3 / rad
    return c.RADCN2 * wn / torch.log1p(x)


def radfn(wn, xkt):
    """Radiation term v*tanh(v/(2 kT)) with the reference's piecewise form
    (lblrtm_sub.f90:76-93); xkt = T / RADCN2."""
    xviokt = torch.where(xkt > 0.0, wn / torch.where(xkt > 0.0, xkt, 1.0),
                         0.0)
    expvkt = torch.exp(-torch.clamp(xviokt, 0.0, 80.0))
    small = 0.5 * xviokt * wn
    mid = wn * (1.0 - expvkt) / (1.0 + expvkt)
    out = torch.where(xviokt <= 0.01, small,
                      torch.where(xviokt <= 10.0, mid, wn))
    return torch.where(xkt > 0.0, out, wn)
