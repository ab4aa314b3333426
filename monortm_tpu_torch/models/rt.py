"""Monochromatic radiative-transfer solver (port of `monortm_tpu.models.rt`).

The reference's up/down layer recurrences (RTMmono.f90:157-221) are
prefix sums, so they run as cumulative sums along the layer axis, batched
over any leading axes.

Conventions (identical to the reference):
  * layers are ordered surface -> top (IDU=1, RTMmono.f90:173)
  * od:   [..., nlay]    layer optical depths (nepers)
  * t:    [..., nlay]    layer-average temperatures
  * tz:   [..., nlay+1]  level temperatures, tz[...,0] = surface level
  * wn:   broadcastable to od[..., 0]  (wavenumbers, cm^-1)

Linear-in-tau "Pade" effective Planck (Clough et al. 1992,
RTMmono.f90:202-216): pade = 0.193*tau + 0.013*tau^2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from monortm_tpu_torch import constants as c
from monortm_tpu_torch.ops.planck import brightness_temperature, planck


class RTResult(NamedTuple):
    rad: torch.Tensor      # radiance  [..., nwn]
    tb: torch.Tensor       # brightness temperature [..., nwn]
    rup: torch.Tensor      # upwelling path radiance
    rdn: torch.Tensor      # downwelling path radiance
    trtot: torch.Tensor    # total transmittance
    tmr: torch.Tensor      # mean radiating temperature


def _pade(tau):
    return 0.193 * tau + 0.013 * tau * tau


def rad_up_dn(od, t, tz, wn):
    """Up/downwelling path radiances + total transmittance.

    Returns (rup, rdn, trtot, sumexp_dn, odtot); sumexp_dn is the
    downwelling Beff-weighted sum reused by the mean radiating temperature.
    """
    wn = wn[..., None]                                   # align with layers
    bb = planck(wn, t)                                   # layer-average
    bba = planck(wn, tz)                                 # levels, nlay+1

    emit = -torch.expm1(-od)                             # 1 - exp(-od)
    pade = _pade(od)
    odtot = torch.sum(od, dim=-1)

    # transmittance from the top of layer l to TOA: exp(-sum_{k>l} od_k)
    od_above = torch.flip(torch.cumsum(torch.flip(od, (-1,)), dim=-1),
                          (-1,)) - od
    # transmittance from the bottom of layer l to the surface
    od_below = torch.cumsum(od, dim=-1) - od
    tr_above = torch.exp(-od_above)
    tr_below = torch.exp(-od_below)

    # upwelling: boundary Planck at the layer's upper level (tz[l])
    beff_up = (bb + pade * bba[..., 1:]) / (1.0 + pade)
    rup = torch.sum(tr_above * emit * beff_up, dim=-1)

    # downwelling: boundary Planck at the layer's lower level (tz[l-1])
    beff_dn = (bb + pade * bba[..., :-1]) / (1.0 + pade)
    sumexp_dn = tr_below * emit * beff_dn
    rdn = torch.sum(sumexp_dn, dim=-1)

    trtot = torch.exp(-odtot)
    return rup, rdn, trtot, sumexp_dn, odtot


def rtm(od, t, tz, wn, tsfc, emis, refl, irt: int, tsky: float = c.TSKY):
    """Full radiative transfer: path radiances combined with boundaries.

    irt: 1 = upwelling (space-based), 2 = limb, 3 = downwelling (ground);
    for irt 2 and 3 the surface temperature is the cosmic background
    (RTMmono.f90:113-124).  ref: RTMmono.f90:13-155.
    """
    rup, rdn, trtot, sumexp_dn, odtot = rad_up_dn(od, t, tz, wn)

    if irt in (2, 3):
        tsfc = tsky
    surfrad = planck(wn, tsfc)
    cosmos = planck(wn, tsky)

    if irt == 1:
        rad = rup + trtot * (emis * surfrad + refl * (rdn + trtot * cosmos))
    elif irt == 2:
        rad = rup + trtot * (rdn + trtot * cosmos)
    elif irt == 3:
        rad = rdn + trtot * cosmos
    else:
        raise ValueError(f"irt must be 1, 2 or 3; got {irt}")

    tb = brightness_temperature(wn, rad)

    # mean radiating temperature (downwelling-only diagnostic,
    # Han & Westwater 2000 eq 14; RTMmono.f90:239-325)
    radtmr = torch.sum(sumexp_dn, dim=-1) / (-torch.expm1(-odtot))
    tmr = brightness_temperature(wn, radtmr)
    return RTResult(rad=rad, tb=tb, rup=rup, rdn=rdn, trtot=trtot, tmr=tmr)


def calctmr(od, t, tz, wn):
    """Standalone mean radiating temperature (RTMmono.f90:239-325)."""
    _, _, _, sumexp_dn, odtot = rad_up_dn(od, t, tz, wn)
    radtmr = torch.sum(sumexp_dn, dim=-1) / (-torch.expm1(-odtot))
    return brightness_temperature(wn, radtmr)


class RTParts(NamedTuple):
    """Outputs of the O(W x L) path-radiance recurrences; the O(W)
    boundary combine runs on the host (combine_boundary_np)."""
    rup: torch.Tensor      # upwelling path radiance   [..., nwn]
    rdn: torch.Tensor      # downwelling path radiance [..., nwn]
    trtot: torch.Tensor    # total transmittance       [..., nwn]
    radtmr: torch.Tensor   # mean-radiating-temperature radiance [..., nwn]


def rt_parts(od, t, tz, wn) -> RTParts:
    """The layer-recurrence half of rtm: everything that needs the
    [..., W, L] optical depths, so that only O(W) arrays leave the
    device in the pipeline."""
    rup, rdn, trtot, sumexp_dn, odtot = rad_up_dn(od, t, tz, wn)
    radtmr = torch.sum(sumexp_dn, dim=-1) / (-torch.expm1(-odtot))
    return RTParts(rup=rup, rdn=rdn, trtot=trtot, radtmr=radtmr)


def combine_boundary_np(wn, rup, rdn, trtot, radtmr, tsfc, emis, refl,
                        irt: int, dtype=None, tsky: float = c.TSKY):
    """Boundary combine + Planck inversions in host NumPy.

    A copy of `monortm_tpu.models.rt.combine_boundary_np`: rtm()'s tail
    (RTMmono.f90:113-155) on the O(W) arrays the pipeline pulls to the
    host anyway, one NumPy program whatever device made them.

    Returns (rad, tb, tmr) as numpy arrays in `dtype` (default: the
    dtype of rup).
    """
    dt = np.dtype(dtype or np.asarray(rup).dtype)
    wn = np.asarray(wn, dt)
    rup = np.asarray(rup, dt)
    rdn = np.asarray(rdn, dt)
    trtot = np.asarray(trtot, dt)
    radtmr = np.asarray(radtmr, dt)

    def planck_np(t):
        t = np.asarray(t, dt)
        return (dt.type(c.RADCN1) * wn ** 3
                / np.expm1(wn * (dt.type(c.RADCN2) / t)))

    def tb_np(rad):
        x = dt.type(c.RADCN1) * wn ** 3 / rad
        return dt.type(c.RADCN2) * wn / np.log1p(x)

    if irt in (2, 3):
        tsfc = tsky
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        # T=0 boundaries legitimately drive expm1 -> inf -> planck 0,
        # matching the semantics of rtm()
        surfrad = planck_np(tsfc)
        cosmos = planck_np(tsky)
        emis = np.asarray(emis, dt)
        refl = np.asarray(refl, dt)

        if irt == 1:
            rad = rup + trtot * (emis * surfrad
                                 + refl * (rdn + trtot * cosmos))
        elif irt == 2:
            rad = rup + trtot * (rdn + trtot * cosmos)
        elif irt == 3:
            rad = rdn + trtot * cosmos
        else:
            raise ValueError(f"irt must be 1, 2 or 3; got {irt}")
        return rad, tb_np(rad), tb_np(radtmr)
