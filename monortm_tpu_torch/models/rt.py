"""Monochromatic radiative-transfer solver (port of `monortm_tpu.models.rt`).

The reference's up/down layer recurrences (RTMmono.f90:157-221) are
prefix sums, so they run as cumulative sums along the layer axis, batched
over any leading axes.  Every sum and prefix sum over layers is a
sequence of elementwise adds in layer order (`lsum`, `lcumsum`): a CUDA
reduction or scan picks its summation order by the shape of its input,
so `torch.sum` / `torch.cumsum` would make a profile's bits depend on the
number of profiles computed with it (the JAX package pins the same sums
with lax.scan in its pipeline).

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


def lsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over `dim` (the layer axis) in a fixed sequential order
    (elementwise adds round exactly, so the result does not depend on
    shapes or devices)."""
    xm = x.movedim(dim, 0)
    out = torch.zeros_like(xm[0])
    for xl in xm:
        out = out + xl
    return out


def lcumsum(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in a fixed sequential
    order, from the last element down when `reverse`."""
    n = x.shape[-1]
    run, cols = None, []
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        run = x[..., i] if run is None else run + x[..., i]
        cols.append(run)
    return torch.stack(cols[::-1] if reverse else cols, dim=-1)


def _pade(tau):
    return 0.193 * tau + 0.013 * tau * tau


def rad_up_dn(od, t, tz, wn):
    """Up/downwelling path radiances + total transmittance.

    Returns (rup, rdn, trtot, sumexp_dn, odtot); sumexp_dn holds the
    downwelling Beff-weighted terms, whose layer sum rdn is also the
    numerator of the mean radiating temperature.
    """
    wn = wn[..., None]                                   # align with layers
    bb = planck(wn, t)                                   # layer-average
    bba = planck(wn, tz)                                 # levels, nlay+1

    emit = -torch.expm1(-od)                             # 1 - exp(-od)
    pade = _pade(od)
    od_cum = lcumsum(od)
    odtot = od_cum[..., -1]

    # transmittance from the top of layer l to TOA: exp(-sum_{k>l} od_k)
    od_above = lcumsum(od, reverse=True) - od
    # transmittance from the bottom of layer l to the surface
    od_below = od_cum - od
    tr_above = torch.exp(-od_above)
    tr_below = torch.exp(-od_below)

    # upwelling: boundary Planck at the layer's upper level (tz[l])
    beff_up = (bb + pade * bba[..., 1:]) / (1.0 + pade)
    rup = lsum(tr_above * emit * beff_up)

    # downwelling: boundary Planck at the layer's lower level (tz[l-1])
    beff_dn = (bb + pade * bba[..., :-1]) / (1.0 + pade)
    sumexp_dn = tr_below * emit * beff_dn
    rdn = lsum(sumexp_dn)

    trtot = torch.exp(-odtot)
    return rup, rdn, trtot, sumexp_dn, odtot


def rtm(od, t, tz, wn, tsfc, emis, refl, irt: int, tsky: float = c.TSKY):
    """Full radiative transfer: path radiances combined with boundaries.

    irt: 1 = upwelling (space-based), 2 = limb, 3 = downwelling (ground);
    for irt 2 and 3 the surface temperature is the cosmic background
    (RTMmono.f90:113-124).  ref: RTMmono.f90:13-155.
    """
    rup, rdn, trtot, _, odtot = rad_up_dn(od, t, tz, wn)

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
    radtmr = rdn / (-torch.expm1(-odtot))
    tmr = brightness_temperature(wn, radtmr)
    return RTResult(rad=rad, tb=tb, rup=rup, rdn=rdn, trtot=trtot, tmr=tmr)


def calctmr(od, t, tz, wn):
    """Standalone mean radiating temperature (RTMmono.f90:239-325)."""
    _, rdn, _, _, odtot = rad_up_dn(od, t, tz, wn)
    return brightness_temperature(wn, rdn / (-torch.expm1(-odtot)))


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
    rup, rdn, trtot, _, odtot = rad_up_dn(od, t, tz, wn)
    return RTParts(rup=rup, rdn=rdn, trtot=trtot,
                   radtmr=rdn / (-torch.expm1(-odtot)))


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
