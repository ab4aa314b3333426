"""The LINES prologue: every O(layer x line) quantity of the line sum.

Port of `monortm_tpu.ops.lineshape`'s `LineConfig`, `catalog_to_host`,
`_coupling_coeffs` and `line_params` (modm.f90:301-380, 442-454,
833-865): intensities, Lorentz/Doppler halfwidths, line-coupling Y/G
slopes and the IBRD=1 species-specific broadening.  The dense engine
`line_od_block` is not ported; the block-sparse line sum
(`ops.linesum`) is the port's only line engine.

Precision: the line centre is the host-built two-float split nu0_hi +
nu0_lo (formed in float64 numpy, never in torch float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.lines import PackedCatalog

DELTNU_CUT = 25.0
TEMPLC = (200.0, 250.0, 296.0, 340.0)
MOL_CO2 = 2
MOL_O2 = 7


@dataclass(frozen=True)
class LineConfig:
    """Driver knobs hardcoded in monortm.f90:285-289.

    chi_fn: optional CO2 sub-Lorentzian form-factor hook (modm.f90:1253-1290,
    identity in the reference).  It receives deltXNU = wn - nu [..., W, N]
    and returns a factor applied to every CO2 SLS branch.  The plain line
    sums honour it; the CUDA kernel cannot call a Python function and
    raises NotImplementedError when it is set."""
    sclcpl: float = 1.0
    sclhw: float = 1.0
    y0res: float = 0.0
    ibrd: int = 0
    chi_fn: object = None


def catalog_to_host(cat: PackedCatalog) -> dict:
    """Packed catalog columns as host float32 numpy arrays, with the line
    centre as its two-float split (the JAX package's layout for float32)."""
    f = lambda a: np.asarray(a, np.float32)
    return {
        "mol": np.asarray(cat.mol, np.int32),
        "iso_flat": np.asarray(cat.iso_flat, np.int32),
        "s0adj": f(cat.s0adj),
        "e": f(cat.e),
        "alpf": f(cat.alpf),
        "alps": f(cat.alps),
        "tdep": f(cat.tdep),
        "pshift": f(cat.pshift),
        "sdep": f(cat.sdep),
        "mass": f(cat.mass),
        "xg": np.asarray(cat.xg, np.int32),
        "a1": f(cat.a1), "b1": f(cat.b1), "a2": f(cat.a2), "b2": f(cat.b2),
        "self_mix": np.asarray(cat.self_mix),
        "valid": np.asarray(cat.valid),
        "brd_flg": np.asarray(cat.brd_flg, np.int32),
        "brd_hw": f(cat.brd_hw),
        "brd_tmp": f(cat.brd_tmp),
        "brd_shft": f(cat.brd_shft),
        "nu0_hi": f(cat.nu0_hi),
        "nu0_lo": f(cat.nu0_lo),
    }


def catalog_to_device(host_cat: dict, device) -> dict:
    """Host catalog columns -> tensors on `device` (index columns int64)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in host_cat.items()}
    for k in ("mol", "iso_flat", "brd_flg"):
        out[k] = out[k].to(torch.int64)
    return out


def _coupling_coeffs(cat, t, rhorat, rho_mol, cfg: LineConfig):
    """AIP/BIP per (layer, line): TEMPLC interval interpolation + -5 mixing
    + SCLCPL/SCLHW scaling (modm.f90:305-368).

    t: [...], rhorat: [...], rho_mol: [..., N].  Returns (aip, bip) [..., N].
    """
    t = t[..., None]
    templc = torch.tensor(TEMPLC, dtype=t.dtype, device=t.device)
    # ILC: first interval with T < TEMPLC(ilc+1), clamped to 3 (1-based)
    ilc = torch.clamp(torch.searchsorted(templc[1:], t[..., 0].contiguous(),
                                         right=True), 0, 2)[..., None]
    rectlc = 1.0 / (templc[ilc + 1] - templc[ilc])
    tmpdif = t - templc[ilc]

    rho_for = (rhorat[..., None] - rho_mol) / rhorat[..., None]
    rho_sel = rho_mol / rhorat[..., None]
    mix = cat["self_mix"]

    def interp(coef):
        c0, c1, c2, c3 = (coef[..., k] for k in range(4))
        lo = torch.where(ilc == 0, c0, torch.where(ilc == 1, c1, c2))
        hi = torch.where(ilc == 0, c1, torch.where(ilc == 1, c2, c3))
        return lo + (hi - lo) * rectlc[..., 0:1] * tmpdif[..., 0:1]

    # interp is linear in the coefficients, so the -5 self/foreign
    # density mixing commutes with the temperature interpolation
    a1i, b1i = interp(cat["a1"]), interp(cat["b1"])
    aip = torch.where(mix, rho_for * a1i + rho_sel * interp(cat["a2"]), a1i)
    bip = torch.where(mix, rho_for * b1i + rho_sel * interp(cat["b2"]), b1i)

    xg = cat["xg"]
    aip = torch.where(xg == -1, aip * cfg.sclcpl + cfg.y0res, aip)
    bip = torch.where(xg == -1, bip * cfg.sclcpl + cfg.y0res, bip)
    aip = torch.where(xg == -3, aip * cfg.sclhw, aip)
    bip = torch.where(xg == -3, bip * cfg.sclhw, bip)
    return aip, bip


def line_params(cat: dict, p, t, wk, wbrod, scor_flat, cfg: LineConfig,
                dtype: torch.dtype = torch.float32) -> dict:
    """All O(layer x line) quantities of the LINES prologue.

    INITI + LINES preamble + INTENS + HALFWHM_C/_D (modm.f90:301-314,
    375-380, 833-865, 442-454) including line coupling (AIP/BIP) and the
    IBRD=1 adjustments.

    cat: device catalog (`catalog_to_device`); p,t: [...] layer pressure
    (hPa) / temperature (K); wk: [..., 39]; wbrod: [...]; scor_flat:
    [..., 351].  Returns a dict of [..., N] tensors plus the per-layer
    scalars (rhorat, rp, rp2, wtot).
    """
    t_ = t.to(dtype)
    p_ = p.to(dtype)
    wk = wk.to(dtype)
    wbrod_ = wbrod.to(dtype)

    # INITI (modm.f90:868-883) + LINES preamble (modm.f90:301-314)
    xn0 = (1013.25 / (cst.BOLTZ * cst.T0)) * 1.0e3
    xn = (p_ / (cst.BOLTZ * t_)) * 1.0e3
    rhorat = xn / xn0
    wtot = torch.sum(wk, dim=-1) + wbrod_
    rp = p_ / 1013.25
    rp2 = rp * rp
    rt = t_ / cst.T0

    mol = cat["mol"]
    w_line = wk[..., mol - 1]                                 # [..., N]
    rho_mol = rhorat[..., None] * w_line / wtot[..., None]

    aip, bip = _coupling_coeffs(cat, t_, rhorat, rho_mol, cfg)

    # pressure-shifted centre (modm.f90:375) with the optional
    # species-specific-broadening shift adjustment (modm.f90:377-380)
    shift = cat["pshift"] * rhorat[..., None]                 # [..., N]
    if cfg.ibrd != 0:
        rho7 = rhorat[..., None] * wk[..., :7] / wtot[..., None]  # [..., 7]
        brd_on = (mol <= 7)[..., None].to(shift.dtype)
        dshift = torch.einsum("...j,nj->...n", rho7,
                              cat["brd_flg"].to(shift.dtype)
                              * (cat["brd_shft"] - cat["pshift"][:, None]))
        shift = shift + brd_on[..., 0] * dshift
    xnu = cat["nu0_hi"].to(dtype) + (cat["nu0_lo"].to(dtype) + shift)

    # intensity (INTENS, modm.f90:860-865)
    scor_line = scor_flat[..., cat["iso_flat"]]               # [..., N]
    s = cat["s0adj"] * torch.exp(-cst.RADCT * cat["e"]
                                 * (1.0 / t_[..., None] - 1.0 / cst.T0)) \
        * scor_line
    stild = s * (1.0 + torch.exp(-cst.RADCT * xnu / t_[..., None])) / (
        xnu * (-torch.expm1(-cst.RADCT * xnu / cst.T0)))

    # Lorentz halfwidth (HALFWHM_C, modm.f90:833-857; ibrd=0 path)
    rtx = rt[..., None] ** cat["tdep"]
    alfa0 = cat["alpf"] * rtx
    hwhms = cat["alps"] * rtx
    hwhm_c = alfa0 * (rhorat[..., None] - rho_mol) + hwhms * rho_mol
    if cfg.ibrd != 0:
        rho7 = rhorat[..., None] * wk[..., :7] / wtot[..., None]
        flg = cat["brd_flg"].to(hwhm_c.dtype)                 # [N, 7]
        has_brd = (torch.sum(flg, dim=-1) > 0) & (mol <= 7)
        tmpcor = rt[..., None, None] ** cat["brd_tmp"]        # [..., N, 7]
        alfa_tmp = cat["brd_hw"] * tmpcor
        alfsum = torch.einsum("...j,...nj->...n", rho7, flg * alfa_tmp)
        rho_flg = torch.einsum("...j,nj->...n", rho7, flg)
        hw_brd = (rhorat[..., None] - rho_flg) * alfa0 + alfsum
        own_flg = torch.gather(cat["brd_flg"], 1,
                               torch.clamp(mol - 1, 0, 6)[:, None])[:, 0]
        hw_brd = torch.where(own_flg == 0,
                             hw_brd + rho_mol * (hwhms - alfa0), hw_brd)
        hwhm_c = torch.where(has_brd, hw_brd, hwhm_c)
    hwhm_c = torch.where(cat["xg"] == -3,
                         hwhm_c * (1.0 - aip * rp[..., None]
                                   - bip * rp2[..., None]),
                         hwhm_c)

    # Doppler halfwidth (HALFWHM_D, modm.f90:442-454)
    hwhm_d = (xnu / cst.CLIGHT) * torch.sqrt(
        2.0 * cst.LN2 * cst.BOLTZ * t_[..., None] * cst.AVOGAD / cat["mass"])

    return {"shift": shift, "xnu": xnu, "stild": stild, "hwhm_c": hwhm_c,
            "hwhm_d": hwhm_d, "aip": aip, "bip": bip,
            "rhorat": rhorat, "rp": rp, "rp2": rp2, "wtot": wtot}
