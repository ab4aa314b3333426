"""The LINES prologue and the dense line engine.

Port of `monortm_tpu.ops.lineshape`: `LineConfig`, `catalog_to_host`,
`_coupling_coeffs` and `line_params` (modm.f90:301-380, 442-454,
833-865): intensities, Lorentz/Doppler halfwidths, line-coupling Y/G
slopes and the IBRD=1 species-specific broadening; and `line_od_block`,
the dense engine (the JAX package's XLA path, modm.f90:277-831 as masked
selects over [layer, wavenumber, line] blocks), which the port runs at
float64 and, on request, at float32.  The block-sparse line sum
(`ops.linesum`) is the float32 default.

Precision: in float32 the line centre is the host-built two-float split
nu0_hi + nu0_lo (formed in float64 numpy, never in torch float32), and
wavenumber - line-centre differences use it; in float64 the centre is
nu0 itself and the arithmetic is the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.lines import PackedCatalog
from monortm_tpu_torch.ops.arith import rdiv
from monortm_tpu_torch.ops.voigt import sdvoigt, xlorentz

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


def catalog_to_host(cat: PackedCatalog,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Packed catalog columns as host numpy arrays in `dtype`, with the
    line centre as its two-float split in float32 and as nu0 itself in
    float64 (the JAX package's layouts)."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    f = lambda a: np.asarray(a, npdt)
    d = {
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
    }
    if dtype == torch.float64:
        d["nu0"] = np.asarray(cat.nu0, np.float64)
    else:
        d["nu0_hi"] = f(cat.nu0_hi)
        d["nu0_lo"] = f(cat.nu0_lo)
    return d


def catalog_to_device(host_cat: dict, device) -> dict:
    """Host catalog columns -> tensors on `device` (index columns int64)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in host_cat.items()}
    for k in ("mol", "iso_flat", "brd_flg"):
        out[k] = out[k].to(torch.int64)
    return out


def _jsum(a, b):
    """sum_j a[..., j] * b[..., j] over the 7 broadening molecules, in a
    fixed sequential order: the JAX package's einsums, which on the card
    would be matrix products whose summation order (and TF32 use) the
    library picks per shape."""
    out = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        out = out + a[..., j] * b[..., j]
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
        dshift = _jsum(rho7[..., None, :], cat["brd_flg"].to(shift.dtype)
                       * (cat["brd_shft"] - cat["pshift"][:, None]))
        shift = shift + brd_on[..., 0] * dshift
    if dtype == torch.float64:
        xnu = cat["nu0"] + shift
    else:
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
        alfsum = _jsum(rho7[..., None, :], flg * alfa_tmp)
        rho_flg = _jsum(rho7[..., None, :], flg)
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


def line_od_block(cat: dict, wn, wn_split, p, t, wk, wbrod, scor_flat,
                  cfg: LineConfig, n_mol: int,
                  dtype: torch.dtype = torch.float32):
    """Per-molecule line optical depth of one dense block (the JAX
    package's `line_od_block`).

    cat:   device catalog of the block's N lines (`catalog_to_device`)
    wn:    [W] wavenumbers (dtype)
    wn_split: (wn_hi, wn_lo) float32 two-float split, or None in float64
    p,t:   [...] layer pressure (hPa) / temperature (K)
    wk:    [..., 39] molecular columns; wbrod: [...]
    scor_flat: [..., 351] TIPS ratios flattened (39*9)
    returns od_by_mol [..., W, n_mol], the RFT radiation term and the
    column amounts included (modm.f90:436-438).

    The line -> molecule attribution is a product with the one-hot in
    float64 whatever `dtype`, so that TF32 cannot reach it; its
    summation order is the one the library picks for the block's shape,
    which callers keep fixed (`models.od.ODModel`'s dense sweep).
    """
    t_ = t.to(dtype)
    wk = wk.to(dtype)

    lp = line_params(cat, p, t, wk, wbrod, scor_flat, cfg, dtype)
    shift, xnu, stild = lp["shift"], lp["xnu"], lp["stild"]
    hwhm_c, hwhm_d = lp["hwhm_c"], lp["hwhm_d"]
    aip, bip = lp["aip"], lp["bip"]
    rp, rp2 = lp["rp"], lp["rp2"]
    mol = cat["mol"]

    if dtype == torch.float64:
        d1 = wn[..., :, None] - xnu[..., None, :]             # [..., W, N]
    else:
        wn_hi, wn_lo = wn_split
        d0 = ((wn_hi[..., :, None] - cat["nu0_hi"][..., None, :])
              + (wn_lo[..., :, None] - cat["nu0_lo"][..., None, :]))
        d1 = d0 - shift[..., None, :]
    dsum = wn[..., :, None] + xnu[..., None, :]               # wn + nu

    # line-shape selection (modm.f90:419-431)
    zeta = hwhm_c / (hwhm_c + hwhm_d)
    use_lorentz = (torch.abs(d1) > 100.0 * hwhm_d[..., None, :]) | \
        (zeta[..., None, :] > 0.99)

    hw = hwhm_c[..., None, :]
    ad = hwhm_d[..., None, :]
    sdep = cat["sdep"][None, :]

    def K(dd):
        dv = sdvoigt(dd, hw, ad, torch.broadcast_to(sdep, dd.shape))
        dl = xlorentz(dd / hw) / hw
        return torch.where(use_lorentz, dl, dv)

    k1 = K(d1)
    k2 = K(dsum)
    # K3 (pedestal at 25 cm^-1) is wavenumber-independent per line:
    # both kernels once per (layer, line), selected per wavenumber
    d25 = torch.full_like(hwhm_c, DELTNU_CUT)
    k3_v = sdvoigt(d25, hwhm_c, hwhm_d, torch.broadcast_to(cat["sdep"],
                                                            hwhm_c.shape))
    k3_l = xlorentz(d25 / hwhm_c) / hwhm_c
    k3 = torch.where(use_lorentz, k3_l[..., None, :], k3_v[..., None, :])

    # line-coupling Y factors (per wavenumber where needed)
    inv_hw = rdiv(1.0, hw)
    aip_w = aip[..., None, :]
    bip_w = bip[..., None, :]
    rp_w = rp[..., None, None]
    rp2_w = rp2[..., None, None]
    y1 = 1.0 + aip_w * inv_hw * rp_w * d1 + bip_w * rp2_w
    y2 = 1.0 - aip_w * inv_hw * rp_w * dsum + bip_w * rp2_w
    y1p = 1.0 + aip_w * inv_hw * rp_w * DELTNU_CUT + bip_w * rp2_w
    y2p = 1.0 - aip_w * inv_hw * rp_w * DELTNU_CUT + bip_w * rp2_w

    mirror = (dsum - DELTNU_CUT) <= 0.0
    within = torch.abs(d1) <= DELTNU_CUT
    ped = 2.0 - (d1 * d1) / (DELTNU_CUT * DELTNU_CUT)

    xg = cat["xg"][None, :]
    has_cpl = (xg == -1) | (xg == -3) | (xg == -5)
    is_o2 = (mol == MOL_O2)[None, :]
    is_co2 = (mol == MOL_CO2)[None, :]

    # --- LSF branch trees (identical for SD-Voigt and Lorentz after
    #     normalising K; modm.f90:567-831) ---
    sls_other = torch.where(
        has_cpl,
        y1 * k1 - y1p * k3 + torch.where(mirror, y2 * k2 - y2p * k3, 0.0),
        k1 - k3 + torch.where(mirror, k2 - k3, 0.0))

    sls_o2 = torch.where(
        has_cpl,
        torch.where(xg == -1, k1 * y1 + k2 * y2, k1 + k2),
        torch.where(within, k1 + torch.where(mirror, k2, 0.0), 0.0))

    xp4 = k3 * ped
    yp1 = (y1 - 1.0) * ped
    sls_co2 = torch.where(
        has_cpl,
        torch.where((xg == -1) | (xg == -5), k1 * y1 - xp4 - k3 * yp1,
                    k1 - xp4),
        k1 - xp4)
    if cfg.chi_fn is not None:   # CO2 chi hook (modm.f90:507,549,558)
        sls_co2 = sls_co2 * cfg.chi_fn(d1)

    sls = torch.where(is_o2, sls_o2, torch.where(is_co2, sls_co2, sls_other))

    # 25 cm^-1 window cut, applied in LINES before the LSF call for
    # non-O2 molecules (modm.f90:384)
    keep = (within | is_o2) & cat["valid"][None, :]
    contrib = torch.where(keep, sls, 0.0) * stild[..., None, :]

    # per-molecule attribution: one-hot product, in float64
    onehot = ((mol[:, None] - 1) == torch.arange(n_mol, device=mol.device)
              ).to(torch.float64)                             # [N, M]
    sf = torch.matmul(contrib.to(torch.float64), onehot).to(dtype)

    # OD = RFT * W_species * SF (modm.f90:436-438)
    rft = wn * torch.tanh(cst.RADCT * wn / (2.0 * t_[..., None]))
    wk_m = wk[..., :n_mol]
    return rft[..., :, None] * wk_m[..., None, :] * sf
