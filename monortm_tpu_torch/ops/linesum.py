"""Block-sparse line sum: the port of `monortm_tpu.ops.linesum_pallas`.

`precompute` forms every O(layers x lines) operand of the sum: the
`PROLOGUE_KERNEL` launch (csrc/prologue.cu, one kernel forward and one
entry point backward) for CUDA float32 tensors, and for others
`precompute_plain`, the shared LINES prologue (`ops.lineshape.
line_params`) and the pedestal in eager PyTorch with its autograd;
`precompute_bwd_plain` is the kernel adjoint's closed form in PyTorch.
The per-line operands that do not depend on the state come from
`line_constants`, made once per plan.  `line_od_forward` has the
contract of the JAX `line_od_pallas` (:466-495): the tiled catalog, the
padded wavenumber grid as a host-built two-float split, the candidate map
of line tiles per wavenumber tile, tile sizes nt/wt and a flat layer
axis; it returns sf [L, Wp, n_mol] (callers apply RFT * W and crop the
padding).

The sum runs in `VOIGT_KERNEL`: the CUDA kernel `csrc/linesum.cu` for CUDA
tensors, and for CPU tensors `line_sum_plain`, a loop over wavenumber
tiles x candidate slots evaluating the Pallas `_kernel` math (:143-232)
on [L, wt, nt] blocks.  Its adjoint is the CUDA kernel
`csrc/linesum_bwd.cu` over the reverse candidate map (`reverse_map`), and
for CPU tensors `line_sum_bwd_plain`, the vjp of the same blocks
(`_bwd_kernel`, :328-427).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.ops.arith import rdiv
from monortm_tpu_torch.ops.linesum_kernel import (FLAGS, PER_L, PER_LN,
                                                  LineSumKernel,
                                                  PrologueKernel, flag_bits,
                                                  reverse_map)
from monortm_tpu_torch.ops.lineshape import (DELTNU_CUT, TEMPLC, LineConfig,
                                             MOL_CO2, MOL_O2, line_params)
from monortm_tpu_torch.ops.voigt import sdvoigt, xlorentz
from monortm_tpu_torch.parallel.distributed import shared_input

__all__ = ["FLAGS", "PER_L", "PER_LN", "PROLOGUE_KERNEL", "VOIGT_KERNEL",
           "line_constants", "line_od_forward", "line_sum_bwd_plain",
           "line_sum_plain", "precompute", "precompute_bwd_plain",
           "precompute_plain", "reverse_map"]

# f32(1) / f32(pi), as the Pallas kernel forms it
_INV_PI = float(np.float32(1.0) / np.float32(np.pi))


# the prologue kernels' per-line columns, in the row order of their packed
# [47, N] array (csrc/prologue_math.cuh, Col)
PRO_COLS = ("nu0_hi", "nu0_lo", "pshift", "s0adj", "e", "alpf", "alps",
            "tdep", "mass", "sdep", "a1", "b1", "a2", "b2", "brd_hw",
            "brd_tmp", "brd_shft")
# most lines in one run of the prologue adjoint's per-row sums
RUN_LINES = 1024
# what line_constants hands the line sum beside the seven operands
LINE_CONSTANTS = ("sdep", "nu_hi", "nu_lo", "flags", "bits", "mol0")


def _prologue_pack(cat: dict) -> dict:
    """The prologue kernels' view of a float32 catalog: the columns they
    read, packed [47, N]; one int32 word per line (0-based molecule, flat
    isotopologue << 6, -5 self mixing << 15, xg == -1 << 16, xg == -3 << 17,
    the IBRD molecule flags << 20); and the adjoint's runs: the lines
    sorted stably by flat isotopologue (`perm`) and cut into runs of at
    most RUN_LINES lines of one isotopologue (`runs` int32 [3, n_runs]:
    first index into perm, count, isotopologue)."""
    n = cat["mol"].shape[0]
    cols = torch.cat([cat[k].to(torch.float32).reshape(n, -1)
                      for k in PRO_COLS], dim=1).T.contiguous()
    brd = cat["brd_flg"].to(torch.int64)
    if bool(((brd != 0) & (brd != 1)).any()):
        raise ValueError("brd_flg: the prologue kernels take 0/1 flags")
    word = ((cat["mol"].to(torch.int64) - 1)
            | (cat["iso_flat"].to(torch.int64) << 6)
            | (cat["self_mix"].to(torch.int64) << 15)
            | ((cat["xg"] == -1).to(torch.int64) << 16)
            | ((cat["xg"] == -3).to(torch.int64) << 17))
    for j in range(brd.shape[1]):
        word = word | (brd[:, j] << (20 + j))
    iso = cat["iso_flat"].cpu().numpy()
    perm = np.argsort(iso, kind="stable")
    iso_sorted = iso[perm]
    runs = []
    for v in np.unique(iso_sorted):
        lo, hi = np.searchsorted(iso_sorted, [v, v + 1])
        runs += [(s, min(RUN_LINES, hi - s), v)
                 for s in range(lo, hi, RUN_LINES)]
    dev = cat["mol"].device
    runs = np.asarray(runs, np.int32).reshape(-1, 3).T
    return {"cols": cols, "words": word.to(torch.int32).contiguous(),
            "perm": torch.as_tensor(perm.astype(np.int32), device=dev),
            "runs": torch.as_tensor(np.ascontiguousarray(runs), device=dev)}


def line_constants(cat: dict, dtype: torch.dtype = torch.float32) -> dict:
    """The per-line operands of the line sum that do not depend on the
    state, made once per plan (`models.od.plan_to_device`): sdep, the
    centre's two-float split, the flags, their word for the kernels
    (`bits`, FLAG_BITS) and the 0-based molecule (`mol0`); for float32,
    also the prologue kernels' packed catalog (`pro`)."""
    mol, xg = cat["mol"], cat["xg"]
    f = lambda m: m.to(dtype)
    flags = {
        "o2": f(mol == MOL_O2),
        "co2": f(mol == MOL_CO2),
        "cpl": f((xg == -1) | (xg == -3) | (xg == -5)),
        "xf1": f(xg == -1),
        "xf15": f((xg == -1) | (xg == -5)),
        "valid": f(cat["valid"]),
    }
    out = {"sdep": cat["sdep"].to(dtype), "nu_hi": cat["nu0_hi"].to(dtype),
           "nu_lo": cat["nu0_lo"].to(dtype), "flags": flags,
           "bits": flag_bits(flags),
           "mol0": (mol - 1).to(torch.int32).contiguous()}
    if dtype == torch.float32:
        out["pro"] = _prologue_pack(cat)
    return out


PROLOGUE_KERNEL = PrologueKernel()


def precompute(cat: dict, p, t, wk, wbrod, scor_flat, cfg: LineConfig,
               dtype: torch.dtype = torch.float32, const: dict = None
               ) -> dict:
    """All O(L x N) line parameters and the per-line constants of the line
    sum: through PROLOGUE_KERNEL for CUDA tensors in float32, else
    `precompute_plain`.  const: the catalog's `line_constants` (made here
    when None)."""
    const = line_constants(cat, dtype) if const is None else const
    if p.device.type == "cuda" and dtype == torch.float32:
        c = lambda a: a.to(dtype).contiguous()
        pre = dict(zip(PER_LN, PROLOGUE_KERNEL(
            const["pro"], cfg, c(p), c(t), c(wk), c(wbrod), c(scor_flat))))
    else:
        pre = precompute_plain(cat, p, t, wk, wbrod, scor_flat, cfg, dtype)
    pre.update({k: const[k] for k in LINE_CONSTANTS})
    return pre


def precompute_plain(cat: dict, p, t, wk, wbrod, scor_flat, cfg: LineConfig,
                     dtype: torch.dtype = torch.float32) -> dict:
    """The seven O(L x N) operands (PER_LN) via the shared LINES prologue
    in eager PyTorch: the plain version of the prologue kernel."""
    lp = line_params(cat, p, t, wk, wbrod, scor_flat, cfg, dtype)
    hw, ad = lp["hwhm_c"], lp["hwhm_d"]
    rp, rp2 = lp["rp"], lp["rp2"]

    # pedestal value at 25 cm^-1 for the SD-Voigt branch; the Lorentz
    # branch's k3 is recomputed in the line sum from hw
    sdep_b = torch.broadcast_to(cat["sdep"], hw.shape)
    k3v = sdvoigt(torch.tensor(DELTNU_CUT, dtype=dtype, device=hw.device),
                  hw, ad, sdep_b)

    # line-coupling Y factors: y1 = 1 + ya*d1 + yb, y2 = 1 - ya*dsum + yb
    ya = lp["aip"] * rp[..., None] / hw
    yb = lp["bip"] * rp2[..., None]
    return {"shift": lp["shift"], "stild": lp["stild"], "hw": hw, "ad": ad,
            "k3v": k3v, "ya": ya, "yb": yb}


def _pedestal_partials(hw, ad, sdep):
    """d k3v / d hw and d k3v / d ad of the pedestal sdvoigt(25, hw, ad),
    in float64 and returned in hw's dtype; for float32 operands with
    float32's branch (f32_fallback), as the kernel's sdvoigt<Dual64>."""
    with torch.enable_grad():
        h = hw.detach().double().requires_grad_()
        a = ad.detach().double().requires_grad_()
        v = sdvoigt(torch.tensor(DELTNU_CUT, dtype=torch.float64,
                                 device=hw.device), h, a,
                    torch.broadcast_to(sdep.double(), h.shape),
                    f32_fallback=hw.dtype != torch.float64)
        dh, da = torch.autograd.grad(v.sum(), (h, a))
    return dh.to(hw.dtype), da.to(hw.dtype)


def precompute_bwd_plain(cat: dict, p, t, wk, wbrod, scor_flat,
                         cfg: LineConfig, g, dtype: torch.dtype = torch.float32
                         ):
    """The prologue adjoint's closed form in PyTorch, the readable twin of
    csrc/prologue_math.cuh's pair_adj and row_adj: for the cotangents g
    of the seven operands (PER_LN order, None for zero), the gradients of
    p [L], t [L], wk [L, 39], wbrod [L] and scor_flat [L, 351].  Each
    partial is written out from the forward's operations (line_params,
    precompute_plain); the pedestal's by (hw, ad) from `_pedestal_partials`.
    Sums over lines are PyTorch's; the kernel's order is its own."""
    t_ = t.to(dtype)
    p_ = p.to(dtype)
    wk = wk.to(dtype)
    f = lambda x: x.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=t_.device)
    gs = [zero if v is None else v.to(dtype) for v in g]
    g_shift, g_stild, g_hw, g_ad, g_k3v, g_ya, g_yb = gs
    mol0 = cat["mol"] - 1
    xg1, xg3 = cat["xg"] == -1, cat["xg"] == -3
    mix = cat["self_mix"]

    # the forward's values (line_params + precompute_plain)
    q = t_ * cst.BOLTZ
    u = p_ / q
    rhorat = u * 1.0e3 / ((1013.25 / (cst.BOLTZ * cst.T0)) * 1.0e3)
    rp = p_ / 1013.25
    rp2 = rp * rp
    rt = t_ / cst.T0
    wtot = torch.sum(wk, dim=-1) + wbrod.to(dtype)
    R = lambda x: x[..., None]
    w_line = wk[..., mol0]
    rho_mol = R(rhorat) * w_line / R(wtot)
    templc = torch.tensor(TEMPLC, dtype=dtype, device=t_.device)
    ilc = torch.clamp(torch.searchsorted(templc[1:], t_.contiguous(),
                                         right=True), 0, 2)[..., None]
    rectlc = 1.0 / (templc[ilc + 1] - templc[ilc])
    tmpdif = R(t_) - templc[ilc]

    def interp(coef):
        """coef [N, 4] at t, and its slope in t"""
        c = f(coef).T                                          # [4, N]
        lo, hi = c[ilc[..., 0]], c[ilc[..., 0] + 1]
        return lo + (hi - lo) * rectlc * tmpdif, (hi - lo) * rectlc

    rho_for = (R(rhorat) - rho_mol) / R(rhorat)
    rho_sel = rho_mol / R(rhorat)
    (a1i, da1), (b1i, db1) = interp(cat["a1"]), interp(cat["b1"])
    (a2i, da2), (b2i, db2) = interp(cat["a2"]), interp(cat["b2"])
    aip = torch.where(mix, rho_for * a1i + rho_sel * a2i, a1i)
    bip = torch.where(mix, rho_for * b1i + rho_sel * b2i, b1i)
    aip = torch.where(xg1, aip * cfg.sclcpl + cfg.y0res, aip)
    bip = torch.where(xg1, bip * cfg.sclcpl + cfg.y0res, bip)
    aip = torch.where(xg3, aip * cfg.sclhw, aip)
    bip = torch.where(xg3, bip * cfg.sclhw, bip)

    shift = f(cat["pshift"]) * R(rhorat)
    if cfg.ibrd != 0:
        flg = f(cat["brd_flg"])                                # [N, 7]
        rho7 = R(rhorat) * wk[..., :7] / R(wtot)               # [L, 7]
        term = flg * f(cat["brd_shft"] - cat["pshift"][:, None])
        brd_on = f(mol0 < 7)
        shift = shift + brd_on * (rho7[..., None, :] * term).sum(-1)
    if dtype == torch.float64 and "nu0" in cat:
        xnu = cat["nu0"] + shift
    else:
        xnu = f(cat["nu0_hi"]) + (f(cat["nu0_lo"]) + shift)
    scor_line = scor_flat.to(dtype)[..., cat["iso_flat"]]
    a = f(-cst.RADCT * cat["e"])
    ex = torch.exp(a * (1.0 / R(t_) - 1.0 / cst.T0))
    s1 = f(cat["s0adj"]) * ex
    s = s1 * scor_line
    c1 = -cst.RADCT * xnu / R(t_)
    e1 = torch.exp(c1)
    em = torch.expm1(-cst.RADCT * xnu / cst.T0)
    den = xnu * -em
    stild = s * (1.0 + e1) / den
    rtx = R(rt) ** f(cat["tdep"])
    alfa0 = f(cat["alpf"]) * rtx
    hwhms = f(cat["alps"]) * rtx
    hc = alfa0 * (R(rhorat) - rho_mol) + hwhms * rho_mol
    has_brd = torch.zeros_like(xg1)
    if cfg.ibrd != 0:
        alfa_tmp = f(cat["brd_hw"]) * R(R(rt)) ** f(cat["brd_tmp"])
        rho_flg = (rho7[..., None, :] * flg).sum(-1)
        own0 = torch.gather(cat["brd_flg"], 1,
                            torch.clamp(mol0, 0, 6)[:, None])[:, 0] == 0
        has_brd = (flg.sum(-1) > 0) & (mol0 < 7)
        hw_brd = ((R(rhorat) - rho_flg) * alfa0
                  + (rho7[..., None, :] * flg * alfa_tmp).sum(-1))
        hw_brd = torch.where(own0, hw_brd + rho_mol * (hwhms - alfa0), hw_brd)
        hc = torch.where(has_brd, hw_brd, hc)
    fm3 = 1.0 - aip * R(rp) - bip * R(rp2)
    hw = torch.where(xg3, hc * fm3, hc)
    x_d = xnu / cst.CLIGHT
    y_d = torch.sqrt(2.0 * cst.LN2 * cst.BOLTZ * R(t_) * cst.AVOGAD
                     / f(cat["mass"]))
    ad = x_d * y_d
    ya = aip * R(rp) / hw

    # the adjoint, pair by pair (pair_adj)
    k_dh, k_da = _pedestal_partials(hw, ad, torch.broadcast_to(
        f(cat["sdep"]), hw.shape))
    g_hw = g_hw + g_k3v * k_dh
    g_ad = g_ad + g_k3v * k_da
    t_ya = g_ya / hw
    g_aip, g_bip = t_ya * R(rp), g_yb * R(rp2)
    g_rp, g_rp2 = t_ya * aip, g_yb * bip
    g_hw = g_hw - t_ya * ya
    g_xnu = g_ad * y_d / cst.CLIGHT
    g_t = g_ad * x_d * (0.5 * y_d / R(t_))
    g_hc = torch.where(xg3, g_hw * fm3, g_hw)
    g_f = torch.where(xg3, g_hw * hc, zero)
    g_aip, g_bip = g_aip - g_f * R(rp), g_bip - g_f * R(rp2)
    g_rp, g_rp2 = g_rp - g_f * aip, g_rp2 - g_f * bip
    g_alfa0 = g_hc * (R(rhorat) - rho_mol)
    g_rhorat = g_hc * alfa0
    g_rho_mol = g_hc * (hwhms - alfa0)
    g_hwhms = g_hc * rho_mol
    g_rt = zero
    if cfg.ibrd != 0:
        hb = torch.where(has_brd, g_hc, zero)
        g_alfa0 = torch.where(has_brd, hb * (R(rhorat) - rho_flg), g_alfa0)
        g_rho_mol = torch.where(has_brd, torch.where(
            own0, hb * (hwhms - alfa0), zero), g_rho_mol)
        g_hwhms = torch.where(has_brd, torch.where(own0, hb * rho_mol, zero),
                              g_hwhms)
        g_alfa0 = g_alfa0 - torch.where(has_brd & own0, hb * rho_mol, zero)
        g_rho7 = R(hb) * flg * alfa_tmp - R(hb * alfa0) * flg   # [L, N, 7]
        g_rt = (R(hb) * rho7[..., None, :] * flg * alfa_tmp
                * f(cat["brd_tmp"]) / R(R(rt))).sum(-1)
    g_rtx = g_alfa0 * f(cat["alpf"]) + g_hwhms * f(cat["alps"])
    g_rt = g_rt + g_rtx * f(cat["tdep"]) * rtx / R(rt)
    g_num = g_stild / den
    g_den = -g_num * stild
    g_s = g_num * (e1 + 1.0)
    g_c1 = g_num * s * e1
    g_xnu = g_xnu + g_c1 * -cst.RADCT / R(t_)
    g_t = g_t - g_c1 * c1 / R(t_)
    g_xnu = g_xnu + g_den * -em
    g_xnu = g_xnu - g_den * xnu * (em + 1.0) * -cst.RADCT / cst.T0
    g_scor = g_s * s1
    g_arg = g_s * scor_line * f(cat["s0adj"]) * ex
    g_t = g_t - g_arg * a / R(t_ * t_)
    g_shift = g_shift + g_xnu
    g_rhorat = g_rhorat + g_shift * f(cat["pshift"])
    if cfg.ibrd != 0:
        g_rho7 = g_rho7 + (R(g_shift) * term) * brd_on[:, None]
    g_aip = torch.where(xg3, g_aip * cfg.sclhw, g_aip)
    g_bip = torch.where(xg3, g_bip * cfg.sclhw, g_bip)
    g_aip = torch.where(xg1, g_aip * cfg.sclcpl, g_aip)
    g_bip = torch.where(xg1, g_bip * cfg.sclcpl, g_bip)
    g_for = g_aip * a1i + g_bip * b1i
    g_sel = g_aip * a2i + g_bip * b2i
    g_t = g_t + torch.where(
        mix, g_aip * (rho_for * da1 + rho_sel * da2)
        + g_bip * (rho_for * db1 + rho_sel * db2),
        g_aip * da1 + g_bip * db1)
    g_rhorat = g_rhorat + torch.where(mix, (g_for - g_sel) * rho_sel
                                      / R(rhorat), zero)
    g_rho_mol = g_rho_mol + torch.where(mix, (g_sel - g_for) / R(rhorat),
                                        zero)
    g_t = g_t + g_rt / cst.T0

    # the rows' own chain (row_adj)
    G_rhorat = g_rhorat.sum(-1) + (g_rho_mol * w_line / R(wtot)).sum(-1)
    gw_k = torch.zeros_like(wk).index_add_(
        -1, mol0, g_rho_mol * R(rhorat) / R(wtot))
    g_wtot = -(g_rho_mol * rho_mol / R(wtot)).sum(-1)
    if cfg.ibrd != 0:
        G7 = g_rho7.sum(-2)                                   # [L, 7]
        G_rhorat = G_rhorat + (G7 * wk[..., :7] / R(wtot)).sum(-1)
        gw_k[..., :7] += G7 * R(rhorat) / R(wtot)
        g_wtot = g_wtot - (G7 * rho7 / R(wtot)).sum(-1)
    gw_k = gw_k + R(g_wtot)
    g_sc = torch.zeros_like(scor_flat, dtype=dtype).index_add_(
        -1, cat["iso_flat"], g_scor)
    g_u = G_rhorat * 1.0e3 / ((1013.25 / (cst.BOLTZ * cst.T0)) * 1.0e3)
    G_rp = g_rp.sum(-1) + 2.0 * rp * g_rp2.sum(-1)
    g_p = g_u / q + G_rp / 1013.25
    g_tt = g_t.sum(-1) - g_u * u / q * cst.BOLTZ
    return g_p, g_tt, gw_k, g_wtot, g_sc


def _branch_trees(d1, dsum, k1, k2, k3, ya, yb, fl, within, mirror, chi_fn):
    """The LSF branch trees (modm.f90:567-831) -> sls."""
    y1 = 1.0 + ya * d1 + yb
    y2 = 1.0 - ya * dsum + yb
    y1p = 1.0 + ya * DELTNU_CUT + yb
    y2p = 1.0 - ya * DELTNU_CUT + yb
    ped = 2.0 - (d1 * d1) / (DELTNU_CUT * DELTNU_CUT)
    has_cpl = fl["cpl"]

    sls_other = torch.where(
        has_cpl,
        y1 * k1 - y1p * k3 + torch.where(mirror, y2 * k2 - y2p * k3, 0.0),
        k1 - k3 + torch.where(mirror, k2 - k3, 0.0))
    sls_o2 = torch.where(
        has_cpl,
        torch.where(fl["xf1"], k1 * y1 + k2 * y2, k1 + k2),
        torch.where(within, k1 + torch.where(mirror, k2, 0.0), 0.0))
    xp4 = k3 * ped
    sls_co2 = torch.where(
        has_cpl,
        torch.where(fl["xf15"], k1 * y1 - xp4 - k3 * ((y1 - 1.0) * ped),
                    k1 - xp4),
        k1 - xp4)
    if chi_fn is not None:   # CO2 chi hook (modm.f90:507+)
        sls_co2 = sls_co2 * chi_fn(d1)
    return torch.where(fl["o2"], sls_o2,
                       torch.where(fl["co2"], sls_co2, sls_other))


class _SdVoigt64(torch.autograd.Function):
    """`sdvoigt` of float32 operands whose value is the float32 evaluation
    and whose partials by (deltnu, alphal, alphad) come from a float64
    evaluation on the same operands with float32's branch
    (f32_fallback=True), returned in float32: what the adjoint kernel
    does for an SD-Voigt lane (`Dual64`, csrc/linesum_math.cuh).  In
    float32 the two-point construction cancels near vacuum and its
    partials lose their digits; its value is the forward's, bit for
    bit."""

    @staticmethod
    def forward(ctx, dd, hw, ad, sdep):
        ctx.save_for_backward(dd, hw, ad, sdep)
        return sdvoigt(dd, hw, ad, sdep)

    @staticmethod
    def backward(ctx, g):
        dd, hw, ad, sdep = ctx.saved_tensors
        with torch.enable_grad():
            x = [v.detach().double().requires_grad_() for v in (dd, hw, ad)]
            v = sdvoigt(*x, sdep.double(), f32_fallback=True)
            gx = torch.autograd.grad(v, x, g.double())
        return tuple(d.to(g.dtype) for d in gx) + (None,)


def _lorentz_partials(k, hw):
    """(r, dk/dhw) of a Lorentz shape k = hw/pi / (hw^2 + dd^2) in closed
    form from its value, as the adjoint kernel takes them
    (`lorentz_partials`, csrc/linesum_math.cuh): r = k / (hw/pi) and
    dk/dhw = (1/pi - 2 hw k) r, the bracket rounded once as the kernel's
    fused multiply-add does; dk/ddd = -2 dd k r."""
    hw_pi = hw * _INV_PI
    r = k * torch.where(hw_pi > 0.0, rdiv(1.0, hw_pi), 0.0)
    bracket = (_INV_PI - (2.0 * hw).double() * k.double()).float()
    return r, bracket * r


class _Lorentz(torch.autograd.Function):
    """A Lorentz lane's shape hw/pi / (hw^2 + dd^2) of float32 operands:
    its value as `_contrib_voigt` forms it, bit for bit, and its partials
    in closed form (`_lorentz_partials`).  Float32 reverse mode through
    the divide loses digits where a shape and its pedestal cancel, in the
    wings near 25 cm^-1."""

    @staticmethod
    def forward(ctx, dd, hw):
        k = hw * _INV_PI / (hw * hw + dd * dd)
        ctx.save_for_backward(dd, hw, k)
        return k

    @staticmethod
    def backward(ctx, g):
        dd, hw, k = ctx.saved_tensors
        r, k_dh = _lorentz_partials(k, hw)
        return ((g * (-2.0 * dd * k * r)).sum_to_size(dd.shape),
                (g * k_dh).sum_to_size(hw.shape))


class _Pedestal(torch.autograd.Function):
    """A Lorentz lane's pedestal xlorentz(25/hw)/hw of float32 hw: its
    value as `_contrib_voigt` forms it, bit for bit, and its partial by hw
    in closed form, that of the Lorentz shape at dd = 25 cm^-1 (the same
    function of hw) from the pedestal's value."""

    @staticmethod
    def forward(ctx, hw):
        k3 = xlorentz(rdiv(DELTNU_CUT, hw)) / hw
        ctx.save_for_backward(hw, k3)
        return k3

    @staticmethod
    def backward(ctx, g):
        hw, k3 = ctx.saved_tensors
        return g * _lorentz_partials(k3, hw)[1]


def _contrib_voigt(wn_hi, wn_lo, g, fl, chi_fn, f32_fallback=False,
                   sd64=False):
    """One [L, wt, nt] block of the Pallas `_kernel` (:143-228).
    f32_fallback: see `ops.voigt.sdvoigt`.  sd64: float32 lanes take the
    adjoint kernel's partials, SD-Voigt lanes' in float64 (`_SdVoigt64`)
    and Lorentz lanes' and their pedestal's in closed form (`_Lorentz`,
    `_Pedestal`); values are unchanged."""
    nu_hi, nu_lo, sdep = g["nu_hi"], g["nu_lo"], g["sdep"]
    shift, hw, ad = g["shift"], g["hw"], g["ad"]
    xnu = nu_hi + (nu_lo + shift)
    d1 = (wn_hi - nu_hi) + (wn_lo - nu_lo) - shift
    dsum = wn_hi + xnu

    mirror = (dsum - DELTNU_CUT) <= 0.0
    within = torch.abs(d1) <= DELTNU_CUT
    keep = (within | fl["o2"]) & fl["valid"]

    # Lorentz switch (modm.f90:419-431): far wings or zeta > 0.99
    zlor = hw * float(np.float32(0.01)) > ad * float(np.float32(0.99))
    use_lor = (torch.abs(d1) > 100.0 * ad) | zlor
    kernel_partials = sd64 and hw.dtype == torch.float32
    k3l = (_Pedestal.apply(hw) if kernel_partials
           else xlorentz(rdiv(DELTNU_CUT, hw)) / hw)
    k3 = torch.where(use_lor, k3l, g["k3v"])

    hw_pi = hw * _INV_PI
    pi_hw2 = hw * hw

    def K(dd):
        sdep_b = torch.broadcast_to(sdep, dd.shape)
        if kernel_partials:
            dv = _SdVoigt64.apply(dd, hw, ad, sdep_b)
            lor = _Lorentz.apply(dd, hw)
        else:
            dv = sdvoigt(dd, hw, ad, sdep_b, f32_fallback=f32_fallback)
            lor = hw_pi / (pi_hw2 + dd * dd)
        return torch.where(use_lor, lor, dv)

    sls = _branch_trees(d1, dsum, K(d1), K(dsum), k3, g["ya"], g["yb"], fl,
                        within, mirror, chi_fn)
    return torch.where(keep, sls, 0.0) * g["stild"]


def sweep_plain(contrib, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                nt: int, wt: int, n_mol: int, chi_fn=None):
    """The plain line sum: for each wavenumber tile, walk its valid
    candidate slots in order, evaluate `contrib` on the [L, wt, nt]
    block and contract it with the line -> molecule one-hot, in the
    operands' dtype (float32 on the model's path; float64 operands give
    a reference)."""
    L, n = pre["stild"].shape
    dev, dtype = pre["stild"].device, pre["stild"].dtype
    onehot = ((mol[:, None] - 1) == torch.arange(n_mol, device=dev)
              ).to(dtype)                                     # [N, n_mol]
    cm = cand_map.cpu().numpy()
    cv = cand_valid.cpu().numpy()
    n_wt = cm.shape[0]
    out = torch.zeros((L, n_wt * wt, n_mol), dtype=dtype, device=dev)
    for i in range(n_wt):
        ws = slice(i * wt, (i + 1) * wt)
        wh, wl = wn_hi[ws][None, :, None], wn_lo[ws][None, :, None]
        acc = torch.zeros((L, wt, n_mol), dtype=dtype, device=dev)
        for j in range(cm.shape[1]):
            if not cv[i, j]:
                continue
            sl = slice(int(cm[i, j]) * nt, (int(cm[i, j]) + 1) * nt)
            g = {k: pre[k][sl][None, None, :] for k in PER_L}
            g.update({k: pre[k][:, sl][:, None, :] for k in PER_LN})
            fl = {k: pre["flags"][k][sl][None, None, :] > 0.5 for k in FLAGS}
            acc = acc + torch.matmul(contrib(wh, wl, g, fl, chi_fn),
                                     onehot[sl])
        out[:, ws] = acc
    return out


def sweep_bwd_plain(contrib, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                    nt: int, wt: int, n_mol: int, g, chi_fn=None,
                    wrt=PER_LN):
    """The plain adjoint of `sweep_plain` for a cotangent g [L, Wp, n_mol].

    Walks the same blocks in the same order; each block contracts g's
    tile with the one-hot (gbar = g_tile @ onehot^T, the transpose of the
    forward's attribution), re-evaluates `contrib` under autograd and
    takes its vector-Jacobian product against gbar, as the Pallas
    `_bwd_kernel` does with jax.vjp (:372-427).  Returns the cotangents
    of the operands named in `wrt`, each [L, N], in the operands' dtype
    (float32 on the model's path; float64 operands give a reference)."""
    L, n = pre["stild"].shape
    dev, dtype = pre["stild"].device, pre["stild"].dtype
    onehot = ((mol[:, None] - 1) == torch.arange(n_mol, device=dev)
              ).to(dtype)                                     # [N, n_mol]
    cm = cand_map.cpu().numpy()
    cv = cand_valid.cpu().numpy()
    out = {k: torch.zeros((L, n), dtype=dtype, device=dev) for k in wrt}
    for i in range(cm.shape[0]):
        ws = slice(i * wt, (i + 1) * wt)
        wh, wl = wn_hi[ws][None, :, None], wn_lo[ws][None, :, None]
        for j in range(cm.shape[1]):
            if not cv[i, j]:
                continue
            sl = slice(int(cm[i, j]) * nt, (int(cm[i, j]) + 1) * nt)
            gbar = torch.matmul(g[:, ws], onehot[sl].T)      # [L, wt, nt]
            blk = {k: pre[k][sl][None, None, :] for k in PER_L}
            blk.update({k: pre[k][:, sl][:, None, :].detach()
                        for k in PER_LN})
            fl = {k: pre["flags"][k][sl][None, None, :] > 0.5 for k in FLAGS}
            with torch.enable_grad():
                leaves = [blk[k].requires_grad_() for k in wrt]
                ds = torch.autograd.grad(contrib(wh, wl, blk, fl, chi_fn),
                                         leaves, gbar, allow_unused=True)
            for k, d in zip(wrt, ds):
                if d is not None:
                    out[k][:, sl] += d[:, 0, :]
    return out


def line_sum_plain(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                   nt: int, wt: int, n_mol: int, chi_fn=None):
    """Plain PyTorch version of the VOIGT=true kernel."""
    return sweep_plain(_contrib_voigt, pre, mol, wn_hi, wn_lo, cand_map,
                       cand_valid, nt, wt, n_mol, chi_fn)


def line_sum_bwd_plain(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                       nt: int, wt: int, n_mol: int, g, chi_fn=None,
                       f32_fallback: bool = False):
    """Plain PyTorch version of the VOIGT=true adjoint kernel: the seven
    cotangents (PER_LN order) for a cotangent g [L, Wp, n_mol].  As in the
    kernel, a float32 SD-Voigt lane's partials are taken in float64
    (`_SdVoigt64`) and a Lorentz lane's and its pedestal's in closed form
    from their values (`_Lorentz`, `_Pedestal`).
    f32_fallback: see `ops.voigt.sdvoigt` (for float64 operands, a
    reference of the float32 adjoint)."""
    contrib = functools.partial(_contrib_voigt, f32_fallback=f32_fallback,
                                sd64=True)
    d = sweep_bwd_plain(contrib, pre, mol, wn_hi, wn_lo, cand_map,
                        cand_valid, nt, wt, n_mol, g, chi_fn)
    return tuple(d[k] for k in PER_LN)


VOIGT_KERNEL = LineSumKernel("voigt", voigt=True, plain=line_sum_plain,
                             plain_bwd=line_sum_bwd_plain)


def line_od_forward(tiled_cat: dict, wn_hi, wn_lo, cand_map, cand_valid,
                    nt: int, wt: int, p, t, wk, wbrod, scor_flat,
                    cfg: LineConfig, n_mol: int,
                    kernel: LineSumKernel = VOIGT_KERNEL, rev=None,
                    grad_group=None, const: dict = None):
    """Line shape-function sum sf [L, Wp, n_mol] over a block-sparse plan.

    tiled_cat: device catalog in the tiled line order (nu-sorted windowed
      tiles then O2 tiles, padded), length K*nt.
    wn_hi/wn_lo: [Wp] f32 tensors, the host two-float split of the padded
      wavenumber grid (Wp a multiple of wt).
    cand_map/cand_valid: [n_wt, n_cand] int32 tensors — candidate tile per
      (wn tile, slot) and its validity.
    p/t/wk/wbrod/scor_flat carry a single flat layer axis L, on the same
    device.  `kernel` picks the instantiation (VOIGT_KERNEL, or the
    all-Lorentz one of ops.linesum_lorentz).  rev: the plan's reverse map
    (rev_map, rev_valid) on the device, for the adjoint kernel.

    Differentiable in p, t, wk, wbrod and scor_flat: the sum's backward
    is the adjoint kernel on CUDA tensors and the plain adjoint on CPU
    tensors.  grad_group: on a mesh, the ("wn", "line") process group
    over which the ranks sweep their blocks of one plan; the seven
    cotangent partials are summed over it (linesum_pallas.py:754-810).
    const: the catalog's `line_constants` (the plan's; made here when
    None).
    """
    pre = precompute(tiled_cat, p, t, wk, wbrod, scor_flat, cfg,
                     torch.float32, const)
    pre.update({k: shared_input(pre[k], grad_group) for k in PER_LN})
    return kernel(pre, tiled_cat["mol"], wn_hi, wn_lo, cand_map, cand_valid,
                  nt, wt, n_mol, cfg.chi_fn, rev=rev)
