"""Block-sparse line sum: the port of `monortm_tpu.ops.linesum_pallas`.

`precompute` forms every O(layers x lines) operand through the shared
LINES prologue (`ops.lineshape.line_params`).  `line_od_forward` has the
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

from monortm_tpu_torch.ops.arith import rdiv
from monortm_tpu_torch.ops.linesum_kernel import (FLAGS, PER_L, PER_LN,
                                                  LineSumKernel, reverse_map)
from monortm_tpu_torch.ops.lineshape import (DELTNU_CUT, LineConfig,
                                             MOL_CO2, MOL_O2, line_params)
from monortm_tpu_torch.ops.voigt import sdvoigt, xlorentz

__all__ = ["FLAGS", "PER_L", "PER_LN", "VOIGT_KERNEL", "line_od_forward",
           "line_sum_bwd_plain", "line_sum_plain", "precompute",
           "reverse_map"]

# f32(1) / f32(pi), as the Pallas kernel forms it
_INV_PI = float(np.float32(1.0) / np.float32(np.pi))


def precompute(cat: dict, p, t, wk, wbrod, scor_flat, cfg: LineConfig,
               dtype: torch.dtype = torch.float32) -> dict:
    """All O(L x N) line parameters, via the shared LINES prologue."""
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

    xg = cat["xg"]
    mol = cat["mol"]
    f = lambda m: m.to(dtype)
    flags = {
        "o2": f(mol == MOL_O2),
        "co2": f(mol == MOL_CO2),
        "cpl": f((xg == -1) | (xg == -3) | (xg == -5)),
        "xf1": f(xg == -1),
        "xf15": f((xg == -1) | (xg == -5)),
        "valid": f(cat["valid"]),
    }
    return {
        "shift": lp["shift"], "stild": lp["stild"], "hw": hw, "ad": ad,
        "k3v": k3v, "ya": ya, "yb": yb,
        "sdep": cat["sdep"].to(dtype),
        "nu_hi": cat["nu0_hi"].to(dtype),
        "nu_lo": cat["nu0_lo"].to(dtype),
        "flags": flags,
    }


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


def _contrib_voigt(wn_hi, wn_lo, g, fl, chi_fn, f32_fallback=False,
                   sd64=False):
    """One [L, wt, nt] block of the Pallas `_kernel` (:143-228).
    f32_fallback: see `ops.voigt.sdvoigt`.  sd64: float32 SD-Voigt lanes
    take their partials in float64 (`_SdVoigt64`); values are
    unchanged."""
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
    k3l = xlorentz(rdiv(DELTNU_CUT, hw)) / hw
    k3 = torch.where(use_lor, k3l, g["k3v"])

    hw_pi = hw * _INV_PI
    pi_hw2 = hw * hw

    def K(dd):
        sdep_b = torch.broadcast_to(sdep, dd.shape)
        if sd64 and dd.dtype == torch.float32:
            dv = _SdVoigt64.apply(dd, hw, ad, sdep_b)
        else:
            dv = sdvoigt(dd, hw, ad, sdep_b, f32_fallback=f32_fallback)
        return torch.where(use_lor, hw_pi / (pi_hw2 + dd * dd), dv)

    sls = _branch_trees(d1, dsum, K(d1), K(dsum), k3, g["ya"], g["yb"], fl,
                        within, mirror, chi_fn)
    return torch.where(keep, sls, 0.0) * g["stild"]


def sweep_plain(contrib, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                nt: int, wt: int, n_mol: int, chi_fn=None):
    """The plain line sum: for each wavenumber tile, walk its valid
    candidate slots in order, evaluate `contrib` on the [L, wt, nt]
    block and contract it with the line -> molecule one-hot."""
    L, n = pre["stild"].shape
    dev = pre["stild"].device
    onehot = ((mol[:, None] - 1) == torch.arange(n_mol, device=dev)
              ).to(torch.float32)                             # [N, n_mol]
    cm = cand_map.cpu().numpy()
    cv = cand_valid.cpu().numpy()
    n_wt = cm.shape[0]
    out = torch.zeros((L, n_wt * wt, n_mol), dtype=torch.float32, device=dev)
    for i in range(n_wt):
        ws = slice(i * wt, (i + 1) * wt)
        wh, wl = wn_hi[ws][None, :, None], wn_lo[ws][None, :, None]
        acc = torch.zeros((L, wt, n_mol), dtype=torch.float32, device=dev)
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
    (`_SdVoigt64`); the Lorentz lanes' are float32 reverse mode.
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
                    kernel: LineSumKernel = VOIGT_KERNEL, rev=None):
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
    tensors.
    """
    pre = precompute(tiled_cat, p, t, wk, wbrod, scor_flat, cfg,
                     torch.float32)
    return kernel(pre, tiled_cat["mol"], wn_hi, wn_lo, cand_map, cand_valid,
                  nt, wt, n_mol, cfg.chi_fn, rev=rev)
