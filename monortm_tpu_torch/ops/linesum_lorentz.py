"""All-Lorentz line sum (the common microwave regime).

Port of `monortm_tpu.ops.linesum_lorentz`.  Where zeta = hwc/(hwc+hwd)
> 0.99 for every line of a layer (modm.f90:419-431) every lane of the full
kernel takes the Lorentz branch, so the sum needs no SD-Voigt machinery.
`all_lorentz_predicate` tests that condition; `LORENTZ_KERNEL` is the
VOIGT=false instantiation of the CUDA kernel `csrc/linesum.cu`, which
replaces the JAX package's `line_od_lorentz_xla` (:63-220), with
`lorentz_sum_plain` as its plain PyTorch version; its adjoint is the
VOIGT=false instantiation of `csrc/linesum_bwd.cu`, with
`lorentz_sum_bwd_plain` beside it.  It runs through
`ops.linesum.line_od_forward(..., kernel=LORENTZ_KERNEL)`.

EXACTNESS: the engine equals the full kernel only where the predicate
holds; callers select it per layer (`models.od.ODModel.engine_split`).
"""

from __future__ import annotations

import numpy as np
import torch

from monortm_tpu_torch.ops.linesum import (PER_LN, _branch_trees,
                                           sweep_bwd_plain, sweep_plain)
from monortm_tpu_torch.ops.linesum_kernel import LineSumKernel
from monortm_tpu_torch.ops.lineshape import (DELTNU_CUT, LineConfig,
                                             line_params)

# f32(1/pi), as the JAX all-Lorentz engine forms it
_INV_PI = float(np.float32(1.0 / np.pi))


def all_lorentz_predicate(cat: dict, p, t, wk, wbrod, scor_flat,
                          cfg: LineConfig, dtype: torch.dtype = torch.float32):
    """Per layer row [...]: zeta > 0.99 for every valid line, the condition
    under which the Lorentz-only engine is exact (modm.f90:427); the JAX
    package's per_layer=True form at margin 0."""
    lp = line_params(cat, p, t, wk, wbrod, scor_flat, cfg, dtype)
    hwc, hwd = lp["hwhm_c"], lp["hwhm_d"]
    zeta_ok = hwc * hwc.new_tensor(0.01) > hwd * hwd.new_tensor(0.99)
    return torch.all(zeta_ok | ~cat["valid"], dim=-1)


def _contrib_lorentz(wn_hi, wn_lo, g, fl, chi_fn):
    """One [L, wt, nt] block of the JAX all-Lorentz sweep (:127-170)."""
    nu_hi, nu_lo = g["nu_hi"], g["nu_lo"]
    shift, hw = g["shift"], g["hw"]
    xnu = nu_hi + (nu_lo + shift)
    d1 = (wn_hi - nu_hi) + (wn_lo - nu_lo) - shift
    dsum = wn_hi + xnu

    mirror = (dsum - DELTNU_CUT) <= 0.0
    within = torch.abs(d1) <= DELTNU_CUT
    keep = (within | fl["o2"]) & fl["valid"]

    # one divide per evaluation (the Lorentz 3-term rational)
    hw_pi = hw * _INV_PI
    hw2 = hw * hw
    k1 = hw_pi / (hw2 + d1 * d1)
    k2 = hw_pi / (hw2 + dsum * dsum)
    k3 = hw_pi / (hw2 + DELTNU_CUT * DELTNU_CUT)

    sls = _branch_trees(d1, dsum, k1, k2, k3, g["ya"], g["yb"], fl, within,
                        mirror, chi_fn)
    return torch.where(keep, sls, 0.0) * g["stild"]


def lorentz_sum_plain(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                      nt: int, wt: int, n_mol: int, chi_fn=None):
    """Plain PyTorch version of the VOIGT=false kernel."""
    return sweep_plain(_contrib_lorentz, pre, mol, wn_hi, wn_lo, cand_map,
                       cand_valid, nt, wt, n_mol, chi_fn)


# the operands the Lorentz sum reads: it never reads ad or k3v
_LORENTZ_WRT = ("shift", "stild", "hw", "ya", "yb")


def lorentz_sum_bwd_plain(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                          nt: int, wt: int, n_mol: int, g, chi_fn=None):
    """Plain PyTorch version of the VOIGT=false adjoint kernel: the seven
    cotangents in PER_LN order, None for ad and k3v."""
    d = sweep_bwd_plain(_contrib_lorentz, pre, mol, wn_hi, wn_lo, cand_map,
                        cand_valid, nt, wt, n_mol, g, chi_fn,
                        wrt=_LORENTZ_WRT)
    return tuple(d.get(k) for k in PER_LN)


LORENTZ_KERNEL = LineSumKernel("lorentz", voigt=False,
                               plain=lorentz_sum_plain,
                               plain_bwd=lorentz_sum_bwd_plain)

