"""XINT 4-point regridding as static gather plans.

The host half (`XintPlan`, `build_xint_plan`, `build_xint_plan_points`,
`_trunc`) is a verbatim copy of `monortm_tpu.ops.xint`'s numpy code, so
both packages build identical plans (lblrtm_sub.f90:1-34, with the
Fortran truncation and ONEPL/ONEMI rounding).  `DeviceXintPlan` holds a
plan's indices and weights on one device and applies it: a fixed gather
and weighted sum, scattered with `index_add`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

ONEPL = 1.001
ONEMI = 0.999


@dataclass(frozen=True)
class XintPlan:
    """Static interpolation plan: out[ti] += sum_k w[k] * src[j + k - 1].

    Indices are 0-based into the *padded* source array (2 zeros on each
    side), so gathers can never go out of bounds.
    """
    target_idx: np.ndarray   # [n] 0-based indices into the target grid
    src_idx: np.ndarray      # [n] 0-based index of A(J) in padded source
    weights: np.ndarray      # [n, 4] weights for A(J-1), A(J), A(J+1), A(J+2)
    n_src: int               # unpadded source length
    n_target: int


class DeviceXintPlan:
    """An XintPlan's index and weight arrays on one device."""

    def __init__(self, plan: XintPlan, device):
        self.n_target = plan.n_target
        self.target_idx = torch.as_tensor(plan.target_idx, dtype=torch.int64,
                                          device=device)
        j = torch.as_tensor(plan.src_idx, dtype=torch.int64, device=device)
        self.taps = (j - 1, j, j + 1, j + 2)
        self.weights = torch.as_tensor(plan.weights, dtype=torch.float64,
                                       device=device)

    def gather(self, src):
        """src [..., n_src] -> the interpolated values [..., n]."""
        p = F.pad(src, (2, 2))
        w = self.weights.to(src.dtype)
        j0, j1, j2, j3 = self.taps
        return (p[..., j0] * w[:, 0] + p[..., j1] * w[:, 1]
                + p[..., j2] * w[:, 2] + p[..., j3] * w[:, 3])

    def apply(self, src, out=None):
        """src [..., n_src] -> contributions accumulated on [..., n_target]."""
        if out is None:
            out = src.new_zeros(src.shape[:-1] + (self.n_target,))
        return out.index_add(-1, self.target_idx, self.gather(src))


def _trunc(x: np.ndarray | float) -> np.ndarray:
    return np.trunc(np.asarray(x)).astype(np.int64)


def build_xint_plan(v1a: float, dva: float, n_src: int,
                    vft: float, dvr3: float, n1r3: int, n2r3: int,
                    n_target: int) -> XintPlan:
    """Plan XINT(V1A,V2A,DVA, A, ., VFT, DVR3, R3, N1R3, N2R3).

    n1r3/n2r3 are the reference's 1-based bounds; the plan stores 0-based.
    """
    v2a = v1a + dva * (n_src - 1)
    ilo = int(_trunc((v1a + dva - vft) / dvr3 + 1.0 + ONEMI))
    ilo = max(ilo, n1r3)
    ihi = int(_trunc((v2a - dva - vft) / dvr3 + ONEMI))
    ihi = min(ihi, n2r3)

    if ihi < ilo:
        empty = np.zeros((0,), np.int64)
        return XintPlan(empty, empty, np.zeros((0, 4)), n_src, n_target)

    i = np.arange(ilo, ihi + 1, dtype=np.int64)          # 1-based target index
    vi = vft + dvr3 * (i - 1).astype(np.float64)
    j = _trunc((vi - v1a) / dva + ONEPL)                 # 1-based source index
    vj = v1a + dva * (j - 1).astype(np.float64)
    p = (vi - vj) / dva
    cc = (3.0 - 2.0 * p) * p * p
    b = 0.5 * p * (1.0 - p)
    b1 = b * (1.0 - p)
    b2 = b * p
    w = np.stack([-b1, 1.0 - cc + b2, cc + b1, -b2], axis=-1)
    # 0-based target; 0-based padded-source index of A(J) is (j-1) + 2
    return XintPlan(i - 1, j + 1, w, n_src, n_target)


def build_xint_plan_points(v1a: float, dva: float, n_src: int,
                           vi: np.ndarray) -> XintPlan:
    """Per-point XINT as used for explicit wavenumber lists (modm.f90:221-226).

    Each target wavenumber is interpolated independently:
    XINT(..., VFT=wn, DVR3=1.0, R3=oc(iw), N1R3=1, N2R3=1); the ILO/IHI
    bounds then reduce to an in-range test per point.
    """
    vi = np.asarray(vi, dtype=np.float64)
    v2a = v1a + dva * (n_src - 1)
    keep = []
    for k, v in enumerate(vi):
        ilo = int(_trunc((v1a + dva - v) / 1.0 + 1.0 + ONEMI))
        ihi = int(_trunc((v2a - dva - v) / 1.0 + ONEMI))
        if ilo <= 1 and ihi >= 1:
            keep.append(k)
    keep = np.asarray(keep, dtype=np.int64)
    v = vi[keep]
    j = _trunc((v - v1a) / dva + ONEPL)
    vj = v1a + dva * (j - 1).astype(np.float64)
    p = (v - vj) / dva
    cc = (3.0 - 2.0 * p) * p * p
    b = 0.5 * p * (1.0 - p)
    b1 = b * (1.0 - p)
    b2 = b * p
    w = np.stack([-b1, 1.0 - cc + b2, cc + b1, -b2], axis=-1)
    return XintPlan(keep, j + 1, w, n_src, len(vi))
