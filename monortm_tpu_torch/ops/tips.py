"""TIPS-2003 total internal partition sums — vectorized Lagrange recall.

Port of `monortm_tpu.ops.tips`: every (molecule, isotopologue) table
stacked into one dense [39, 9, 119] tensor and interpolated at once.
Special cases as in the reference: atomic O (mol 34) and untabulated
slots give ratio 1; CH3OH (mol 39) uses the literal 'qt_296 = 296.'
numerator (tips_2003.f90:258-266).
"""

from __future__ import annotations

import torch

from monortm_tpu_torch.data import loader
from monortm_tpu_torch.ops.arith import rdiv


def _lagrange_q(t, tdat, q):
    """Q(t) for every (mol, iso) table: t [...] -> [..., 39, 9]."""
    npt = tdat.shape[0]
    # first index k (0-based) with tdat[k] >= t (AtoB's 'I', 1-based I=k+1)
    h = tdat[1] - tdat[0]              # uniform 25 K grid
    k = torch.ceil((t - tdat[0]) / h).to(torch.int64)
    k = torch.clamp(k, 1, npt - 1)

    use3 = (k < 2) | (k == npt - 1)    # AtoB: I<3 or I==npt -> 3-point
    j3 = torch.where(k < 2, 2, npt - 1)

    def wgt3(j):
        a0_, a1_, a2_ = tdat[j - 2], tdat[j - 1], tdat[j]
        w0 = (t - a1_) * (t - a2_) / ((a0_ - a1_) * (a0_ - a2_))
        w1 = (t - a0_) * (t - a2_) / ((a1_ - a0_) * (a1_ - a2_))
        w2 = (t - a0_) * (t - a1_) / ((a2_ - a0_) * (a2_ - a1_))
        return w0, w1, w2

    def wgt4(j):
        # j + 1 clamped as JAX clamps out-of-range gathers; those lanes take
        # the 3-point weights anyway
        a0_, a1_, a2_ = tdat[j - 2], tdat[j - 1], tdat[j]
        a3_ = tdat[torch.clamp_max(j + 1, npt - 1)]
        w0 = (t - a1_) * (t - a2_) * (t - a3_) / (
            (a0_ - a1_) * (a0_ - a2_) * (a0_ - a3_))
        w1 = (t - a0_) * (t - a2_) * (t - a3_) / (
            (a1_ - a0_) * (a1_ - a2_) * (a1_ - a3_))
        w2 = (t - a0_) * (t - a1_) * (t - a3_) / (
            (a2_ - a0_) * (a2_ - a1_) * (a2_ - a3_))
        w3 = (t - a0_) * (t - a1_) * (t - a2_) / (
            (a3_ - a0_) * (a3_ - a1_) * (a3_ - a2_))
        return w0, w1, w2, w3

    w3_0, w3_1, w3_2 = wgt3(j3)
    w4_0, w4_1, w4_2, w4_3 = wgt4(k)

    base = torch.where(use3, j3, k)
    w0 = torch.where(use3, w3_0, w4_0)
    w1 = torch.where(use3, w3_1, w4_1)
    w2 = torch.where(use3, w3_2, w4_2)
    w3 = torch.where(use3, 0.0, w4_3)

    # gather q at base-2 .. base+1, batch axes of t in front of (mol, iso)
    def gq(idx):
        g = q[..., idx]                       # [39, 9, ...batch]
        if idx.ndim:
            g = torch.movedim(g, tuple(range(-idx.ndim, 0)),
                              tuple(range(idx.ndim)))
        return g

    return (w0[..., None, None] * gq(base - 2)
            + w1[..., None, None] * gq(base - 1)
            + w2[..., None, None] * gq(base)
            + w3[..., None, None] * gq(torch.clamp_max(base + 1, npt - 1)))


class Tips:
    """The TIPS tables on one device, in one dtype."""

    def __init__(self, device, dtype: torch.dtype):
        tabs = loader.tips_tables()
        self.dtype = dtype
        self.tdat = torch.as_tensor(tabs["tdat"], dtype=dtype, device=device)
        self.q = torch.as_tensor(tabs["q"], dtype=dtype, device=device)
        # static [39, 9] mask of tabulated slots
        self.present = torch.as_tensor(tabs["q"][..., 0] > 0.0,
                                       device=device)
        self.q296 = _lagrange_q(torch.tensor(296.0, dtype=dtype,
                                             device=device),
                                self.tdat, self.q)

    def scor(self, t):
        """Intensity temperature correction scor[mol, iso] = Q(296)/Q(T).

        t: [...] layer temperatures (K).  Returns [..., 39, 9].
        ref: tips_2003.f90:60-292 (scor), modm.f90:250,387.
        """
        t = t.to(self.dtype)
        qt = _lagrange_q(t, self.tdat, self.q)
        ratio = torch.where(self.present,
                            self.q296 / torch.where(qt > 0, qt, 1.0), 1.0)
        # CH3OH (mol 39): the reference uses qt_296 = 296. literally
        ch3oh = rdiv(296.0, (t[..., None] / 296.0) ** 1.5)
        ratio[..., 38, :] = ch3oh
        return ratio


def tips_scor(t, dtype: torch.dtype = torch.float32):
    """One-off `Tips(t.device, dtype).scor(t)`."""
    return Tips(t.device, dtype).scor(t)
