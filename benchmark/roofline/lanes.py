"""The line-sum work that the inputs need, and its bound on the H100.

Lanes are the (layer, line, wavenumber) triples the Fortran's rules
evaluate (benchmark.reference.lines: a line not O2 only within 25 cm^-1,
the speed-dependent Voigt where |wn - nu| <= 100 Doppler widths and zeta
<= 0.99, the mirror term where wn + nu <= 25 or the line is coupled O2),
counted from the inputs: along the sorted grid each mask of a (layer,
line) is an interval of wavenumbers, found by binary search, so no lane is
enumerated.  Nothing here reads the program's plan, tiles or operands.

A layer whose every line has zeta > 0.99 is all Lorentz (the
instantiation without the lane switch); the others take the switch.
Bytes: each input read once and each output written once, float32: per
(layer, line) 7 operands (5 in an all-Lorentz layer), per line 5, per
wavenumber 2 (the grid's two-float split); the forward writes [layer, wn,
molecule], the adjoint reads that cotangent and writes one per operand.
"""

from __future__ import annotations

import torch

from benchmark.roofline import ops as O

N_CLASSES = len(O.FWD_LORENTZ)


def line_class(mol, xg):
    """Row of the operation tables of each line (before the window)."""
    o2, co2, cpl = mol == 7, mol == 2, xg != 0.0
    w = torch.where
    return w(o2, w(cpl, w(xg == -1.0, 0, 1), 2),
             w(co2, w(cpl & ((xg == -1.0) | (xg == -5.0)), 3, 4),
               w(cpl, 5, 6)))


def count(lines, pr, wn, row_chunk: int = 64) -> dict:
    """Lanes of the rows of `pr` (reference LineOD.params) on the sorted
    grid wn [W] (a tensor of the params' dtype): by row (per layer: all
    Lorentz or not) and class, without and with the mirror term, Lorentz
    and SD-Voigt.  Returns dict(lor [R, 8, 2], sd [R, 2], all_lorentz [R])
    of int64 tensors."""
    W = wn.shape[0]
    R, N = pr["xnu"].shape
    cls = line_class(lines.mol, lines.xg)
    o2 = lines.mol == 7
    o2c = o2 & (lines.xg != 0.0)
    lor = torch.zeros((R, N_CLASSES, 2), dtype=torch.int64, device=wn.device)
    sd = torch.zeros((R, 2), dtype=torch.int64, device=wn.device)
    ss = lambda v, right=False: torch.searchsorted(wn, v.contiguous(),
                                                   right=right)
    for r0 in range(0, R, row_chunk):
        rs = slice(r0, min(r0 + row_chunk, R))
        xnu, hwd = pr["xnu"][rs], pr["hwd"][rs]
        on = pr["on"][rs]
        # intervals [a, b) of wavenumber indices
        win = (ss(xnu - 25.0), ss(xnu + 25.0, True))
        full = (torch.zeros_like(win[0]), torch.full_like(win[0], W))
        comp = tuple(torch.where(o2, f, w_) for f, w_ in zip(full, win))
        sdi = (torch.maximum(comp[0], ss(xnu - 100.0 * hwd)),
               torch.minimum(comp[1], ss(xnu + 100.0 * hwd, True)))
        sdi = (sdi[0], torch.where(pr["zeta"][rs] <= 0.99, sdi[1], sdi[0]))
        mir = torch.where(o2c, W, ss(25.0 - xnu, True))
        n = lambda iv: torch.clamp(iv[1] - iv[0], min=0)
        cap = lambda iv: (iv[0], torch.minimum(iv[1], mir))
        both = lambda a, b: (torch.maximum(a[0], b[0]),
                             torch.minimum(a[1], b[1]))
        keep = lambda v: torch.where(on, v, 0)
        n_c, n_c2 = keep(n(comp)), keep(n(cap(comp)))
        n_s, n_s2 = keep(n(sdi)), keep(n(cap(sdi)))
        l1, l2 = n_c - n_c2 - (n_s - n_s2), n_c2 - n_s2
        # uncoupled O2 outside the window: the last row of the tables
        out_o2 = o2 & ~o2c
        w_c, w_c2 = keep(n(win)), keep(n(cap(win)))
        w_s, w_s2 = keep(n(both(sdi, win))), keep(n(cap(both(sdi, win))))
        o1 = torch.where(out_o2, (n_c - w_c) - (n_s - w_s), 0)
        o2_ = torch.where(out_o2, (n_c2 - w_c2) - (n_s2 - w_s2), 0)
        o1 = o1 - o2_
        c = cls.expand_as(l1)
        for k2, v in ((0, l1 - o1), (1, l2 - o2_)):
            lor[rs, :, k2].scatter_add_(1, c, v)
        lor[rs, -1, 0] += o1.sum(1)
        lor[rs, -1, 1] += o2_.sum(1)
        sd[rs, 0] = (n_s - n_s2).sum(1)
        sd[rs, 1] = n_s2.sum(1)
    all_lor = ~((pr["zeta"] <= 0.99) & pr["on"]).any(1)
    return dict(lor=lor, sd=sd, all_lorentz=all_lor)


def bound_s(counts: dict, n_lines: int, n_wn: int, n_mol: int,
            direction: str) -> float:
    """Seconds of the bound, summed over the two instantiations (layers
    with SD-Voigt lanes, all-Lorentz layers): max(ops / PEAK_FLOPS,
    bytes / PEAK_BYTES) each."""
    table, sd_ops = ((O.FWD_LORENTZ, O.FWD_SD) if direction == "fwd"
                     else (O.BWD_LORENTZ, O.BWD_SD))
    per_class = torch.tensor(table, dtype=torch.float64)
    switch = torch.full((N_CLASSES, 1), float(O.SWITCH), dtype=torch.float64)
    if direction == "fwd":
        switch[-1] = 0.0
    lor = counts["lor"].double().cpu()
    sd = counts["sd"].double().cpu()
    all_lor = counts["all_lorentz"].cpu()
    total = 0.0
    for lorentz_rows in (False, True):
        m = all_lor == lorentz_rows
        rows = int(m.sum())
        if not rows:
            continue
        ops_tab = per_class + (0.0 if lorentz_rows else switch)
        ops = float((lor[m] * ops_tab).sum()
                    + (sd[m] * torch.tensor(sd_ops, dtype=torch.float64))
                    .sum())
        per_ln = 5 if lorentz_rows else 7
        nbytes = 4 * (per_ln * rows * n_lines + 5 * n_lines + 2 * n_wn
                      + rows * n_wn * n_mol)
        if direction == "bwd":
            nbytes += 4 * per_ln * rows * n_lines
        total += max(ops / O.PEAK_FLOPS, nbytes / O.PEAK_BYTES)
    return total
