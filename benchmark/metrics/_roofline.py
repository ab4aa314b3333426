"""Shared by the roofline readers: the line-sum kernels' bound, from the
lanes the traced steps' inputs need (benchmark.roofline), over their
time by name in the trace, %."""

import numpy as np
import torch

from benchmark.reference.lines import LineOD, catalog
from benchmark.roofline.lanes import bound_s, count


def share(ctx, direction: str, match) -> float | None:
    t = ctx.trace.kernel_s(match)
    if t <= 0:
        return None
    dev, dt = ctx.ref_device, torch.float64
    bound, lines = 0.0, None
    for raw, wn, profs in ctx.driver.roofline_inputs(ctx.steps):
        if lines is None:
            lines = LineOD(catalog(raw, float(wn[0]), float(wn[-1])), dev,
                           dt)
        T = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        rows = {f: T(np.stack([p[f] for p in profs]))
                for f in ("p", "t", "wkl", "wbrodl")}
        B, L = rows["p"].shape
        with torch.no_grad():
            pr = lines.params(rows["p"].reshape(-1), rows["t"].reshape(-1),
                              rows["wkl"].reshape(B * L, -1),
                              rows["wbrodl"].reshape(-1))
            n = count(lines, pr, T(wn))
        bound += bound_s(n, lines.n, len(wn), profs[0]["nmol"], direction)
    return 100.0 * bound / t
