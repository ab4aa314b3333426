"""Shared by the readers of the program's own spans: the seconds per
traced step that the host ranges of some names cover in the trace.  The
ranges are merged first, so that a span nested in itself, or in another
of the names, counts once (None where the trace holds none of them)."""


def covered_s(ctx, names) -> float | None:
    iv = sorted((s, e) for s, e, n in ctx.trace.host if n in names)
    if not iv or not ctx.steps:
        return None
    total, (lo, hi) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > hi:
            total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (total + hi - lo) * 1e-6 / ctx.steps


def covered_ms(ctx, names) -> float | None:
    s = covered_s(ctx, names)
    return None if s is None else 1e3 * s
