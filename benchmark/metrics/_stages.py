"""Shared by the readers of MONORTM.LOG's STAGE TIMING: the mean over the
traced runs of the seconds of some stages (None without a LOG)."""


def mean_of(ctx, names) -> float | None:
    tables = ctx.driver.stages(ctx.steps)
    if not tables:
        return None
    return sum(sum(t.get(n, 0.0) for n in names) for t in tables) / len(
        tables)
