"""The pipeline's consumer waiting on its producer thread (the profiles'
prep and stacking) for the next chunk: the `queue-wait` stage of STAGE
TIMING, seconds per run of the traced runs (None where no LOG has it)."""

from benchmark.metrics._stages import mean_of

STAGE = "queue-wait"


def read(ctx):
    if not any(STAGE in t for t in ctx.driver.stages(ctx.steps)):
        return None
    return mean_of(ctx, (STAGE,))
