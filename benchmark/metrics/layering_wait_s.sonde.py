"""The producer of a streamed IATM=1 pipeline.run waiting on the
layering's worker pool after its start: the `profiles+layering` stage of
STAGE TIMING less the `layering.pool` stage nested in it, seconds per
run of the traced runs (None where no LOG has `layering.pool`)."""

from benchmark.metrics._stages import mean_of

POOL = "layering.pool"


def read(ctx):
    if not any(POOL in t for t in ctx.driver.stages(ctx.steps)):
        return None
    return mean_of(ctx, ("profiles+layering",)) - mean_of(ctx, (POOL,))
