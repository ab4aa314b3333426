"""The start of the IATM=1 layering's worker pool in a streamed
pipeline.run, from the pool's creation to the first profile it yields:
the `layering.pool` stage of STAGE TIMING, seconds per run of the traced
runs (None where no LOG has it)."""

from benchmark.metrics._stages import mean_of

STAGE = "layering.pool"


def read(ctx):
    if not any(STAGE in t for t in ctx.driver.stages(ctx.steps)):
        return None
    return mean_of(ctx, (STAGE,))
