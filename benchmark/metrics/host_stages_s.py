"""Host stages of a pipeline.run (tape5-parse, line-catalog,
profiles+layering, host-prep, host-stack), seconds per run, from the
STAGE TIMING of the traced runs' MONORTM.LOG."""

from benchmark.drivers.pipeline import HOST_STAGES
from benchmark.metrics._stages import mean_of


def read(ctx):
    return mean_of(ctx, HOST_STAGES)
