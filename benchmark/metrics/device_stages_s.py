"""Model build and device stages of a pipeline.run (model-build,
host->device, engine-predicate, device-dispatch, device->host), seconds
per run on the host clock, synchronisation included, from STAGE TIMING."""

from benchmark.drivers.pipeline import DEVICE_STAGES
from benchmark.metrics._stages import mean_of


def read(ctx):
    return mean_of(ctx, DEVICE_STAGES)
