"""The writer (`io/output.py`'s OutputWriter) at the capacity envelope:
the `output` stage of STAGE TIMING, seconds per run of the traced runs."""

from benchmark.metrics._stages import mean_of


def read(ctx):
    return mean_of(ctx, ("output",))
