"""The device's idle share over the traced pipeline.run calls, %."""

from benchmark.metrics._idle import idle_percent


def read(ctx):
    return idle_percent(ctx)
