"""The device's idle share over the traced retrieval steps at the
capacity envelope, %."""

from benchmark.metrics._idle import idle_percent


def read(ctx):
    return idle_percent(ctx)
