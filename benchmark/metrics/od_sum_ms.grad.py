"""The fixed-order sum of the molecules' and species' optical depths of
a retrieval step with its backward pass, ms per traced step, from the
program's `od-sum` and `od-sum.bwd` spans."""

from benchmark.metrics._spans import covered_ms


def read(ctx):
    return covered_ms(ctx, ("od-sum", "od-sum.bwd"))
