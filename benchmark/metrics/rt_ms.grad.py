"""The radiative transfer of a retrieval step (`rtm` in
`MonoRTM.forward`) with its backward pass, ms per traced step, from the
program's `rt` and `rt.bwd` spans."""

from benchmark.metrics._spans import covered_ms


def read(ctx):
    return covered_ms(ctx, ("rt", "rt.bwd"))
