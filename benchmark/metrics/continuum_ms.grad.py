"""Continuum and cloud of a retrieval step (`ContinuumPlan`, `od_clw`)
with their backward pass, ms per traced step, from the program's
`continuum` and `continuum.bwd` spans."""

from benchmark.metrics._spans import covered_ms


def read(ctx):
    return covered_ms(ctx, ("continuum", "continuum.bwd"))
