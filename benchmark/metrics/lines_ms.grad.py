"""The line stage of a retrieval step (TIPS, the LINES prologue, the
line-sum kernel launches, the hybrid gathers and scatter, RFT x W) with
its backward pass, ms per traced step, from the program's `lines` and
`lines.bwd` spans."""

from benchmark.metrics._spans import covered_ms


def read(ctx):
    return covered_ms(ctx, ("lines", "lines.bwd"))
