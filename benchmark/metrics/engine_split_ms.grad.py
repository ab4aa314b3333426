"""The engine split of a retrieval step (`ODModel.engine_split`: TIPS,
the all-Lorentz predicate, the verdict's copy to the host), ms per
traced step, from the program's `engine-split` span."""

from benchmark.metrics._spans import covered_ms


def read(ctx):
    return covered_ms(ctx, ("engine-split",))
