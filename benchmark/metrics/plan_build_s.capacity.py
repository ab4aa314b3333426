"""The line-sum kernels' plans built in a pipeline.run's model build at
the capacity envelope (`build_plan` twice, `reverse_map` included),
seconds per traced run, from the program's `model-build.plan` span."""

from benchmark.metrics._spans import covered_s


def read(ctx):
    return covered_s(ctx, ("model-build.plan",))
