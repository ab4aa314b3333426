"""CUDA kernels launched per value_and_grad step: the traced window's
kernels over its steps (the profiler's count)."""


def read(ctx):
    n = ctx.trace.kernels()
    return n / ctx.steps if ctx.steps and n else None
