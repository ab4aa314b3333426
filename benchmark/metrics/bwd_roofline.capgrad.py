"""The line-sum adjoint (csrc/linesum_bwd.cu: the sweep and the deferred
pass, both engines) at the capacity envelope: the bound of the work the
traced steps' inputs need over the adjoint kernels' time in the trace,
%."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "bwd", lambda n: "linesum_bwd" in n)
