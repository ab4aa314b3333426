"""The forward line-sum kernel (csrc/linesum.cu, VOIGT=true and false):
the bound of the work the traced runs' inputs need over the kernel's time
in the trace, %."""

from benchmark.metrics._roofline import share


def read(ctx):
    return share(ctx, "fwd", lambda n: "linesum_kernel" in n)
