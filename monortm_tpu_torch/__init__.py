"""monortm_tpu_torch: the MonoRTM forward model in PyTorch, for NVIDIA Hopper.

A port of `monortm_tpu` (the JAX/Pallas package, which stays the
reference).  The forward pass `models.monortm.MonoRTM.forward` runs the
same stages as the JAX one: TIPS ratios, the LINES prologue, the
block-sparse line sum, the MT_CKD continuum, the TKC cloud OD, the
fixed-order total and the cumsum RT solve.  It is differentiable in every
float field of the layered state (the retrieval adjoint: torch.autograd
on `MonoRTM.tb`).  The line sum and its adjoint are CUDA C++ kernels
written for sm_90a (`csrc/linesum.cu`, `csrc/linesum_bwd.cu`), each with
a plain PyTorch version beside it that serves CPU tensors and the tests.
Models run on the card (`device="cuda"`) unless the caller asks for the
CPU.

This package imports `torch` and never `jax`, nor any module of the JAX
package: it carries its own copies of the host modules it needs
(`constants`, `lines`, the `io` readers and writers, `atmos`, `ops.xsec`,
`data.loader` and its tables, and the native helper's C++ source).
"""

__version__ = "0.1.0"
