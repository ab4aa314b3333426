"""monortm_tpu_torch: the MonoRTM forward model in PyTorch, for NVIDIA Hopper.

A port of `monortm_tpu` (the JAX/Pallas package, which stays the
reference).  The forward pass `models.monortm.MonoRTM.forward` runs the
same stages as the JAX one: TIPS ratios, the LINES prologue, the
block-sparse line sum, the MT_CKD continuum, the TKC cloud OD, the
fixed-order total and the cumsum RT solve.  The line sum is a CUDA C++
kernel written for sm_90a (`csrc/linesum.cu`), with a plain PyTorch
version beside it that serves CPU tensors and the tests.

This package imports `torch` and never `jax`; from the JAX package it
uses only the jax-free host modules (constants, lines, io.tape3,
data.loader).
"""

__version__ = "0.1.0"
