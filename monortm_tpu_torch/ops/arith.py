"""Arithmetic helpers that keep the JAX package's rounding."""

from __future__ import annotations

import torch


def rdiv(num: float, x):
    """num / x rounded once.  PyTorch evaluates `float / tensor` as
    reciprocal(x) * num, two roundings, where JAX divides once; exp and
    pow downstream of such a quotient amplify the difference."""
    return torch.full_like(x, num) / x if torch.is_tensor(x) else num / x
