"""Carrying host (numpy) state across into the port.

The JAX package's `LayerState` holds numpy arrays on the host; a
`PackedCatalog` is numpy too, and the port reads only its fields, so a
catalog of either package serves.
Host-side two-float splits (nu0_hi/nu0_lo, wn_hi/wn_lo) are formed in
float64 numpy by the plan builders and never in torch float32.
"""

from __future__ import annotations

import numpy as np
import torch

from monortm_tpu_torch.types import FIELDS, LayerState


def state_from_numpy(obj, device, dtype: torch.dtype) -> LayerState:
    """Any object with numpy-convertible fields p, t, tz, wkl, wbrodl, clw
    (e.g. `monortm_tpu.types.LayerState`) -> the port's LayerState."""
    return LayerState(**{
        f: torch.as_tensor(np.asarray(getattr(obj, f)), dtype=dtype,
                           device=device)
        for f in FIELDS})
