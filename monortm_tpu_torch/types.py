"""Layered atmospheric state as a dataclass of tensors.

The torch counterpart of `monortm_tpu.types.LayerState`: the same six
fields with the same shapes (layer axis last, an optional leading profile
batch axis).
"""

from __future__ import annotations

import dataclasses

import torch

MXMOL = 39
FIELDS = ("p", "t", "tz", "wkl", "wbrodl", "clw")


@dataclasses.dataclass
class LayerState:
    """Layered path state (ref COMMON /PATHD/, monortm.f90:229-230)."""
    p: torch.Tensor        # [..., nlay]      layer-average pressure (hPa)
    t: torch.Tensor        # [..., nlay]      layer-average temperature (K)
    tz: torch.Tensor       # [..., nlay+1]    level temperatures, [0]=surface
    wkl: torch.Tensor      # [..., nlay, 39]  molecular columns (molec/cm^2)
    wbrodl: torch.Tensor   # [..., nlay]      broadening-gas column
    clw: torch.Tensor      # [..., nlay]      cloud liquid water (mm)

    def to(self, device, dtype: torch.dtype) -> "LayerState":
        return LayerState(**{f: getattr(self, f).to(device=device, dtype=dtype)
                             for f in FIELDS})
