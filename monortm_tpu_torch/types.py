"""Layered atmospheric state: tensors for the device, numpy for the host.

`LayerState` is the torch counterpart of `monortm_tpu.types.LayerState`:
the same six fields with the same shapes (layer axis last, an optional
leading profile batch axis).  The numpy side (`HostState`, `ProfileMeta`,
`irt_from_angle`) lives in `host_types`, which imports no torch, and is
re-exported here.
"""

from __future__ import annotations

import dataclasses

import torch

# re-exported: the port's modules and its tests import them from here
from monortm_tpu_torch.host_types import HostState, ProfileMeta, irt_from_angle

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
