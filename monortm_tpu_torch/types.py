"""Layered atmospheric state: tensors for the device, numpy for the host.

`LayerState` is the torch counterpart of `monortm_tpu.types.LayerState`:
the same six fields with the same shapes (layer axis last, an optional
leading profile batch axis).  `HostState` holds the same fields as numpy
arrays for one profile: what the MONORTM_PROF.IN reader and the layering
produce (`io.profin.Profile.state`) and the pipeline stacks before it
uploads a chunk (`convert.state_from_numpy`).  `ProfileMeta` and
`irt_from_angle` are copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
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


@dataclasses.dataclass
class HostState:
    """One profile's layered path state as numpy arrays (float64), with
    the shapes of LayerState."""
    p: Any          # [nlay]      layer-average pressure (hPa)
    t: Any          # [nlay]      layer-average temperature (K)
    tz: Any         # [nlay+1]    level temperatures, [0]=surface side
    wkl: Any        # [nlay, 39]  molecular column densities (molec/cm^2)
    wbrodl: Any     # [nlay]      broadening-gas column
    clw: Any        # [nlay]      cloud liquid water (mm)


@dataclasses.dataclass(frozen=True)
class ProfileMeta:
    """Per-profile host-side metadata."""
    nmol: int
    angle: float      # viewing angle (deg); sets IRT (monortm.f90:383-385)
    h1: float = 0.0
    h2: float = 0.0
    altz: np.ndarray | None = None   # [nlay+1] level altitudes (km)
    pz: np.ndarray | None = None     # [nlay+1] level pressures (hPa)

    @property
    def irt(self) -> int:
        return irt_from_angle(self.angle)


def irt_from_angle(angle: float) -> int:
    """1 space-based looking down, 3 ground-based looking up, 2 limb."""
    if angle > 90.0:
        return 1
    if angle < 90.0:
        return 3
    return 2
