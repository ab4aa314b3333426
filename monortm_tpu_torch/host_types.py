"""Layered atmospheric state for the host, in numpy, without torch.

`HostState` holds the six fields of `types.LayerState` as numpy arrays
for one profile: what the MONORTM_PROF.IN reader and the layering
produce (`io.profin.Profile.state`) and the pipeline stacks before it
uploads a chunk (`convert.state_from_numpy`).  `ProfileMeta` and
`irt_from_angle` are copies of the JAX package's.  The IATM=1 layering
workers (`atmos.tape5_atm`) build and return these, and import nothing
that imports torch; `types` re-exports all three.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


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
