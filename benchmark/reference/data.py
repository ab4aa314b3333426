"""The reference's constants and data tables.

Literals from PhysConstants.f90 and the MonoRTM sources named beside
each; the tables are a byte copy of the MT_CKD, TIPS_2003 and isotope
tables (`tables/*.npz`, extracted from the Fortran DATA statements of
contnm.f90, tips_2003.f90 and isotope.incl).
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np

TABLES = Path(__file__).resolve().parent / "tables"

PLANCK = 6.62606876e-27          # PhysConstants.f90
BOLTZ = 1.3806503e-16
CLIGHT = 2.99792458e+10
AVOGAD = 6.02214199e+23
RADCN1 = 1.191042722e-12
RADCN2 = 1.4387752
RADCT = PLANCK * CLIGHT / BOLTZ
T0 = 296.0                       # line parameters' temperature
P0 = 1013.25                     # modm.f90:876
TSKY = 2.75                      # RTMmono.f90:111
LN2 = math.log(2.0)

# HITRAN ids 1..39 -> TIPS table key (tips_2003.f90:68-267)
MOLECULES = (
    "h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "no", "so2", "no2",
    "nh3", "hno3", "oh", "hf", "hcl", "hbr", "hi", "clo", "ocs", "h2co",
    "hocl", "n2", "hcn", "ch3cl", "h2o2", "c2h2", "c2h6", "ph3", "cof2",
    "sf6", "h2s", "hcooh", "ho2", "o", "clono2", "nop", "hobr", "c2h4",
    "ch3oh")


@functools.lru_cache(maxsize=None)
def table(name: str) -> dict:
    with np.load(TABLES / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def tips_q(mol: int, iso: int):
    """(tdat, Q(tdat)) of molecule `mol`, isotope `iso` (1-based), or
    None where TIPS tabulates none."""
    raw = table("tips")
    key = f"q_{MOLECULES[mol - 1]}"
    if key not in raw or iso > raw[key].shape[0]:
        return None
    q = raw[key][iso - 1].astype(np.float64)
    return (raw["tdat"].astype(np.float64), q) if np.any(q) else None


def smass(mol: int, iso: int) -> float:
    """Isotope mass (isotope.incl SMASS); the first isotope's where the
    isotope's is not positive (modm.f90)."""
    m = table("isotopes")["smass"]
    v = float(m[mol - 1, min(max(iso, 1), 9) - 1])
    return v if v > 0 else float(m[mol - 1, 0])
