"""Load extracted reference data tables as NumPy arrays (host side).

A copy of `monortm_tpu.data.loader`, reading the port's own byte-identical
copy of the tables (`tables/*.npz`, made by tools/extract_tables.py from
the reference Fortran DATA statements: contnm.f90, tips_2003.f90,
isotope.incl).  tests/test_torch_copies.py holds both equal.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

TABLE_DIR = Path(__file__).resolve().parent / "tables"

# HITRAN molecule ids 1..39 -> TIPS table key (tips_2003.f90 dispatch :68-267)
MOLECULE_NAMES = [
    "h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "no", "so2", "no2",
    "nh3", "hno3", "oh", "hf", "hcl", "hbr", "hi", "clo", "ocs", "h2co",
    "hocl", "n2", "hcn", "ch3cl", "h2o2", "c2h2", "c2h6", "ph3", "cof2",
    "sf6", "h2s", "hcooh", "ho2", "o", "clono2", "nop", "hobr", "c2h4",
    "ch3oh",
]

# display names used in MONORTM.OUT header (monortm_sub.F90:586-596)
HMOLC = [
    "H2O", "CO2", "O3", "N2O", "CO", "CH4", "O2", "NO", "SO2", "NO2",
    "NH3", "HNO3", "OH", "HF", "HCL", "HBR", "HI", "CLO", "OCS", "H2CO",
    "HOCL", "N2", "HCN", "CH3CL", "H2O2", "C2H2", "C2H6", "PH3", "COF2",
    "SF6", "H2S", "HCOOH", "HO2", "O+", "ClONO2", "NO+", "HOBr", "C2H4",
    "CH3OH",
]

NMOL = 39
MAX_ISO = 9


@functools.lru_cache(maxsize=None)
def _load(name: str) -> dict[str, np.ndarray]:
    with np.load(TABLE_DIR / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def mt_ckd() -> dict[str, np.ndarray]:
    return _load("mt_ckd")


def isotopes() -> dict[str, np.ndarray]:
    return _load("isotopes")


@functools.lru_cache(maxsize=None)
def tips_tables() -> dict[str, np.ndarray]:
    """Dense TIPS tables: q[mol, iso, 119] Q(T) with Q<=0 marking 'absent'.

    Molecules without tabulated Q (atomic O, id 34; CH3OH, id 39) get
    sentinel values handled analytically in ops.tips (tips_2003.f90:233-267).
    """
    raw = _load("tips")
    tdat = raw["tdat"]
    q = np.zeros((NMOL, MAX_ISO, tdat.size), dtype=np.float64)
    gj = np.zeros((NMOL, MAX_ISO), dtype=np.float64)
    for mol in range(1, NMOL + 1):
        key = f"q_{MOLECULE_NAMES[mol - 1]}"
        if key not in raw:
            continue
        tab = raw[key]
        niso = min(tab.shape[0], MAX_ISO)
        q[mol - 1, :niso] = tab[:niso]
        gj[mol - 1, :niso] = raw[f"gj_{MOLECULE_NAMES[mol - 1]}"][:niso]
    return {"tdat": tdat, "q": q, "gj": gj}
