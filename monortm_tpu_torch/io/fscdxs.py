"""FSCDXS master index + cross-section data file readers.

FSCDXS grammar (XSREAD, monortm_sub.F90:1246-1421): after a 2-line header,
each record is (A10,2F10.4,F10.8,I5,5X,I5,A1,4X,6A10): name, V1X, V2X, DVX,
NTEMP, IFRM, CFRM, up to 6 temperature file names.  '*' comments, '%' ends.

Cross-section data files (MONORTM_XSEC_SUB, monortm_sub.F90:1659-1672):
header (A10,2F10.4,I10,3G10.3,3A10) = name, V1, V2, NPTS, TEMP, PRES,
SMAX, SOURCE(3); then free-form absorption values (cm^2/molec).

A copy of `monortm_tpu.io.fscdxs`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

MX_XS = 38

# alias table (BLOCK DATA BXSECT, monortm_sub.F90:1445-1464)
ALIASES = [
    ("CLONO2", "CLNO3", "", ""),
    ("HNO4", "", "", ""),
    ("CHCL2F", "CFC21", "CFC21", "F21"),
    ("CCL4", "", "", ""),
    ("CCL3F", "CFCL3", "CFC11", "F11"),
    ("CCL2F2", "CF2CL2", "CFC12", "F12"),
    ("C2CL2F4", "C2F4CL2", "CFC114", "F114"),
    ("C2CL3F3", "C2F3CL3", "CFC113", "F113"),
    ("N2O5", "", "", ""),
    ("HNO3", "", "", ""),
    ("CF4", "", "CFC14", "F14"),
    ("CHCLF2", "CHF2CL", "CFC22", "F22"),
    ("CCLF3", "", "CFC13", "F13"),
    ("C2CLF5", "", "CFC115", "F115"),
    ("NO2", "", "", ""),
] + [("", "", "", "")] * 23

# XSMASS (monortm_sub.F90:1470-1474)
XSMASS = np.array([97.46, 79.01, 102.92, 153.82, 137.37, 120.91, 170.92,
                   187.38, 108.01, 63.01, 88.00, 86.47, 104.46, 154.47,
                   45.99] + [0.0] * 23)


def alias_index(name: str) -> int:
    """1-based index of a cross-section molecule by any alias."""
    n = name.strip().upper()
    for i, row in enumerate(ALIASES):
        if n in (a.strip().upper() for a in row if a):
            return i + 1
    raise KeyError(f"{name!r} is not a known cross-section molecule")


@dataclasses.dataclass
class XsRegion:
    v1x: float
    v2x: float
    dvx: float
    files: list        # temperature file names, ascending T order
    xdoplr: float = 0.0


@dataclasses.dataclass
class XsIndex:
    """Selected molecules -> spectral regions (COMMON /XSECTR/)."""
    names: list
    indices: list              # 1-based alias indices
    regions: dict              # sel_idx -> [XsRegion]


def read_fscdxs(path: str | Path, names: list[str], xv1: float,
                xv2: float) -> XsIndex:
    """XSREAD: match requested molecules against the master index."""
    indices = [alias_index(n) for n in names]
    regions: dict[int, list[XsRegion]] = {i: [] for i in range(len(names))}
    lines = Path(path).read_text().splitlines()
    t296 = 296.0
    body = lines[2:]                      # FORMAT (/) skips two lines
    found = set()
    for line in body:
        if line.startswith("*"):
            continue
        if line.startswith("%"):
            break
        # FORMAT (A10,2F10.4,F10.8,I5,5X,I5,A1,4X,6A10)  monortm_sub.F90:1412
        r = line.ljust(120)
        xname = r[0:10].strip().upper()
        v1x = float(r[10:20])
        v2x = float(r[20:30])
        dvx = float(r[30:40] or 0)
        ntemp = int(r[40:45])
        files = [r[60 + 10 * k:70 + 10 * k].strip() for k in range(6)]
        files = [f for f in files[:ntemp] if f]
        try:
            idx = alias_index(xname)
        except KeyError:
            continue
        for i, sel in enumerate(indices):
            if sel == idx:
                found.add(i)
                if v2x > xv1 and v1x < xv2:
                    if len(regions[i]) >= 6:
                        raise ValueError("more than 6 spectral regions")
                    # 3.58115E-07 = sqrt(2 ln2 N_A k / c^2)
                    xdoplr = 3.58115e-07 * (0.5 * (v1x + v2x)) * \
                        np.sqrt(t296 / XSMASS[idx - 1])
                    regions[i].append(XsRegion(v1x, v2x, dvx, files,
                                               xdoplr))
    missing = set(range(len(names))) - found
    if missing:
        raise ValueError(
            f"molecules not found on FSCDXS: {[names[i] for i in missing]}")
    return XsIndex(names=list(names), indices=indices, regions=regions)


@dataclasses.dataclass
class XsSpectrum:
    v1: float
    v2: float
    npts: int
    temp: float
    pres: float            # millibar (TORR converted by caller check)
    data: np.ndarray


def read_xs_file(path: str | Path) -> XsSpectrum:
    """One cross-section data file (header format 910)."""
    lines = Path(path).read_text().splitlines()
    r = lines[0].ljust(100)
    v1 = float(r[10:20])
    v2 = float(r[20:30])
    npts = int(r[30:40])
    temp = float(r[40:50])
    pres = float(r[50:60])
    source3 = r[90:100]      # SOURCE(3), cols 91-100 (format 910)
    if source3.strip().upper() == "TORR":
        pres = pres * 1013.0 / 760.0      # PTORMB (monortm_sub.F90:1632)
    vals: list[float] = []
    for line in lines[1:]:
        vals.extend(float(x) for x in line.split())
        if len(vals) >= npts:
            break
    return XsSpectrum(v1=v1, v2=v2, npts=npts, temp=temp, pres=pres,
                      data=np.asarray(vals[:npts]))
