"""The reference's readers: MONORTM.IN records 1.2-1.4
(monortm_sub.F90:140-340), MONORTM_PROF.IN layer records (monortm.f90:
376-490, IFORM=1) and the rows of MONORTM.OUT (monortm_sub.F90:781-782).

Copies of tests/reference_e2e.py's `parse_tape5_min` and `parse_profin`
(the latter also skipping a TAPE7's leading "$" record), and a reader of
the writer's fixed columns.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _ff(s):
    s = s.strip()
    return float(s.replace("D", "E").replace("d", "e")) if s else 0.0


def _fi(s):
    s = s.strip()
    return int(s) if s else 0


def parse_tape5(path) -> dict:
    """Records 1.2 (flags), 1.3 (the grid: V1 + DVSET * k up to V2) and
    1.4 (TBOUND, emissivity, reflectivity polynomials)."""
    lines = Path(path).read_text().splitlines()
    k = 0
    while not lines[k].startswith("$"):
        k += 1
    r12 = lines[k + 1]
    flags = dict(icntnm=_fi(r12[14:15]), iatm=_fi(r12[49:50]),
                 iod=_fi(r12[64:65]), ixsect=_fi(r12[69:70]))
    if flags["icntnm"] != 1 or flags["iatm"] != 0 or flags["ixsect"]:
        raise NotImplementedError("the reference reads ICNTNM=1, IATM=0 "
                                  "and no cross-sections")
    k += 2
    r13 = lines[k].ljust(105)
    v1, v2, dvset = _ff(r13[0:10]), _ff(r13[10:20]), _ff(r13[30:40])
    if _fi(r13[100:105]) or v1 < 0.0 or v2 < 0.0:
        raise NotImplementedError("the reference applies no scaling and "
                                  "reads no list of wavenumbers")
    k += 1
    wn = v1 + dvset * np.arange(int(round((v2 - v1) / dvset) + 1))
    r14 = lines[k].ljust(70)
    return dict(wn=wn, dvset=dvset, tbound=_ff(r14[0:10]),
                bndemi=[_ff(r14[10 + 10 * j:20 + 10 * j]) for j in range(3)],
                bndrfl=[_ff(r14[40 + 10 * j:50 + 10 * j]) for j in range(3)],
                **flags)


def boundary(wn, coef):
    """EMISFN/REFLFN's polynomial (monortm_sub.F90:451-457)."""
    a, b, c = coef
    if a < 0:
        raise NotImplementedError("the reference reads polynomial "
                                  "boundaries only")
    return a + b * wn + c * wn * wn


def parse_profin(path) -> list[dict]:
    """Profiles of an IFORM=1 layer file: p, t, clw [nlay], tz [nlay + 1]
    (surface first), wkl [nlay, 39] in columns (mixing ratios converted),
    wbrodl, nmol, angle, irt."""
    lines = [ln for ln in Path(path).read_text().splitlines()
             if not ln.startswith("$")]
    pos = 0
    out = []
    while pos < len(lines) and lines[pos].strip():
        h = lines[pos].ljust(80)
        pos += 1
        if _fi(h[1:2]) != 1:
            raise NotImplementedError("the reference reads IFORM=1 only")
        nlay, nmol, angle = _fi(h[2:5]), _fi(h[5:10]), _ff(h[65:73])
        p, t, clw = np.zeros(nlay), np.zeros(nlay), np.zeros(nlay)
        tz = np.zeros(nlay + 1)
        wkl = np.zeros((nlay, 39))
        wbrodl = np.zeros(nlay)
        for il in range(nlay):
            r = lines[pos].ljust(92)
            pos += 1
            p[il], t[il] = _ff(r[0:15]), _ff(r[15:25])
            if il == 0:
                tz[0] = _ff(r[56:63])
            tz[il + 1] = _ff(r[78:85])
            clw[il] = _ff(r[85:92])
            vals = []
            while len(vals) < nmol + 1:
                row = lines[pos]
                pos += 1
                vals += [_ff(row[15 * j:15 * (j + 1)])
                         for j in range(len(row.rstrip()) // 15 + 1)
                         if row[15 * j:15 * (j + 1)].strip()]
            wkl[il, :7] = vals[:7]
            wbrodl[il] = vals[7]
            wkl[il, 7:nmol] = vals[8:nmol + 1]
            wdnsty, wmxrat = wbrodl[il], 0.0
            for m in range(1, nmol):
                if wkl[il, m] > 1.0:
                    wdnsty += wkl[il, m]
                else:
                    wmxrat += wkl[il, m]
            wdrair = wdnsty / (1.0 - wmxrat)
            for m in range(nmol):
                if wkl[il, m] < 1.0:
                    wkl[il, m] *= wdrair
        irt = 1 if angle > 90.0 else (2 if angle == 90.0 else 3)
        out.append(dict(p=p, t=t, tz=tz, clw=clw, wkl=wkl, wbrodl=wbrodl,
                        nmol=nmol, angle=angle, irt=irt))
    return out


def read_out(path, nwn: int) -> dict:
    """Columns of MONORTM.OUT's rows: freq (GHz), tb (K) and total_od,
    each [n_profiles, nwn] (format 21: I5, F10.3, 2F11.5, E21.9, F9.5,
    2F8.4, 3F8.2, F9.3, E12.4, ...)."""
    cols = dict(freq=(5, 15), tb=(15, 26), total_od=(116, 128))
    rows = [ln for ln in Path(path).read_text().splitlines()
            if len(ln) >= 128 and ln[:5].strip().isdigit()]
    if not rows or len(rows) % nwn:
        raise ValueError(f"{path}: {len(rows)} rows, not a whole number of "
                         f"profiles of {nwn} wavenumbers")
    out = {k: np.array([float(r[a:b]) for r in rows]).reshape(-1, nwn)
           for k, (a, b) in cols.items()}
    return out
