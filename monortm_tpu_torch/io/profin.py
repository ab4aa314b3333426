"""MONORTM_PROF.IN (TAPE7 dialect) layer-input parser — the IATM=0 path.

Replicates the driver's layer reading loop (monortm.f90:376-534):
record 925 profile header, per-layer records 974/9742 (IFORM=0) or
975/9752 (IFORM=1), molecular amount records 978, the mixing-ratio ->
column-density conversion (monortm.f90:414-483), and the IXSECT layer
amounts block.

A copy of `monortm_tpu.io.profin`; `Profile.state` is a `host_types.HostState`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from monortm_tpu_torch.host_types import HostState, ProfileMeta

MXMOL = 39


def _f(s: str) -> float:
    s = s.strip()
    return float(s.replace("d", "e").replace("D", "E")) if s else 0.0


def _i(s: str) -> int:
    s = s.strip()
    return int(s) if s else 0


@dataclasses.dataclass
class Profile:
    state: HostState           # numpy arrays, single profile
    meta: ProfileMeta
    secnt0: float = 1.0
    hmod: str = ""
    xamnt: np.ndarray | None = None     # [n_xsec_mol, nlay] if IXSECT
    xsname: list | None = None
    ityl: np.ndarray | None = None      # ITYL DV-ratio codes (IFXTYP)
    path: dict | None = None            # ray-trace summary for the LOG
                                        # (lblatm.f90:1219-1244 info class)
    ipunch: int = 0                     # record 3.1 IPUNCH: write TAPE7


class ProfInReader:
    def __init__(self, path: str | Path):
        self.lines = Path(path).read_text().splitlines()
        self.pos = 0

    def at_end(self) -> bool:
        return self.pos >= len(self.lines)

    def _next(self) -> str:
        line = self.lines[self.pos]
        self.pos += 1
        return line

    def read_profile(self, ixsect: int = 0, nwn_minmax=None) -> Profile:
        # header: FORMAT(1X,I1,I3,I5,F10.6,2A8,4X,F8.2,4X,F8.2,5X,F8.3,5X,I2)
        # monortm.f90:599
        r = self._next().ljust(90)
        iform = _i(r[1:2])
        nlayrs = _i(r[2:5])
        nmol = _i(r[5:10])
        secnt0 = _f(r[10:20])
        hmod = r[20:36]
        h1 = _f(r[40:48])
        h2 = _f(r[52:60])
        angle = _f(r[65:73])

        p = np.zeros(nlayrs)
        t = np.zeros(nlayrs)
        clw = np.zeros(nlayrs)
        altz = np.zeros(nlayrs + 1)
        pz = np.zeros(nlayrs + 1)
        tz = np.zeros(nlayrs + 1)
        wkl = np.zeros((nlayrs, MXMOL))
        wbrodl = np.zeros(nlayrs)

        for il in range(nlayrs):
            r = self._next().ljust(120)
            if iform == 0:
                # 974:  (3f10.4,3x,i2,1x,2(f7.2,f8.3,f7.2),f7.3)
                # 9742: (3f10.4,3x,i2,1x,22x,1(f7.2,f8.3,f7.2),f7.3)
                p[il] = _f(r[0:10])
                t[il] = _f(r[10:20])
                base = 36
            else:
                # 975:  (e15.7,2f10.4,3x,i2,1x,2(...),f7.3)
                p[il] = _f(r[0:15])
                t[il] = _f(r[15:25])
                base = 41
            if il == 0:
                altz[0] = _f(r[base:base + 7])
                pz[0] = _f(r[base + 7:base + 15])
                tz[0] = _f(r[base + 15:base + 22])
                base += 22
            else:
                base += 22
            altz[il + 1] = _f(r[base:base + 7])
            pz[il + 1] = _f(r[base + 7:base + 15])
            tz[il + 1] = _f(r[base + 15:base + 22])
            clw[il] = _f(r[base + 22:base + 29])

            # molecular amounts: 978 FORMAT (8E15.7); a single formatted
            # READ (WKL(K,IL),K=8,NMOL) consumes ceil((nmol-7)/8) rows
            r = self._next().ljust(120)
            for k in range(7):
                wkl[il, k] = _f(r[k * 15:(k + 1) * 15])
            wbrodl[il] = _f(r[7 * 15:8 * 15])
            k = 7
            while k < nmol:
                r = self._next().ljust(120)
                for col in range(8):
                    if k >= nmol:
                        break
                    wkl[il, k] = _f(r[col * 15:(col + 1) * 15])
                    k += 1

            # mixing-ratio -> column density (monortm.f90:414-483)
            wdnsty = wbrodl[il]
            wmxrat = 0.0
            for m in range(1, nmol):
                if wkl[il, m] > 1.0:
                    wdnsty += wkl[il, m]
                else:
                    wmxrat += wkl[il, m]
            if wbrodl[il] < 1.0 and wbrodl[il] != 0.0:
                raise ValueError(f"layer {il+1}: WBRODL must be column density")
            if wdnsty == 0.0 and wmxrat != 0.0:
                raise ValueError("WMXRAT/WDNSTY not properly specified")
            if wmxrat >= 1.0:
                raise ValueError("WMXRAT exceeds 1.0")
            wdrair = wdnsty / (1.0 - wmxrat)
            if 0.0 < wkl[il, 0] <= 1.0 and wdrair == 0.0:
                raise ValueError("WMXRAT not properly specified")
            for m in range(nmol):
                if wkl[il, m] < 1.0:
                    wkl[il, m] = wkl[il, m] * wdrair

        xamnt = None
        xsname = None
        if ixsect >= 1:
            xamnt, xsname = self._read_xsec_block(nlayrs)

        state = HostState(p=p, t=t, tz=tz, wkl=wkl, wbrodl=wbrodl, clw=clw)
        meta = ProfileMeta(nmol=nmol, angle=angle, h1=h1, h2=h2,
                           altz=altz, pz=pz)
        return Profile(state=state, meta=meta, secnt0=secnt0,
                       hmod=hmod.strip(), xamnt=xamnt, xsname=xsname)

    def _read_xsec_block(self, nlayrs: int):
        """Cross-section molecule selection + layer amounts
        (monortm.f90:492-532)."""
        r = self._next().ljust(20)
        ixmols = _i(r[0:5])
        # names: 7A10 (+ 8A10 continuation)
        r = self._next()
        names = [r[i * 10:(i + 1) * 10].strip() for i in range(7)]
        if ixmols > 7:
            r = self._next()
            names += [r[i * 10:(i + 1) * 10].strip() for i in range(8)]
        names = [n for n in names if n][:ixmols]
        # header: FORMAT (1X,I1,I3,I5,F10.2,15A4)
        r = self._next().ljust(90)
        nlayxs = _i(r[2:5])
        ixmol = _i(r[5:10])
        if ixmol == 0:
            raise ValueError("IXMOL 0")
        if ixmol != ixmols:
            raise ValueError("IXMOL != IXMOLS")
        if nlayrs != nlayxs:
            raise ValueError("NLAYRS != NLAYXS")
        xamnt = np.zeros((ixmols, nlayxs))
        for l in range(nlayxs):
            self._next()                      # layer P/T record (910/915)
            r = self._next().ljust(120)
            for m in range(min(7, ixmols)):
                xamnt[m, l] = _f(r[m * 15:(m + 1) * 15])
            if ixmols > 7:
                r = self._next().ljust(120)
                for m in range(7, ixmols):
                    xamnt[m, l] = _f(r[(m - 7) * 15:(m - 6) * 15])
        return xamnt, names


def read_profiles(path: str | Path, ixsect: int = 0) -> list[Profile]:
    rd = ProfInReader(path)
    out = []
    while not rd.at_end():
        # skip blanks and TAPE7 '$' header lines (lblatm.f90:626 writes
        # one; the reference profile reader never consumes it)
        while not rd.at_end() and (not rd.lines[rd.pos].strip()
                                   or rd.lines[rd.pos].startswith("$")):
            rd.pos += 1
        if rd.at_end():
            break
        out.append(rd.read_profile(ixsect=ixsect))
    return out
