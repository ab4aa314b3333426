"""Writers of MonoRTM's input files: TAPE3, MONORTM.IN, MONORTM_PROF.IN.

Frozen copies of `monortm_tpu_torch.io.tape3.write_tape3` (gfortran
sequential records of LNFL's layout, struct_types.f90:27-43),
`io.tape7.write_tape7` (records 2.1 and 975/978 of an IFORM=1 layer file;
here with each layer's liquid water path in the F7.3 field after its
upper level, which monortm.f90's record 975 reads as CLW) and the
MONORTM.IN text of `monortm_tpu_torch.envelope.tape5_text`, so that a
later change to the program cannot move the benchmark's inputs.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

NLINEREC = 250
_PANEL = np.dtype([
    ("vnu", "<f8", (NLINEREC,)), ("sp", "<f4", (NLINEREC,)),
    ("alfa", "<f4", (NLINEREC,)), ("epp", "<f4", (NLINEREC,)),
    ("mol", "<i4", (NLINEREC,)), ("hwhm", "<f4", (NLINEREC,)),
    ("tmpalf", "<f4", (NLINEREC,)), ("pshift", "<f4", (NLINEREC,)),
    ("iflg", "<i4", (NLINEREC,)), ("brd_mol_flg", "<i4", (7, NLINEREC)),
    ("brd_mol_dat", "<f4", (21, NLINEREC)),
    ("speed_dep", "<f4", (NLINEREC,))])


def write_tape3(path, raw: dict, note: str = "monortm benchmark") -> None:
    """A TAPE3 of the records `raw` (gen.lines' dict), panels of 250."""
    n = len(raw["vnu"])
    recs = []

    def rec(payload: bytes):
        recs.append(struct.pack("<i", len(payload)) + payload
                    + struct.pack("<i", len(payload)))

    mol = np.abs(raw["mol"]) % 100
    molcnt = np.zeros(64, "<i4")
    for m in np.unique(mol):
        if 1 <= m <= 64:
            molcnt[m - 1] = int((mol == m).sum())
    rec((note[:72].ljust(72) + "LNFL 36I").encode("latin-1") + b" " * 512
        + molcnt.tobytes() * 2 + np.zeros(64, "<i4").tobytes()
        + np.zeros(64, "<f4").tobytes()
        + struct.pack("<i", max(int(mol.max()), 1))
        + struct.pack("<ff", float(raw["vnu"].min()),
                      float(raw["vnu"].max()))
        + struct.pack("<5i", n, 0, 0, 0, 0) + b" " * 16)
    panels = np.zeros((n + NLINEREC - 1) // NLINEREC, dtype=_PANEL)
    for i, start in enumerate(range(0, n, NLINEREC)):
        m = min(NLINEREC, n - start)
        sl, p = slice(start, start + m), panels[i]
        for k in ("vnu", "sp", "alfa", "epp", "mol", "hwhm", "tmpalf",
                  "pshift", "iflg", "speed_dep"):
            p[k][:m] = raw[k][sl]
        p["brd_mol_flg"][:, :m] = raw["brd_mol_flg"][sl].T
        p["brd_mol_dat"][0::3, :m] = raw["brd_mol_hw"][sl].T
        p["brd_mol_dat"][1::3, :m] = raw["brd_mol_tmp"][sl].T
        p["brd_mol_dat"][2::3, :m] = raw["brd_mol_shft"][sl].T
        rec(struct.pack("<2d2i", float(p["vnu"][0]), float(p["vnu"][m - 1]),
                        m, _PANEL.itemsize // 4))
        rec(p.tobytes())
    Path(path).write_bytes(b"".join(recs))


def _e10(x: float) -> str:
    """Fortran's E10.3 (0.ddd mantissa) of x >= 0."""
    if x == 0.0:
        return " 0.000E+00"
    e = int(np.floor(np.log10(x))) + 1
    m = round(x / 10.0 ** e, 3)
    if m >= 1.0:
        m, e = m / 10.0, e + 1
    return f"{m:6.3f}E{e:+03d}".rjust(10)


# record 1.2: HIRAC 1, CNTNM 1, EMIT 1, PLOT 1 (Tb out), IATM 0 (a layer
# file), IOD 0, XSECT 0
REC12 = ("    1         1         1              1         0"
         "              0    0")
# record 1.4: TBOUND 0, emissivity 1, reflectivity 0
REC14 = ("     0.    1.0       0.000E+00 0.000E+00 0.000E+00 0.000E+00 "
         "0.000E+00")


def tape5_text(grid: dict, title: str) -> str:
    """MONORTM.IN of an IATM=0 run on the grid {"v1", "dvset", "nwn"}
    (record 1.3: V1, V2, DVSET)."""
    v1, dv, nwn = grid["v1"], grid["dvset"], grid["nwn"]
    rec13 = (f"{_e10(v1)}{v1 + (nwn - 1) * dv:10.5f}{_e10(0.0)}"
             f"{_e10(dv)}" + _e10(0.0) * 4 + "    0      0.000E+00    0\n")
    return (f"* {title}\n$ Rundeck benchmark\n" + REC12 + "\n" + rec13
            + REC14 + "\n%%%%\n")


def _pz(pz: float) -> str:
    """PZFORM (lblatm.f90:1364-1372): the digits follow the magnitude."""
    nptst = int(np.log10(pz) + 2) if pz >= 1.0 else 1
    digits = {1: 6, 2: 5, 3: 4, 4: 3, 5: 2}[min(max(nptst, 1), 5)]
    return f"{pz:8.{digits}f}"


def write_profiles(path, profiles: list[dict], xid: str = "benchmark"):
    """MONORTM_PROF.IN of IFORM=1 layer records, one block a profile.
    A profile: p, t [nlay]; tz, altz, pz [nlay + 1]; wkl [nlay, nmol];
    wbrodl, clw [nlay]; nmol, angle, h1, h2, hmod."""
    out = [f"${1:5d} {xid}".rstrip() + "\n"]
    for pr in profiles:
        nlay, nmol = len(pr["p"]), pr["nmol"]
        out.append(f" 1{nlay:3d}{nmol:5d}{1.0:10.6f}{pr['hmod'][:16]:<16s}"
                   f" H1={pr['h1']:8.2f} H2={pr['h2']:8.2f}"
                   f" ANG={pr['angle']:8.3f} LEN= 0\n")
        ipath = 3 if pr["angle"] < 90 else (1 if pr["angle"] > 90 else 2)
        altz, pz, tz = pr["altz"], pr["pz"], pr["tz"]
        for l in range(nlay):
            pbar = float(pr["p"][l])
            pa = f"{pbar:15.7E}" if pbar < 0.1 else f"{pbar:15.7G}"
            if len(pa) > 15:
                pa = f"{pbar:15.7E}"
            head = f"{pa}{float(pr['t'][l]):10.2f}" + " " * 13 + f"{ipath:2d} "
            if l == 0:
                head += f"{altz[0]:7.3f}{_pz(pz[0])}{tz[0]:7.2f}"
            else:
                head += " " * 22
            head += (f"{altz[l + 1]:7.3f}{_pz(pz[l + 1])}{tz[l + 1]:7.2f}"
                     f"{float(pr['clw'][l]):7.3f}")
            out.append(head + "\n")
            w = pr["wkl"][l]
            out.append("".join(f"{float(w[k]):15.7E}" for k in range(7))
                       + f"{float(pr['wbrodl'][l]):15.7E}\n")
            for s in range(7, nmol, 8):
                out.append("".join(f"{float(w[k]):15.7E}"
                                   for k in range(s, min(s + 8, nmol)))
                           + "\n")
    Path(path).write_text("".join(out))
