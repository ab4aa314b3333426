"""TAPE7 writer — the layering stage's cacheable artifact.

The reference writes TAPE7 from IATM=1 runs (IPUNCH=1) so it can be reused
as MONORTM_PROF.IN for IATM=0 runs (README.md:52; ATMPTH write logic
lblatm.f90:1272-1424).  Round-tripping through io.profin reproduces the
layer state, which the tests verify.

A copy of `monortm_tpu.io.tape7`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from monortm_tpu_torch.io.profin import Profile


def _pz_fmt(pz: float) -> str:
    """PZFORM selection (lblatm.f90:501,1364-1372): digits after the point
    depend on the magnitude of PZ."""
    if pz <= 0:
        nptst = 1
    else:
        ptst = np.log10(pz)
        nptst = int(ptst + 2) if ptst >= 0.0 else 1
    nptst = min(max(nptst, 1), 5)
    digits = {1: 6, 2: 5, 3: 4, 4: 3, 5: 2}[nptst]
    return f"{pz:8.{digits}f}"


def write_tape7(path: str | Path, profiles: list[Profile], xid: str = "",
                ipass: int = 1) -> None:
    with open(path, "w") as fh:
        fh.write(f"${ipass:5d} {xid:<79s}\n".rstrip() + "\n")
        for prof in profiles:
            st, meta = prof.state, prof.meta
            nlay = len(st.p)
            iform = 1
            # record 2.1 (format 972)
            fh.write(f" {iform:1d}{nlay:3d}{meta.nmol:5d}{1.0:10.6f}"
                     f"{prof.hmod[:16]:<16s}"
                     f" H1={meta.h1:8.2f} H2={meta.h2:8.2f}"
                     f" ANG={meta.angle:8.3f} LEN= 0\n")
            altz = meta.altz if meta.altz is not None else np.zeros(nlay + 1)
            pz = meta.pz if meta.pz is not None else np.zeros(nlay + 1)
            tz = np.asarray(st.tz)
            ipath = 3 if meta.angle < 90 else (1 if meta.angle > 90 else 2)
            for l in range(nlay):
                pbar = float(st.p[l])
                pa = f"{pbar:15.7E}" if pbar < 0.1 else f"{pbar:15.7G}"
                if len(pa) > 15:
                    pa = f"{pbar:15.7E}"
                # CTYPE a3 slot after SECNTK (blank unless IFXTYP set)
                ctype = (f"{int(prof.ityl[l]):3d}"
                         if prof.ityl is not None else "   ")
                head = f"{pa}{float(st.t[l]):10.2f}" + " " * 10 + ctype \
                    + f"{ipath:2d} "
                if l == 0:
                    head += (f"{altz[0]:7.3f}{_pz_fmt(pz[0])}{tz[0]:7.2f}"
                             f"{altz[1]:7.3f}{_pz_fmt(pz[1])}{tz[1]:7.2f}")
                else:
                    head += " " * 22 + (f"{altz[l+1]:7.3f}{_pz_fmt(pz[l+1])}"
                                        f"{tz[l+1]:7.2f}")
                fh.write(head + "\n")
                row = "".join(f"{float(st.wkl[l, k]):15.7E}"
                              for k in range(7))
                row += f"{float(st.wbrodl[l]):15.7E}"
                fh.write(row + "\n")
                # (WKL(K),K=8,NMOL) wraps every 8 values (format 978)
                for start in range(7, meta.nmol, 8):
                    row = "".join(f"{float(st.wkl[l, k]):15.7E}"
                                  for k in range(start,
                                                 min(start + 8, meta.nmol)))
                    fh.write(row + "\n")
