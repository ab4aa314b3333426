"""MONORTM.IN (TAPE5 dialect) control-file parser.

Replicates RDLBLINP's record grammar (monortm_sub.F90:33-423) for records
1.1-1.4 including the MonoRTM-specific explicit wavenumber list (V1<0 or
V2<0, records 1.3.1/1.3.2) and continuum-factor record 1.2a (ICNTNM=6).
Records 2.x/3.x (LBLATM) are parsed by atmos.tape5_atm.

Fixed-column parsing mirrors the Fortran FORMAT statements; file:line refs
point at the formats being replicated.

A copy of `monortm_tpu.io.tape5`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from monortm_tpu_torch.ops.continuum import ContinuumFactors

NWNMX = 80000   # RTMmono.f90:10


def _f(s: str) -> float:
    s = s.strip()
    if not s:
        return 0.0
    # Fortran accepts 'd' exponents and bare exponent-less fields
    return float(s.replace("d", "e").replace("D", "E"))


def _i(s: str) -> int:
    s = s.strip()
    return int(s) if s else 0


@dataclasses.dataclass
class Tape5Config:
    """Records 1.1-1.4 of MONORTM.IN."""
    xid: str = ""
    ihirac: int = 1
    icntnm: int = 1
    iemit: int = 1
    iplot: int = 1
    iatm: int = 1
    iod: int = 0
    ixsect: int = 0
    ispd: int = 0
    ibrd: int = 0
    factors: ContinuumFactors = ContinuumFactors()
    v1: float = 0.0
    v2: float = 0.0
    dvset: float = 0.0
    wn: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    nmol_scal: int = 0
    hmol_scal: str = ""
    xmol_scal: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    tbound: float = 0.0
    bndemi: tuple = (1.0, 0.0, 0.0)
    bndrfl: tuple = (0.0, 0.0, 0.0)
    # remaining lines (records 2.x/3.x) for the LBLATM-equivalent parser
    rest: list = dataclasses.field(default_factory=list)
    # CHECKINPUTS-style messages (monortm_sub.F90:163-253), echoed to the
    # console and MONORTM.LOG by the driver
    warnings: list = dataclasses.field(default_factory=list)

    @property
    def nwn(self) -> int:
        return len(self.wn)


class Tape5Reader:
    """Sequential reader over a MONORTM.IN file supporting '$'-stacked
    profile records (GETPROFNUMBER semantics, monortm_sub.F90:869-920)."""

    def __init__(self, path: str | Path):
        self.lines = Path(path).read_text().splitlines()
        self.pos = 0
        # block boundaries precomputed once ('$' starts / '%' terminator,
        # monortm_sub.F90:139-142) — avoids rescanning per stacked block
        self._marks = [(i, s[0]) for i, s in enumerate(self.lines)
                       if s[:1] in ("$", "%")]
        self._mark_pos = [m[0] for m in self._marks]

    def _next(self) -> str:
        line = self.lines[self.pos]
        self.pos += 1
        return line

    def _next_mark(self, pos: int):
        import bisect
        i = bisect.bisect_left(self._mark_pos, pos)
        return self._marks[i] if i < len(self._marks) else None

    def at_end(self) -> bool:
        m = self._next_mark(self.pos)
        return m is None or m[1] == "%"

    def read_block(self) -> Tape5Config:
        """Parse one $-record block (records 1.1-1.4 + trailing 2.x/3.x)."""
        # record 1.1: jump to the next '$'
        m = self._next_mark(self.pos)
        if m is None or m[1] != "$":
            raise ValueError("no '$' record found")
        self.pos = m[0]
        line = self._next()
        cfg = Tape5Config(xid=line[1:81].strip())

        # record 1.2: (4X,I1,9X,I1,9X,I1,14X,I1,9X,I1,14X,I1,4X,I1,16X,I4,I4)
        # monortm_sub.F90:402
        r = self._next().ljust(95)
        cfg.ihirac = _i(r[4:5])
        cfg.icntnm = _i(r[14:15])
        cfg.iemit = _i(r[24:25])
        cfg.iplot = _i(r[39:40])
        cfg.iatm = _i(r[49:50])
        cfg.iod = _i(r[64:65])
        cfg.ixsect = _i(r[69:70])
        cfg.ispd = _i(r[86:90])
        cfg.ibrd = _i(r[90:94])
        if cfg.ispd == 1:
            raise ValueError("ISPD=1 is retired (monortm.f90:335-343); "
                             "build an appropriate TAPE3 instead")
        # record 1.2 input checking (monortm_sub.F90:163-179)
        if cfg.iemit != 1:
            cfg.warnings.append(
                f"WARNING: IEMIT IS IGNORED IN MONORTM; IT IS SET "
                f"INTERNALLY TO ONE (IEMIT={cfg.iemit})")
        if cfg.iplot != 1:
            cfg.warnings.append(
                f"WARNING: IPLOT MUST BE SET TO 1 TO OUTPUT TBs "
                f"(IPLOT={cfg.iplot})")
        if cfg.iod == 1:
            cfg.warnings.append(
                "IOD FLAG SET TO OUTPUT LAYER OPTICAL DEPTHS (IOD=1)")

        # record 1.2a (ICNTNM=6): list-directed 7 reals
        if cfg.icntnm == 6:
            vals = [float(x) for x in self._next().split()[:7]]
            cfg.factors = ContinuumFactors(*vals)
        else:
            cfg.factors = ContinuumFactors.from_icntnm(cfg.icntnm)

        if cfg.iemit == 2:
            self._next()     # record 1.2.1 (INFLAG/IOTFLG/JULDAT) — ignored
        if cfg.iemit == 3:
            raise ValueError("MonoRTM does not handle derivatives (IEMIT=3)")

        # record 1.3: (8E10.3,4X,I1,5x,e10.3,i5)  monortm_sub.F90:408
        r = self._next().ljust(105)
        vals = [_f(r[i * 10:(i + 1) * 10]) for i in range(8)]
        v1, v2, sample, dvset = vals[0], vals[1], vals[2], vals[3]
        ilnflg = _i(r[84:85])
        dvout = _f(r[90:100])
        cfg.nmol_scal = _i(r[100:105])
        if ilnflg > 0:
            raise ValueError("ILNFLG must be 0 for MonoRTM")
        # record 1.3 checking (monortm_sub.F90:210-253): LBLRTM-only
        # fields are accepted but ignored, with the reference's warnings
        for name, val in (("SAMPLE", sample), ("ALFAL0", vals[4]),
                          ("AVMASS", vals[5]), ("DPTMIN", vals[6]),
                          ("DPTFAC", vals[7]), ("DVOUT", dvout)):
            if val > 0:
                cfg.warnings.append(
                    f"WARNING: {name} IS IGNORED IN MONORTM ({name}={val:g})")
        cfg.v1, cfg.v2, cfg.dvset = v1, v2, dvset

        if cfg.nmol_scal > 0:
            if cfg.nmol_scal > 38:
                raise ValueError("nmol_scal > 38")
            cfg.hmol_scal = self._next()[:64]
            # xmol_scal: (7e15.7,/,(8e15.7,/))  monortm_sub.F90:9702
            xs: list[float] = []
            r = self._next().ljust(120)
            for i in range(min(7, cfg.nmol_scal)):
                xs.append(_f(r[i * 15:(i + 1) * 15]))
            left = cfg.nmol_scal - len(xs)
            while left > 0:
                r = self._next().ljust(120)
                for i in range(min(8, left)):
                    xs.append(_f(r[i * 15:(i + 1) * 15]))
                left = cfg.nmol_scal - len(xs)
            cfg.xmol_scal = np.asarray(xs)

        # wavenumber grid (monortm_sub.F90:254-300)
        if v1 < 0.0 or v2 < 0.0:
            nwn = _i(self._next()[:8])
            if nwn > NWNMX:
                raise ValueError(f"NWN {nwn} exceeds NWNMX {NWNMX}")
            wn = np.empty(nwn)
            for k in range(nwn):
                wn[k] = _f(self._next()[:19])
            cfg.wn = wn
            cfg.dvset = 0.0
        else:
            if dvset != 0.0:
                nwn = int(round((v2 - v1) / dvset + 1.0))
                if nwn > NWNMX:
                    raise ValueError(f"NWN {nwn} exceeds NWNMX {NWNMX}")
                cfg.wn = v1 + dvset * np.arange(nwn)
            else:
                if v1 != v2:
                    raise ValueError(
                        f"ambiguous wavenumber spec: {v1} {v2} {dvset}")
                cfg.wn = np.asarray([v1])

        # record 1.4 (8E10.3): TBOUND + 3 emis + 3 refl coefficients
        r = self._next().ljust(80)
        vals = [_f(r[i * 10:(i + 1) * 10]) for i in range(7)]
        cfg.tbound = vals[0]
        cfg.bndemi = tuple(vals[1:4])
        cfg.bndrfl = tuple(vals[4:7])
        if cfg.bndemi[0] >= 0:
            xvmid = (cfg.v1 + cfg.v2) / 2.0
            e = cfg.bndemi[0] + cfg.bndemi[1] * xvmid + cfg.bndemi[2] * xvmid**2
            if e < 0.0 or e > 1.0:
                raise ValueError("BNDEMI outside physical range")
        if cfg.bndrfl[0] >= 0:
            xvmid = (cfg.v1 + cfg.v2) / 2.0
            rr = cfg.bndrfl[0] + cfg.bndrfl[1] * xvmid + cfg.bndrfl[2] * xvmid**2
            if rr < 0.0 or rr > 1.0:
                raise ValueError("BNDRFL outside physical range")

        # collect the rest of this block (records 2.x/3.x for LBLATM)
        m = self._next_mark(self.pos)
        end = m[0] if m is not None else len(self.lines)
        cfg.rest = self.lines[self.pos:end]
        return cfg


def count_profiles(filein: str | Path, fileprof: str | Path | None):
    """GETPROFNUMBER (monortm_sub.F90:869-920): returns (iatm, ixsect, n)."""
    lines = Path(filein).read_text().splitlines()
    iatm = ixsect = 0
    for k, line in enumerate(lines):
        if line.startswith("$"):
            r = lines[k + 1].ljust(70)
            iatm = _i(r[49:50])
            ixsect = _i(r[69:70])
            break
    if iatm == 1:
        n = sum(1 for line in lines if line.startswith("$"))
        return iatm, ixsect, n
    # IATM=0: count profile header records in MONORTM_PROF.IN
    n = 0
    if fileprof is not None and Path(fileprof).exists():
        for line in Path(fileprof).read_text().splitlines():
            try:
                nl = _i(line[2:5])
                nm = _i(line[5:10])
                if nl > 0 and nm > 0 and "." in line[10:20]:
                    n += 1
            except (ValueError, IndexError):
                continue
    if ixsect == 1:
        n //= 2
    if n == 0:
        raise ValueError("no profiles found")
    return iatm, ixsect, n
