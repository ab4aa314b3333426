"""TAPE3 binary line-database IO (LNFL output format).

Record layout follows struct_types.f90:27-43 wrapped in gfortran-style
sequential records (4-byte length markers):

  file header   (lnfl_mod.f90:250-252): HLINID(10)*8, BMOLID(64)*8,
                MOLCNT/MCNTLC/MCNTNL i4[64], SUMSTR r4[64], LINMOL i4,
                FLINLO/FLINHI r4, LINCNT/ILINLC/ILINNL/IREC/IRECTL i4,
                HID1(2)*8
  neg-Epp block (optional, flagged by '^' in HLINID(7)[7]):
                n_negepp i4[64], n_resetepp i4[64], xspace r4[4096]
  panels        INPUT_HEADER{vmin,vmax r8, nrec,nwds i4} then INPUT_BLOCK
                {vnu r8[250]; sp,alfa,epp r4[250]; mol i4[250];
                 hwhm,tmpalf,pshift r4[250]; iflg i4[250];
                 brd_mol_flg i4[7,250]; brd_mol_dat r4[21,250];
                 speed_dep r4[250]}

The reader is NumPy-vectorised (panel payloads are decoded as one
structured view).  A writer is provided so tests and the chip smoke run
can synthesise valid line databases.

A copy of `monortm_tpu.io.tape3` (reader, header reader, writer and
`RawLines`), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

NLINEREC = 250
MXBRDMOL = 7

_PANEL_DTYPE = np.dtype([
    ("vnu", "<f8", (NLINEREC,)),
    ("sp", "<f4", (NLINEREC,)),
    ("alfa", "<f4", (NLINEREC,)),
    ("epp", "<f4", (NLINEREC,)),
    ("mol", "<i4", (NLINEREC,)),
    ("hwhm", "<f4", (NLINEREC,)),
    ("tmpalf", "<f4", (NLINEREC,)),
    ("pshift", "<f4", (NLINEREC,)),
    ("iflg", "<i4", (NLINEREC,)),
    ("brd_mol_flg", "<i4", (MXBRDMOL, NLINEREC)),
    ("brd_mol_dat", "<f4", (MXBRDMOL * 3, NLINEREC)),
    ("speed_dep", "<f4", (NLINEREC,)),
])

_HDR_FMT = "<2d2i"  # vmin, vmax, nrec, nwds


@dataclasses.dataclass
class RawLines:
    """Raw line records in file order (pre-grouping)."""
    vnu: np.ndarray        # f8
    sp: np.ndarray         # f4
    alfa: np.ndarray
    epp: np.ndarray
    mol: np.ndarray        # i4 (for coupling rows this holds r4 payload bits)
    hwhm: np.ndarray
    tmpalf: np.ndarray
    pshift: np.ndarray
    iflg: np.ndarray       # i4
    brd_mol_flg: np.ndarray   # [n, 7] i4
    brd_mol_hw: np.ndarray    # [n, 7] f4
    brd_mol_tmp: np.ndarray   # [n, 7] f4
    brd_mol_shft: np.ndarray  # [n, 7] f4
    speed_dep: np.ndarray

    def __len__(self):
        return len(self.vnu)


class _RecordReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def next_record(self) -> memoryview | None:
        if self.pos + 4 > len(self.data):
            return None
        (n,) = struct.unpack_from("<i", self.data, self.pos)
        start = self.pos + 4
        end = start + n
        if end + 4 > len(self.data):
            return None
        (n2,) = struct.unpack_from("<i", self.data, end)
        if n2 != n:
            raise ValueError(f"corrupt record markers at {self.pos}: {n} != {n2}")
        self.pos = end + 4
        return memoryview(self.data)[start:end]


def read_tape3_header(path: str | Path) -> str:
    """The 80-char HLINID file-header string (lnfl_mod.f90:250-252),
    e.g. for the LOG version-stamp tail's 'spectral file' field."""
    data = Path(path).read_bytes()
    header = _RecordReader(data).next_record()
    if header is None:
        raise EOFError("TAPE3: missing file header")
    return bytes(header[:80]).decode("latin-1")


def read_tape3(path: str | Path, v1: float, v2: float) -> RawLines:
    """Read raw line records covering [max(0, v1-25), v2+25].

    Follows RDLNFL's panel skipping (lnfl_mod.f90:157-168) and GET_LNFL's
    stop condition vnu(last) > v2+25 (lnfl_mod.f90:116).  Requires the
    isotope-info flag 'I' in HLINID(10) like PRLNHD (lnfl_mod.f90:297-302).
    """
    data = Path(path).read_bytes()
    rd = _RecordReader(data)

    header = rd.next_record()
    if header is None:
        raise EOFError("TAPE3: missing file header")
    hlinid = bytes(header[:80])
    # isotope compatibility check (PRLNHD lnfl_mod.f90:297-302)
    chid10 = hlinid[72:80].decode("latin-1")
    if len(chid10) < 8 or chid10[7] != "I":
        raise ValueError("TAPE3 lacks isotope info flag (PRLNHD check)")
    negepp = hlinid[48:56][7:8] == b"^"   # HLINID(7) 8th char
    if negepp:
        rd.next_record()                  # n_negepp/n_resetepp/xspace

    vlo_adj = max(0.0, v1 - 25.0)
    chunks: list[np.ndarray] = []
    stop = False
    while not stop:
        hdr = rd.next_record()
        if hdr is None:
            break
        if len(hdr) < struct.calcsize(_HDR_FMT):
            break
        vmin, vmax, nrec, nwds = struct.unpack_from(_HDR_FMT, hdr, 0)
        body = rd.next_record()
        if body is None:
            break
        if nrec <= 0:       # -99 end marker panels
            break
        if vmax < vlo_adj:
            continue
        panel = np.frombuffer(bytes(body[:_PANEL_DTYPE.itemsize]),
                              dtype=_PANEL_DTYPE, count=1)[0]
        n = min(nrec, NLINEREC)
        chunks.append((panel, n))
        if panel["vnu"][n - 1] > v2 + 25.0:
            stop = True

    if not chunks:
        return _empty_raw()

    def cat(field):
        return np.concatenate([np.asarray(p[field][..., :n]).reshape(
            (-1, n) if p[field].ndim > 1 else (n,), order="C").T
            if p[field].ndim > 1 else p[field][:n]
            for p, n in chunks], axis=0)

    vnu = np.concatenate([p["vnu"][:n] for p, n in chunks])
    out = RawLines(
        vnu=vnu,
        sp=np.concatenate([p["sp"][:n] for p, n in chunks]),
        alfa=np.concatenate([p["alfa"][:n] for p, n in chunks]),
        epp=np.concatenate([p["epp"][:n] for p, n in chunks]),
        mol=np.concatenate([p["mol"][:n] for p, n in chunks]),
        hwhm=np.concatenate([p["hwhm"][:n] for p, n in chunks]),
        tmpalf=np.concatenate([p["tmpalf"][:n] for p, n in chunks]),
        pshift=np.concatenate([p["pshift"][:n] for p, n in chunks]),
        iflg=np.concatenate([p["iflg"][:n] for p, n in chunks]),
        brd_mol_flg=np.concatenate([p["brd_mol_flg"][:, :n].T for p, n in chunks]),
        brd_mol_hw=np.concatenate([p["brd_mol_dat"][0::3, :n].T for p, n in chunks]),
        brd_mol_tmp=np.concatenate([p["brd_mol_dat"][1::3, :n].T for p, n in chunks]),
        brd_mol_shft=np.concatenate([p["brd_mol_dat"][2::3, :n].T for p, n in chunks]),
        speed_dep=np.concatenate([p["speed_dep"][:n] for p, n in chunks]),
    )
    return out


def _empty_raw() -> RawLines:
    z = np.zeros(0)
    zi = np.zeros(0, np.int32)
    z7 = np.zeros((0, MXBRDMOL))
    return RawLines(z, z, z, z, zi, z, z, z, zi, z7.astype(np.int32),
                    z7, z7, z7, z)


def write_tape3(path: str | Path, lines: RawLines,
                hlinid_note: str = "monortm-tpu synthetic") -> None:
    """Write a TAPE3 readable by both this reader and the reference code."""
    recs = []

    def rec(payload: bytes):
        recs.append(struct.pack("<i", len(payload)) + payload
                    + struct.pack("<i", len(payload)))

    hlinid = (hlinid_note[:72].ljust(72) + "LNFL 36I").encode("latin-1")
    bmolid = b" " * 8 * 64
    molcnt = np.zeros(64, "<i4")
    uniq = np.unique(np.abs(lines.mol) % 100) if len(lines) else []
    linmol = int(max(uniq)) if len(lines) else 1
    for m in uniq:
        if 1 <= m <= 64:
            molcnt[m - 1] = int(((np.abs(lines.mol) % 100) == m).sum())
    sumstr = np.zeros(64, "<f4")
    flinlo = np.float32(lines.vnu.min() if len(lines) else 0.0)
    flinhi = np.float32(lines.vnu.max() if len(lines) else 0.0)
    head = (hlinid + bmolid + molcnt.tobytes() + molcnt.tobytes()
            + np.zeros(64, "<i4").tobytes() + sumstr.tobytes()
            + struct.pack("<i", max(linmol, 1))
            + struct.pack("<ff", flinlo, flinhi)
            + struct.pack("<5i", len(lines), 0, 0, 0, 0)
            + b" " * 16)
    rec(head)

    for start in range(0, max(len(lines), 1), NLINEREC):
        n = min(NLINEREC, len(lines) - start) if len(lines) else 0
        panel = np.zeros(1, dtype=_PANEL_DTYPE)[0]
        sl = slice(start, start + n)
        panel["vnu"][:n] = lines.vnu[sl]
        panel["sp"][:n] = lines.sp[sl]
        panel["alfa"][:n] = lines.alfa[sl]
        panel["epp"][:n] = lines.epp[sl]
        panel["mol"][:n] = lines.mol[sl]
        panel["hwhm"][:n] = lines.hwhm[sl]
        panel["tmpalf"][:n] = lines.tmpalf[sl]
        panel["pshift"][:n] = lines.pshift[sl]
        panel["iflg"][:n] = lines.iflg[sl]
        panel["brd_mol_flg"][:, :n] = lines.brd_mol_flg[sl].T
        panel["brd_mol_dat"][0::3, :n] = lines.brd_mol_hw[sl].T
        panel["brd_mol_dat"][1::3, :n] = lines.brd_mol_tmp[sl].T
        panel["brd_mol_dat"][2::3, :n] = lines.brd_mol_shft[sl].T
        panel["speed_dep"][:n] = lines.speed_dep[sl]
        vmin = float(panel["vnu"][0]) if n else 0.0
        vmax = float(panel["vnu"][n - 1]) if n else 0.0
        rec(struct.pack(_HDR_FMT, vmin, vmax, n, _PANEL_DTYPE.itemsize // 4))
        rec(panel.tobytes())
        if not len(lines):
            break

    Path(path).write_bytes(b"".join(recs))
