"""Line catalog: host-side preparation of TAPE3 records into packed,
device-ready struct-of-arrays.

A copy of `group`, `resolve`, `pack`, `load_catalog` and their types from
`monortm_tpu.lines`, so that the port imports nothing of the JAX package.
`load_catalog` takes the port's native helper for group + resolve
(`native.group_resolve_lines`, a copy of the JAX package's C++ source)
where the lines carry no IBRD data, as the JAX package does, and the
pure-Python group -> resolve -> pack path, its oracle, where they do or
where MONORTM_TPU_TORCH_NATIVE=0.  The port's models read only a catalog's
fields, so a `PackedCatalog` of either package serves;
tests/test_torch_copies.py holds the two packers equal.

Three stages, each replicating reference semantics exactly:

1. group():   GET_LNFL's per-molecule regrouping (lnfl_mod.f90:43-117),
              including line-coupling row attribution (iflg<0 rows belong
              to the preceding line's molecule; -5 rows come in
              foreign/self pairs), the int->float reinterpretation of the
              `mol` field for coupling rows (RMOL), the O2/N2
              HITRAN-air-width -> foreign-width corrections
              (lnfl_mod.f90:98-113), and the H2O alps==0 -> 5*alpf patch
              (applied in-place by HALFWHM_C, modm.f90:841).

2. resolve(): the LINES J/JJ walk (modm.f90:316-435) run once on the host,
              producing one flat record per *processed* entry with its
              line-coupling coefficient rows attached.  This includes the
              reference's quirk that the first -5 line of a block does not
              self-mix (the XG(I,J-1) test) and that its self row is then
              itself processed as a line — behavioural parity over
              interpretation.

3. pack():    padding to a tile multiple, two-float splitting of the f64
              line centres for f32 device accuracy, and precomputation of
              all temperature-independent per-line factors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch import native
from monortm_tpu_torch.data import loader
from monortm_tpu_torch.io.tape3 import RawLines, read_tape3

MXBRDMOL = 7
NMOL = 39


@dataclasses.dataclass
class GroupedLines:
    """Per-molecule entry arrays mirroring lnfl_mod module storage."""
    nblm: np.ndarray                 # [39]
    # each dict maps mol (1-based) -> array of entries in storage order
    xnu0: dict
    s0: dict
    alpf: dict
    alps: dict
    e: dict
    x: dict
    deltnu: dict
    xg: dict
    iso: dict
    rmol: dict
    sdep: dict
    brd_flg: dict
    brd_hw: dict
    brd_tmp: dict
    brd_shft: dict


def group(raw: RawLines) -> GroupedLines:
    n = len(raw)
    per: dict[int, list[int]] = {}
    mo_of = np.zeros(n, np.int64)
    mo_prev = 0
    for k in range(n):
        iflg = int(raw.iflg[k])
        if 0 <= iflg <= 100:
            mo = int(raw.mol[k]) % 100
        elif iflg in (-1, -2, -3):
            mo = int(raw.mol[k - 1]) % 100 if k > 0 else 0
        elif iflg == -5:
            if k > 0 and int(raw.iflg[k - 1]) >= 0:
                mo = int(raw.mol[k - 1]) % 100
                mo_prev = mo
            else:
                mo = mo_prev
        else:
            raise ValueError(f"unrecognised line-coupling flag {iflg}")
        mo_of[k] = mo
        per.setdefault(mo, []).append(k)

    fields = {name: {} for name in ("xnu0", "s0", "alpf", "alps", "e", "x",
                                    "deltnu", "xg", "iso", "rmol", "sdep",
                                    "brd_flg", "brd_hw", "brd_tmp",
                                    "brd_shft")}
    nblm = np.zeros(NMOL, np.int64)
    for mo, idx in per.items():
        if not (1 <= mo <= NMOL):
            continue
        idx = np.asarray(idx)
        nblm[mo - 1] = len(idx)
        iflg = raw.iflg[idx]
        xg = np.where(iflg >= 0, -iflg, iflg).astype(np.float64)
        alpf = raw.alfa[idx].astype(np.float64)
        alps = raw.hwhm[idx].astype(np.float64)
        deltnu = raw.pshift[idx].astype(np.float64)
        brd_flg = raw.brd_mol_flg[idx].astype(np.int64)
        brd_shft = raw.brd_mol_shft[idx].astype(np.float64)
        normal = iflg >= 0
        if mo == 7:      # O2: air width -> true foreign width (rvmr=0.21)
            rvmr = 0.21
            alpf = np.where(normal, (alpf - rvmr * alps) / (1.0 - rvmr), alpf)
            sbs = normal & (brd_flg[:, 6] > 0)
            deltnu = np.where(
                sbs, (deltnu - rvmr * brd_shft[:, 6]) / (1.0 - rvmr), deltnu)
        if mo == 22:     # N2 (rvmr=0.79); no SBS shift data yet
            rvmr = 0.79
            alpf = np.where(normal, (alpf - rvmr * alps) / (1.0 - rvmr), alpf)
        if mo == 1:      # H2O: missing self width -> 5*foreign (modm.f90:841)
            alps = np.where(alps == 0.0, 5.0 * alpf, alps)

        fields["xnu0"][mo] = raw.vnu[idx].astype(np.float64)
        fields["s0"][mo] = raw.sp[idx].astype(np.float64)
        fields["alpf"][mo] = alpf
        fields["alps"][mo] = alps
        fields["e"][mo] = raw.epp[idx].astype(np.float64)
        fields["x"][mo] = raw.tmpalf[idx].astype(np.float64)
        fields["deltnu"][mo] = deltnu
        fields["xg"][mo] = xg
        fields["iso"][mo] = (np.abs(raw.mol[idx]).astype(np.int64) % 1000) // 100
        fields["rmol"][mo] = raw.mol[idx].astype("<i4").view("<f4").astype(np.float64)
        fields["sdep"][mo] = raw.speed_dep[idx].astype(np.float64)
        fields["brd_flg"][mo] = brd_flg
        fields["brd_hw"][mo] = raw.brd_mol_hw[idx].astype(np.float64)
        fields["brd_tmp"][mo] = raw.brd_mol_tmp[idx].astype(np.float64)
        fields["brd_shft"][mo] = brd_shft
    return GroupedLines(nblm=nblm, **fields)


@dataclasses.dataclass
class ResolvedLines:
    """Flat per-processed-line arrays (LINES walk already applied)."""
    mol: np.ndarray        # [N] 1-based molecule id
    nu0: np.ndarray        # [N] f8 line centre
    s0: np.ndarray
    e: np.ndarray
    alpf: np.ndarray
    alps: np.ndarray
    tdep: np.ndarray       # X (width temperature exponent)
    pshift: np.ndarray
    iso: np.ndarray
    sdep: np.ndarray
    xg: np.ndarray         # 0 / -1 / -3 / -5 flag of this line
    a1: np.ndarray         # [N, 4] coupling A row 1 (foreign)
    b1: np.ndarray
    a2: np.ndarray         # [N, 4] row 2 (self) when self_mix
    b2: np.ndarray
    self_mix: np.ndarray   # [N] bool
    brd_flg: np.ndarray    # [N, 7]
    brd_hw: np.ndarray
    brd_tmp: np.ndarray
    brd_shft: np.ndarray

    def __len__(self):
        return len(self.nu0)


def resolve(g: GroupedLines) -> ResolvedLines:
    cols = {k: [] for k in ("mol", "nu0", "s0", "e", "alpf", "alps", "tdep",
                            "pshift", "iso", "sdep", "xg", "a1", "b1", "a2",
                            "b2", "self_mix", "brd_flg", "brd_hw", "brd_tmp",
                            "brd_shft")}
    for mo in range(1, NMOL + 1):
        nb = int(g.nblm[mo - 1])
        if nb == 0:
            continue
        xnu0 = g.xnu0[mo]
        s0 = g.s0[mo]
        alpf = g.alpf[mo]
        alps = g.alps[mo]
        e = g.e[mo]
        x = g.x[mo]
        deltnu = g.deltnu[mo]
        xg = g.xg[mo]
        iso = g.iso[mo]
        rmol = g.rmol[mo]
        sdep = g.sdep[mo]

        j = 0
        while j < nb:
            jj = j
            a1 = np.zeros(4)
            b1 = np.zeros(4)
            a2 = np.zeros(4)
            b2 = np.zeros(4)
            self_mix = False
            if xg[j] in (-1.0, -3.0, -5.0):
                jj = j + 1
                if jj < nb:
                    a1 = np.array([xnu0[jj], alpf[jj], rmol[jj], x[jj]])
                    b1 = np.array([s0[jj], e[jj], alps[jj], deltnu[jj]])
                # reference: XG(I,J-1) test (modm.f90:339); J=1 in Fortran
                # reads out of bounds — treated here as "not -5"
                if xg[j] == -5.0 and j >= 1 and xg[j - 1] == -5.0:
                    jj += 1
                    if jj < nb:
                        a2 = np.array([xnu0[jj], alpf[jj], rmol[jj], x[jj]])
                        b2 = np.array([s0[jj], e[jj], alps[jj], deltnu[jj]])
                        self_mix = True

            cols["mol"].append(mo)
            cols["nu0"].append(xnu0[j])
            cols["s0"].append(s0[j])
            cols["e"].append(e[j])
            cols["alpf"].append(alpf[j])
            cols["alps"].append(alps[j])
            cols["tdep"].append(x[j])
            cols["pshift"].append(deltnu[j])
            cols["iso"].append(iso[j])
            cols["sdep"].append(sdep[j])
            cols["xg"].append(xg[j])
            cols["a1"].append(a1)
            cols["b1"].append(b1)
            cols["a2"].append(a2)
            cols["b2"].append(b2)
            cols["self_mix"].append(self_mix)
            cols["brd_flg"].append(g.brd_flg[mo][j])
            cols["brd_hw"].append(g.brd_hw[mo][j])
            cols["brd_tmp"].append(g.brd_tmp[mo][j])
            cols["brd_shft"].append(g.brd_shft[mo][j])
            j = jj + 1

    def arr(k, dt=np.float64):
        return np.asarray(cols[k], dtype=dt) if cols[k] else np.zeros((0,), dt)

    return ResolvedLines(
        mol=arr("mol", np.int64), nu0=arr("nu0"), s0=arr("s0"), e=arr("e"),
        alpf=arr("alpf"), alps=arr("alps"), tdep=arr("tdep"),
        pshift=arr("pshift"), iso=arr("iso", np.int64), sdep=arr("sdep"),
        xg=arr("xg"),
        a1=np.asarray(cols["a1"], np.float64).reshape(-1, 4),
        b1=np.asarray(cols["b1"], np.float64).reshape(-1, 4),
        a2=np.asarray(cols["a2"], np.float64).reshape(-1, 4),
        b2=np.asarray(cols["b2"], np.float64).reshape(-1, 4),
        self_mix=arr("self_mix", bool),
        brd_flg=np.asarray(cols["brd_flg"], np.int64).reshape(-1, MXBRDMOL),
        brd_hw=np.asarray(cols["brd_hw"], np.float64).reshape(-1, MXBRDMOL),
        brd_tmp=np.asarray(cols["brd_tmp"], np.float64).reshape(-1, MXBRDMOL),
        brd_shft=np.asarray(cols["brd_shft"], np.float64).reshape(-1, MXBRDMOL),
    )


@dataclasses.dataclass
class PackedCatalog:
    """Device-ready catalog; all arrays padded to a multiple of `tile`.

    Invalid (padding) slots have valid=False, s0adj=0, nu0=1 so every
    downstream formula stays finite and contributes exactly zero.
    """
    n_lines: int           # true line count
    mol: np.ndarray        # i4 [N]
    iso_flat: np.ndarray   # i4 [N] = (mol-1)*9 + clip(iso,1,9)-1  (scor gather)
    nu0: np.ndarray        # f8 [N]
    nu0_hi: np.ndarray     # f4 [N] two-float split of nu0
    nu0_lo: np.ndarray     # f4 [N]
    s0adj: np.ndarray      # f8 [N]  S0 * nu0 * (1 - exp(-RADCT nu0/T0))
    e: np.ndarray
    alpf: np.ndarray
    alps: np.ndarray
    tdep: np.ndarray
    pshift: np.ndarray
    sdep: np.ndarray
    mass: np.ndarray       # f8 [N] isotope mass (SMASS)
    xg: np.ndarray         # i4 [N] 0/-1/-3/-5
    a1: np.ndarray         # [N,4]
    b1: np.ndarray
    a2: np.ndarray
    b2: np.ndarray
    self_mix: np.ndarray   # bool [N]
    valid: np.ndarray      # bool [N]
    brd_flg: np.ndarray    # [N,7]
    brd_hw: np.ndarray
    brd_tmp: np.ndarray
    brd_shft: np.ndarray

    def __len__(self):
        return len(self.nu0)


def pack(r: ResolvedLines, tile: int = 128) -> PackedCatalog:
    n = len(r)
    npad = max(tile, ((n + tile - 1) // tile) * tile)
    iso = np.clip(r.iso, 1, 9)

    isotab = loader.isotopes()
    mass = isotab["smass"][np.clip(r.mol - 1, 0, NMOL - 1),
                           iso - 1] if n else np.zeros(0)
    # fall back to principal isotope when the (mol, iso) slot is empty
    if n:
        m0 = isotab["smass"][np.clip(r.mol - 1, 0, NMOL - 1), 0]
        mass = np.where(mass > 0, mass, m0)

    s0adj = r.s0 * (r.nu0 * (1.0 - np.exp(-cst.RADCT * r.nu0 / cst.T0)))

    def padded(a, fill=0.0, dt=None):
        a = np.asarray(a)
        shape = (npad,) + a.shape[1:]
        out = np.full(shape, fill, dtype=dt or a.dtype)
        out[:n] = a
        return out

    nu0 = padded(r.nu0, 1.0)
    nu0_hi = nu0.astype(np.float32)
    nu0_lo = (nu0 - nu0_hi.astype(np.float64)).astype(np.float32)
    return PackedCatalog(
        n_lines=n,
        mol=padded(r.mol, 1, np.int32),
        iso_flat=padded((r.mol - 1) * 9 + iso - 1, 0, np.int32),
        nu0=nu0, nu0_hi=nu0_hi, nu0_lo=nu0_lo,
        s0adj=padded(s0adj),
        e=padded(r.e), alpf=padded(r.alpf, 0.1), alps=padded(r.alps, 0.1),
        tdep=padded(r.tdep), pshift=padded(r.pshift),
        sdep=padded(r.sdep), mass=padded(mass, 1.0),
        xg=padded(r.xg, 0, np.int32),
        a1=padded(r.a1), b1=padded(r.b1), a2=padded(r.a2), b2=padded(r.b2),
        self_mix=padded(r.self_mix, False),
        valid=padded(np.ones(n, bool), False),
        brd_flg=padded(r.brd_flg, 0, np.int32),
        brd_hw=padded(r.brd_hw), brd_tmp=padded(r.brd_tmp),
        brd_shft=padded(r.brd_shft),
    )


def load_catalog(path, v1: float, v2: float, tile: int = 128) -> PackedCatalog:
    """TAPE3 file -> packed catalog for wavenumber range [v1, v2].

    Groups and resolves with the native helper (`native.enabled`) unless
    species-specific-broadening data is present, whose arrays ride the
    Python path, as in the JAX package.
    """
    raw = read_tape3(path, v1, v2)
    if len(raw) and not np.any(raw.brd_mol_flg) and native.enabled():
        return pack(native.group_resolve_lines(raw), tile=tile)
    return pack(resolve(group(raw)), tile=tile)
