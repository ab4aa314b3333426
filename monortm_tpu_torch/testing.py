"""Synthetic fixtures for tests, the chip smoke run and benchmarks.

Copies of `monortm_tpu.testing.synthetic_catalog_mw`, `synthetic_state`
and `make_minimal_rundir` on the port's own catalog packer and TAPE3
writer: the same numpy code, drawn from the same `default_rng(seed)` in
the same order, so both packages see identical inputs.  `make_xsec_rundir`
writes an IATM=0, IXSECT=1 rundir inside the synthetic cross-section band
(`write_xsec_data`, the FSCDXS and xs/ files of tests/test_xsec.py's
form, widened to two species).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from monortm_tpu_torch.io.tape3 import RawLines
from monortm_tpu_torch.lines import PackedCatalog, group, pack, resolve
from monortm_tpu_torch.convert import state_from_numpy
from monortm_tpu_torch.types import LayerState


def synthetic_catalog_mw(n_h2o: int = 64, n_o2: int = 48, seed: int = 0,
                         tile: int = 128, raw_lines: bool = False
                         ) -> PackedCatalog | RawLines:
    """A microwave-band-like synthetic catalog (0-60 cm^-1).

    raw_lines=True returns the RawLines instead (e.g. for write_tape3)."""
    rng = np.random.default_rng(seed)
    rows = []

    def line(vnu, sp, alfa, epp, mol, iso, hwhm, tmpalf, pshift, iflg=0,
             sdep=0.0):
        rows.append([vnu, sp, alfa, epp, mol + 100 * iso, hwhm, tmpalf,
                     pshift, iflg, sdep])

    # H2O 22.2 GHz-like + rotational lines
    for v in np.sort(rng.uniform(0.5, 60.0, n_h2o)):
        line(v, 10 ** rng.uniform(-28, -24), rng.uniform(0.06, 0.1),
             rng.uniform(20, 600), 1, int(rng.integers(1, 4)),
             rng.uniform(0.3, 0.5), rng.uniform(0.6, 0.8),
             rng.uniform(-0.02, 0.02), sdep=float(rng.uniform(0, 0.12)))
    # O2 60 GHz complex-like lines with -1 coupling rows
    for v in np.sort(rng.uniform(1.5, 10.0, n_o2)):
        line(v, 10 ** rng.uniform(-26, -25), rng.uniform(0.04, 0.05),
             rng.uniform(0, 100), 7, 1, rng.uniform(0.04, 0.05),
             rng.uniform(0.7, 0.75), 0.0, iflg=1)
        y = rng.uniform(-0.02, 0.02, 4)
        g = rng.uniform(-2e-4, 0.0, 4)
        mol_bits = int(np.float32(y[2]).view(np.int32))
        rows.append([y[0], g[0], y[1], g[1], mol_bits, g[2], y[3], g[3],
                     -1, 0.0])
    # N2 lines
    for v in (4.0, 9.7):
        line(v, 1e-30, 0.05, 30.0, 22, 1, 0.048, 0.7, 0.0)

    n = len(rows)
    raw = RawLines(
        vnu=np.asarray([r[0] for r in rows], np.float64),
        sp=np.asarray([r[1] for r in rows], np.float32),
        alfa=np.asarray([r[2] for r in rows], np.float32),
        epp=np.asarray([r[3] for r in rows], np.float32),
        mol=np.asarray([r[4] for r in rows], np.int32),
        hwhm=np.asarray([r[5] for r in rows], np.float32),
        tmpalf=np.asarray([r[6] for r in rows], np.float32),
        pshift=np.asarray([r[7] for r in rows], np.float32),
        iflg=np.asarray([r[8] for r in rows], np.int32),
        brd_mol_flg=np.zeros((n, 7), np.int32),
        brd_mol_hw=np.zeros((n, 7), np.float32),
        brd_mol_tmp=np.zeros((n, 7), np.float32),
        brd_mol_shft=np.zeros((n, 7), np.float32),
        speed_dep=np.asarray([r[9] for r in rows], np.float32),
    )
    if raw_lines:
        return raw
    return pack(resolve(group(raw)), tile=tile)


CAPACITY_LINES = 250_000
CAPACITY_SEED = 11
CAPACITY_TILE = 256


# chip_smoke's phase 10: sub-continuum -> (species, a wavenumber range
# inside its activation test); continuum_grid("ir") takes three points
# of each
IR_BANDS = {
    "o3_chap": ("o3", 9000.0, 24000.0),
    "o3_hh": ("o3", 27500.0, 40700.0),
    "o3_uv": ("o3", 40900.0, 53900.0),
    "o2_fund": ("o2", 1400.0, 1800.0),
    "o2_inf1": ("o2", 7600.0, 8400.0),
    "o2_inf2": ("o2", 9200.0, 10900.0),
    "o2_aband": ("o2", 13000.0, 13200.0),
    "o2_vis": ("o2", 15100.0, 29800.0),
    "o2_herz": ("o2", 36100.0, 40000.0),
    "o2_fuv": ("o2", 56800.0, 60000.0),
    "n2_fund": ("n2", 2050.0, 2850.0),
    "n2_overtone": ("n2", 4400.0, 4900.0),
    "rayleigh": ("rayleigh", 830.0, 900.0),
}

def continuum_grid(name: str, nwn: int | None = None):
    """(wn, dvset) of a grid the continuum tests and chip_smoke share:
    "mw", upstream example case 1's 101 wavenumbers over 0.2-1.2 cm^-1
    (the retrieval cell's); "envelope", the capacity envelope's band from
    0.3 cm^-1 by DVSET 0.69e-3 over 80000 points (`nwn` fewer points
    widen the step, as `envelope.py --nwn` does; 2000 by default here);
    "ir", three points in each band of IR_BANDS, an explicit list
    (dvset 0), where every sub-continuum and Rayleigh are active."""
    if name == "mw":
        return np.linspace(0.2, 1.2, 101), 0.01
    if name == "envelope":
        nwn = nwn or 2000
        dvset = 0.69e-3 * (80000 - 1) / (nwn - 1)
        return 0.3 + dvset * np.arange(nwn), dvset
    if name == "ir":
        return np.unique(np.concatenate([np.linspace(a, b, 3) for _, a, b
                                         in IR_BANDS.values()])), 0.0
    raise ValueError(f"unknown continuum grid {name!r}")


def continuum_rows(nlay: int = 40, batch: int = 2, seed: int = 0, *,
                   device="cpu"):
    """Flat float32 rows (p, t, wk [R, 39], wbrod, clw) of a layered state
    (`synthetic_state`) with liquid water in a third of its layers: the
    continuum kernels' tests and chip_smoke's phase 17."""
    st = synthetic_state(nlay=nlay, batch=batch, seed=seed, device=device,
                         dtype=torch.float32)
    clw = st.clw.clone()
    clw[..., 3:nlay // 3 + 3] = 0.05
    return (st.p.reshape(-1), st.t.reshape(-1), st.wkl.reshape(-1, 39),
            st.wbrodl.reshape(-1), clw.reshape(-1))


def continuum_eager(plan, p, t, wk, wbrod, clw, dtype=torch.float32):
    """The continuum and cloud stage as `ODModel`'s eager path forms it,
    the cloud on the plan's grid: the seven outputs in
    `ops.continuum_kernel.OUTPUTS` order."""
    from monortm_tpu_torch.ops.cloud import od_clw
    from monortm_tpu_torch.ops.continuum import SPECIES
    oc = plan(p, t, wk, wbrod, dtype=dtype)
    return [oc[k] for k in SPECIES] + [od_clw(
        plan.wn_t.to(dtype), t[..., None], clw[..., None])]


def continuum_cotangents(plan, n_rows: int, kind: str, seed: int = 0, *,
                         device="cpu"):
    """Seeded cotangents of the stage's seven outputs [n_rows, W]:
    "random" (normal, each its own), "shared" (one positive array for
    all, as the OD sum hands them on) or "cloud" (the cloud's alone)."""
    gen = torch.Generator().manual_seed(seed)
    shape = (n_rows, len(plan.wn))
    if kind == "random":
        return [torch.randn(shape, generator=gen).to(device)
                for _ in range(7)]
    g = (torch.rand(shape, generator=gen) + 0.5).to(device)
    return [g] * 7 if kind == "shared" else [None] * 6 + [g]


def capacity_catalog(raw_lines: bool = False) -> PackedCatalog | RawLines:
    """The reference's design capacity of one molecule (250k lines,
    lnfl_mod.f90:5): CAPACITY_LINES H2O lines spread evenly over
    0.5-3000 cm^-1, the recipe of the JAX package's capacity check
    (tests/test_pallas.py::test_pallas_capacity_250k_lines_8k_wn), packed
    to CAPACITY_TILE (the raw lines with `raw_lines`)."""
    n = CAPACITY_LINES
    rng = np.random.default_rng(CAPACITY_SEED)
    nu = np.sort(rng.uniform(0.5, 3000.0, n))
    raw = RawLines(
        vnu=nu,
        sp=10 ** rng.uniform(-27, -23, n).astype(np.float32),
        alfa=rng.uniform(0.04, 0.1, n).astype(np.float32),
        epp=rng.uniform(0, 700, n).astype(np.float32),
        mol=(1 + 100 * 1) * np.ones(n, np.int32),
        hwhm=rng.uniform(0.3, 0.5, n).astype(np.float32),
        tmpalf=rng.uniform(0.6, 0.8, n).astype(np.float32),
        pshift=rng.uniform(-0.02, 0.02, n).astype(np.float32),
        iflg=np.zeros(n, np.int32),
        brd_mol_flg=np.zeros((n, 7), np.int32),
        brd_mol_hw=np.zeros((n, 7), np.float32),
        brd_mol_tmp=np.zeros((n, 7), np.float32),
        brd_mol_shft=np.zeros((n, 7), np.float32),
        speed_dep=np.zeros(n, np.float32),
    )
    if raw_lines:
        return raw
    return pack(resolve(group(raw)), tile=CAPACITY_TILE)


# minimal IATM=0 run inputs for pipeline-level tests (a copy of the JAX
# package's): 4 explicit wavenumbers (V1<0 list option), NMOL=7, downwelling
_MIN_TAPE5 = """\
* synthetic minimal case (IATM=0, explicit wn list)
$ Rundeck test
    1         1    0    1    0         0    0    0    0    0         0
-0.200E+00 8.800E+00 0.000E+00 0.100E-00 0.000E+00 0.000E+00 0.000E+00 0.000E+00    0      0.000E+00    0
4
0.789344
0.79828
1.043027
1.051763
     0.    1.0       0.000E+00 0.000E+00 0.000E+00 0.000E+00 0.000E+00
%%%%
"""

_MIN_PROF_REC = """\
 1  2    7  1.000000TEST    ATM          0.00        20.00         0.000      0
{p0:15.7E}{t0:10.2f}              3   0.000 1013.00 288.20  0.700  931.64 283.65  0.030
{w0:15.7E}  5.6517653E+20  4.7120675E+16  5.4804989E+17  2.5390745E+17  2.9115142E+18  3.5794498E+23  1.3375841E+24
  8.9382500E+02    281.40              3                         1.400 855.746 279.10  0.000
  9.5935612E+21  5.2824106E+20  4.7150147E+16  5.1223340E+17  2.3170005E+17  2.7212402E+18  3.3455267E+23  1.2501701E+24
"""


def make_minimal_rundir(dirpath, nprof: int = 1) -> None:
    """Write MONORTM.IN + MONORTM_PROF.IN + synthetic TAPE3 into dirpath
    (a case-4-style IATM=0 run with `nprof` slightly-perturbed profiles)."""
    from pathlib import Path
    from monortm_tpu_torch.io.tape3 import write_tape3

    d = Path(dirpath)
    (d / "MONORTM.IN").write_text(_MIN_TAPE5)
    recs = [_MIN_PROF_REC.format(p0=972.2109 * (1 + 0.002 * i),
                                 t0=285.94 + 0.5 * i,
                                 w0=1.2207059e22 * (1 + 0.01 * i))
            for i in range(nprof)]
    (d / "MONORTM_PROF.IN").write_text("".join(recs))
    raw = synthetic_catalog_mw(raw_lines=True)
    write_tape3(d / "TAPE3", raw)


def make_wide_rundir(dirpath, nprof: int = 3, nwn: int = 300):
    """make_minimal_rundir with `nwn` wavenumbers over 0.3-8.7 cm^-1 in
    MONORTM.IN's list (the default 300 split into several 128- and
    64-wide tiles, the last ragged); returns the directory."""
    from pathlib import Path

    d = Path(dirpath)
    make_minimal_rundir(d, nprof=nprof)
    head, rest = _MIN_TAPE5.split("\n4\n", 1)
    tail = rest.split("1.051763\n", 1)[1]
    wn = np.linspace(0.3, 8.7, nwn)
    (d / "MONORTM.IN").write_text(
        head + f"\n{nwn}\n" + "".join(f"{w:.6f}\n" for w in wn) + tail)
    return d


def synthetic_state(nlay: int = 26, batch: int | None = None,
                    seed: int = 0, *, device="cuda",
                    dtype: torch.dtype = torch.float64) -> LayerState:
    """A US-standard-like layered state (surface -> top)."""
    rng = np.random.default_rng(seed)
    p = np.geomspace(1000.0, 50.0, nlay)
    t = 288.0 - 60.0 * (1.0 - p / 1000.0)
    tz = np.concatenate([[t[0] + 2.0], t - 1.0])
    wkl = np.zeros((nlay, 39))
    col = p / p.sum()
    wkl[:, 0] = 4.5e22 * col * np.exp(-np.arange(nlay) / 6.0) * 6
    wkl[:, 1] = 7.5e21 * col
    wkl[:, 2] = 9.0e18 * col
    wkl[:, 6] = 4.5e24 * col
    wkl[:, 21] = 1.7e25 * col
    wbrodl = 2.0e22 * col
    clw = np.zeros(nlay)
    clw[2] = 0.03

    def b(x):
        if batch is None:
            return x
        out = np.broadcast_to(x, (batch,) + x.shape).copy()
        out *= (1.0 + 0.01 * rng.standard_normal((batch,) + (1,) * x.ndim))
        return out

    host = SimpleNamespace(p=b(p), t=b(t), tz=b(tz), wkl=b(wkl),
                           wbrodl=b(wbrodl), clw=b(clw))
    return state_from_numpy(host, device, dtype)


# the synthetic cross-section band (tests/test_xsec.py's), its species
# (name -> centre and width of a Gaussian bump, cm^-1) and their columns
# (molec/cm^2) in make_xsec_rundir; the catalog's lines are moved by
# XS_LINE_SHIFT into the band
XS_BAND = (780.0, 820.0)
XS_SPECIES = {"CCL4": (800.0, 8.0), "F11": (806.0, 5.0)}
XS_COLUMNS = {"CCL4": 1.0e15, "F11": 2.5e15}
XS_LINE_SHIFT = 770.0


def write_xsec_data(dirpath, species=tuple(XS_SPECIES)) -> None:
    """FSCDXS and one xs/ file per species and temperature (216 K at 170
    Torr, 296 K at 760 Torr): cross-sections on 401 points over XS_BAND,
    written as tests/test_xsec.py writes them."""
    from pathlib import Path

    d = Path(dirpath)
    (d / "xs").mkdir(parents=True, exist_ok=True)
    v1, v2 = XS_BAND
    npts = 401
    vv = np.linspace(v1, v2, npts)
    recs = []
    for name in species:
        centre, width = XS_SPECIES[name]
        files = []
        for temp, pres in ((216.0, 170.0), (296.0, 760.0)):
            amp = 1.0e-18 * (1.0 + (296.0 - temp) / 296.0)
            data = amp * np.exp(-((vv - centre) / width) ** 2)
            fn = f"{name}_T{temp:.0f}"
            hdr = (f"{name:<10s}{v1:10.4f}{v2:10.4f}{npts:10d}{temp:10.3g}"
                   f"{pres:10.3g}{1.0:10.3g}" + " " * 20 + "      TORR")
            rows = [hdr] + [" ".join(f"{x:12.5e}" for x in data[i:i + 5])
                            for i in range(0, npts, 5)]
            (d / "xs" / fn).write_text("\n".join(rows) + "\n")
            files.append(fn)
        recs.append(f"{name:<10s}{v1:10.4f}{v2:10.4f}{0.1:10.8f}"
                    f"{len(files):5d}" + " " * 5 + f"{91:5d}N" + " " * 4
                    + "".join(f"{f:<10s}" for f in files))
    (d / "FSCDXS").write_text("\n".join([" header", " header2", *recs, "%"])
                              + "\n")


def xsec_tape3_lines(n_h2o: int = 64, n_o2: int = 48) -> RawLines:
    """synthetic_catalog_mw's lines moved by XS_LINE_SHIFT into the
    cross-section band (line-coupling rows, whose wavenumber field holds a
    coefficient, stay), the first N2 line put first: so every 250-record
    panel of a TAPE3 of bench's 3074 lines ends on a line, not on a
    coupling record, which the reader would skip the panel for."""
    raw = synthetic_catalog_mw(n_h2o=n_h2o, n_o2=n_o2, raw_lines=True)
    order = np.r_[len(raw) - 2, :len(raw) - 2, len(raw) - 1]
    raw = RawLines(**{f: getattr(raw, f)[order]
                      for f in RawLines.__dataclass_fields__})
    raw.vnu[raw.iflg >= 0] += XS_LINE_SHIFT
    return raw


def xsec_block(names, xamnt, p, t) -> str:
    """The cross-section block that follows a profile in MONORTM_PROF.IN
    (monortm.f90:492-532, as `io.profin` reads it): IXMOLS, the names
    (7A10), the header (1X,I1,I3,I5,F10.2) and per layer a P/T record and
    the amounts (7E15.7)."""
    n, nlay = xamnt.shape
    rows = [f"{n:5d}", "".join(f"{m:<10s}" for m in names),
            f" {0:1d}{nlay:3d}{n:5d}{0.0:10.2f}"]
    for l in range(nlay):
        rows.append(f"{p[l]:15.7E}{t[l]:10.2f}")
        rows.append("".join(f"{x:15.7E}" for x in xamnt[:, l]))
    return "\n".join(rows) + "\n"


def make_xsec_rundir(dirpath, nprof: int = 1, nlay: int = 4, nwn: int = 16,
                     n_h2o: int = 64, n_o2: int = 48,
                     species=tuple(XS_SPECIES), keep: int | None = None,
                     wn_step: int = 1) -> None:
    """An IATM=0, IXSECT=1 rundir: MONORTM.IN listing every `wn_step`-th
    of `nwn` wavenumbers over 781-819 cm^-1, MONORTM_PROF.IN with the
    first `keep`
    (default: all) profiles of synthetic_state(nlay, batch=nprof), each
    followed by its cross-section block (XS_COLUMNS spread as the layers'
    pressure), the TAPE3 of xsec_tape3_lines, and write_xsec_data's
    files."""
    from pathlib import Path
    from monortm_tpu_torch.io.profin import Profile
    from monortm_tpu_torch.io.tape3 import write_tape3
    from monortm_tpu_torch.io.tape7 import write_tape7
    from monortm_tpu_torch.types import HostState, ProfileMeta

    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    write_xsec_data(d, species)
    write_tape3(d / "TAPE3", xsec_tape3_lines(n_h2o, n_o2))
    wn = np.linspace(XS_BAND[0] + 1.0, XS_BAND[1] - 1.0, nwn)[::wn_step]
    rec12 = [" "] * 70
    for pos in (4, 14, 24, 39, 69):      # HIRAC CNTNM EMIT PLOT XSECT
        rec12[pos] = "1"
    rec12[49] = "0"                      # IATM
    (d / "MONORTM.IN").write_text(
        "$ synthetic IXSECT=1 run\n" + "".join(rec12) + "\n"
        + f"{-wn[0]:10.3E}{wn[-1]:10.3E}" + " 0.000E+00" * 6
        + "    0      0.000E+00    0\n"
        + f"{len(wn)}\n" + "".join(f"{w:19.13f}\n" for w in wn)
        + "     0.    1.0       0.000E+00 0.000E+00 0.000E+00 0.000E+00 "
        "0.000E+00\n%%%%\n")
    st = synthetic_state(nlay=nlay, batch=nprof, device="cpu",
                         dtype=torch.float64)
    pz = np.geomspace(1013.0, 45.0, nlay + 1)
    altz = -7.0 * np.log(pz / 1013.0)
    part = d / "profile.tape7"
    text = []
    for i in range(nprof if keep is None else keep):
        host = HostState(**{f: getattr(st, f)[i].numpy()
                            for f in ("p", "t", "tz", "wkl", "wbrodl",
                                      "clw")})
        prof = Profile(state=host, meta=ProfileMeta(
            nmol=22, angle=0.0, h1=0.0, h2=float(altz[-1]), altz=altz,
            pz=pz), hmod="SYNTHETIC")
        write_tape7(part, [prof], xid="xsec")
        share = host.p / host.p.sum()
        xamnt = np.stack([XS_COLUMNS[m] * share for m in species])
        text.append(part.read_text()
                    + xsec_block(species, xamnt, host.p, host.t))
    part.unlink()
    (d / "MONORTM_PROF.IN").write_text("".join(text))


def prologue_catalog(n: int = 96, seed: int = 0) -> dict:
    """Host catalog columns (`catalog_to_host`'s layout, both the float64
    centre and its float32 split) whose lines reach every branch of the
    prologue: H2O (3 isotopologues), coupled O2 (xg = -1), CO2 (plain,
    xg = -3, xg = -5 with self mixing), N2 (molecule 22, outside the IBRD
    molecules), xg = -3 / -5 on H2O, IBRD flags, speed dependence on half
    the lines, and 8 padding lines (valid = 0, s0adj = 0, nu0 = 1)."""
    rng = np.random.default_rng(seed)
    kinds = np.arange(n) % 8
    mol = np.choose(kinds, [1, 1, 7, 2, 2, 2, 22, 1]).astype(np.int32)
    iso = np.where(mol == 1, 1 + np.arange(n) % 3, 1)
    xg = np.choose(kinds, [0, -3, -1, 0, -3, -5, 0, -5]).astype(np.int32)
    nu0 = np.sort(rng.uniform(0.5, 60.0, n))
    c = {
        "mol": mol, "iso_flat": ((mol - 1) * 9 + iso - 1).astype(np.int32),
        "nu0": nu0,
        "s0adj": 10 ** rng.uniform(-24, -20, n),
        "e": rng.uniform(0.0, 900.0, n),
        "alpf": rng.uniform(0.02, 0.1, n), "alps": rng.uniform(0.05, 0.5, n),
        "tdep": rng.uniform(0.5, 0.8, n),
        "pshift": rng.uniform(-0.01, 0.01, n),
        "sdep": np.where(np.arange(n) % 2, rng.uniform(0.02, 0.12, n), 0.0),
        "mass": np.choose(kinds, [18.0, 19.0, 32.0, 44.0, 45.0, 44.0, 28.0,
                                  20.0]).astype(np.float64),
        "xg": xg,
        "a1": rng.uniform(-0.5, 0.5, (n, 4)),
        "b1": rng.uniform(-0.05, 0.05, (n, 4)),
        "a2": rng.uniform(-0.5, 0.5, (n, 4)),
        "b2": rng.uniform(-0.05, 0.05, (n, 4)),
        "self_mix": (xg == -5) & (np.arange(n) % 3 != 0),
        "valid": np.ones(n, bool),
        "brd_flg": ((rng.uniform(size=(n, 7)) < 0.4)
                    & (mol[:, None] <= 7)).astype(np.int32),
        "brd_hw": rng.uniform(0.02, 0.1, (n, 7)),
        "brd_tmp": rng.uniform(0.5, 0.8, (n, 7)),
        "brd_shft": rng.uniform(-0.01, 0.01, (n, 7)),
    }
    # a line of every molecule flagged for its own broadener, and one not
    c["brd_flg"][0, 0] = 1
    c["brd_flg"][8, 0] = 0
    pad = slice(n - 8, n)
    c["valid"][pad] = False
    c["s0adj"][pad] = 0.0
    c["nu0"][pad] = 1.0
    c["mol"][pad] = 1
    c["iso_flat"][pad] = 0
    for k in ("s0adj", "e", "alpf", "alps", "tdep", "pshift", "sdep", "mass",
              "a1", "b1", "a2", "b2", "brd_hw", "brd_tmp", "brd_shft"):
        c[k] = np.asarray(c[k], np.float32)
    c["nu0_hi"] = c["nu0"].astype(np.float32)
    c["nu0_lo"] = (c["nu0"] - c["nu0_hi"].astype(np.float64)).astype(
        np.float32)
    return c


# the prologue's test rows: temperatures below, in and above each TEMPLC
# interval, pressures from the surface to the mesosphere
PROLOGUE_T = (180.0, 215.0, 262.0, 296.0, 318.0, 352.0, 247.0, 199.5)
PROLOGUE_P = (1013.0, 700.0, 300.0, 80.0, 12.0, 1.5, 0.2, 0.05)


def prologue_rows(n_rep: int = 1, seed: int = 1, dtype=torch.float64,
                  device="cpu"):
    """Flat layer rows for the prologue: p, t, wk [L, 39], wbrod,
    scor_flat [L, 351] of L = 8 * n_rep rows, with temperatures below,
    in and above each TEMPLC interval (one on a node) and pressures from
    the surface to the mesosphere."""
    rng = np.random.default_rng(seed)
    p = np.tile(PROLOGUE_P, n_rep) * rng.uniform(0.9, 1.1, 8 * n_rep)
    t = np.tile(PROLOGUE_T, n_rep) + rng.uniform(-0.3, 0.3, 8 * n_rep)
    t[6::8] = 250.0                       # on a TEMPLC node
    L = len(p)
    wk = np.zeros((L, 39))
    col = p[:, None] * 1e19
    wk[:, 0] = (col * rng.uniform(0.5, 40.0, (L, 1)))[:, 0]
    wk[:, 1] = (col * 4.0)[:, 0]
    wk[:, 2:7] = col * rng.uniform(0.001, 0.01, (L, 5))
    wk[:, 6] = (col * 2000.0)[:, 0]
    wk[:, 21] = (col * 7800.0)[:, 0]
    wbrod = (col * 100.0)[:, 0]
    scor = rng.uniform(0.5, 2.0, (L, 351))
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t_(p), t_(t), t_(wk), t_(wbrod), t_(scor)


def prologue_device_catalog(dtype=torch.float32, device="cpu",
                            **kw) -> dict:
    """`prologue_catalog` on `device` (`catalog_to_device`), its float
    columns in `dtype` (the centre's split stays float32)."""
    from monortm_tpu_torch.ops.lineshape import catalog_to_device
    host = prologue_catalog(**kw)
    f = np.float64 if dtype == torch.float64 else np.float32
    for k, v in host.items():
        if v.dtype == np.float32 and k not in ("nu0_hi", "nu0_lo"):
            host[k] = v.astype(f)
    return catalog_to_device(host, device)


def line_sum_cotangents(cat, state, cfg, dtype, lorentz=False,
                        seed: int = 2):
    """The seven operands' cotangents as the line sum's adjoint hands them
    back (`line_sum_bwd_plain`, or the all-Lorentz sum's, whose ad and
    k3v are None) for a seeded cotangent of sf at the scale of the
    columns that multiply it, over 64 wavenumbers across the band, every
    line a candidate."""
    from monortm_tpu_torch.ops.linesum import line_sum_bwd_plain, precompute
    from monortm_tpu_torch.ops.linesum_lorentz import lorentz_sum_bwd_plain
    n = cat["mol"].shape[0]
    dev = cat["mol"].device
    with torch.no_grad():
        pre = precompute(cat, *state, cfg, dtype)
    wn = np.linspace(0.3, 62.0, 64)
    wn_hi = torch.as_tensor(wn.astype(np.float32), device=dev)
    wn_lo = torch.as_tensor((wn - wn.astype(np.float32).astype(np.float64))
                            .astype(np.float32), device=dev)
    cm = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    cv = torch.ones((1, 1), dtype=torch.int32, device=dev)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (state[0].shape[0], 64, 22)) * 1e22, dtype=dtype, device=dev)
    bwd = lorentz_sum_bwd_plain if lorentz else line_sum_bwd_plain
    d = lambda v: v.to(dtype)
    return list(bwd(pre, cat["mol"], d(wn_hi), d(wn_lo), cm, cv, n, 64, 22,
                    g))
