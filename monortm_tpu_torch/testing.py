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
