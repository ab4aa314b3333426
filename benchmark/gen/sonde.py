"""Stacked radiosonde runs (IATM=1, MODEL=0), written from a seed.

`write_sondes(config, seed, n_files, n_prof, root)` draws the line
catalog and n_files x n_prof distinct sondes from the seed and writes one
TAPE3, shared, and one MONORTM.IN a file: n_prof '$' blocks, each a
sonde's records 1.2-1.4 and 3.1-3.6 in the layout of upstream example
case 3 (MONORTM.IN_NOSCALE_IATM1_dn, the file
idl/create_monortm_input_from_sonde.pro writes): user levels (MODEL=0)
in altitude, P in mb and T in K (JCHARP, JCHART `A`), H2O as relative
humidity (JCHAR `H`), the other molecules from the US standard
atmosphere (`6`), looking up (ITYPE 2, ANGLE 0) from the surface H1 to
H2 over explicit boundary altitudes (IBMAX > 0).

A sonde rises from `h1_km` to a burst altitude drawn in `burst_km`,
with a level about every `level_km`.  H2 is the highest boundary of the
fixed grid (`boundaries_km`: [step, top] segments) at or below the
burst, and only the boundaries up to H2 are listed, so the layer count
moves from sonde to sonde.  `nlay` cuts the grid to its first nlay
layers and the burst range with it (a test's size); at the
configuration's own nlay nothing is cut.  T follows the US standard
atmosphere of 1976 (its lapse rates from the surface, 288.15 K and
1013.25 mb at sea level) with an offset and tilt within `dt_k` and a
`jitter_k` jitter per level; P the same atmosphere's, times a surface
factor in `p_scale`; RH a falling shape times a factor in `h2o_scale`
with a 5% jitter per level, within 1-100%.  Every file has n_prof
sondes; the layer counts and level counts follow the seed.

A frozen generator: it imports nothing of the program, so that a later
change to the program cannot move the benchmark's inputs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.gen.files import REC14, _e10, write_tape3
from benchmark.gen.lines import synthetic_lines

# record 1.2: HIRAC 1, CNTNM 1, EMIT 1, PLOT 1 (Tb out), IATM 1 (LBLATM
# layers the run), IOD 0, XSECT 0
REC12 = ("    1         1         1              1         1"
         "              0    0")
JCHAR = "H666666"            # H2O as RH %; CO2, O3, N2O, CO, CH4, O2 model 6


def boundaries(spec: dict) -> np.ndarray:
    """The boundary grid: h1_km, then each [step, top] segment's
    multiples of step above the last top, those above h1_km; cut to its
    first spec["nlay"] layers."""
    h1 = spec["h1_km"]
    out, lo = [h1], 0.0
    for step, top in spec["boundaries_km"]:
        n = int(round((top - lo) / step))
        out += [z for z in np.round(lo + step * np.arange(1, n + 1), 3)
                if z > h1 + 1e-6]
        lo = top
    return np.asarray(out[:spec["nlay"] + 1])


def _usstd(z: np.ndarray):
    """T (K) and P (mb) of the US standard atmosphere of 1976 at z (km,
    taken as geopotential): lapse -6.5 K/km to 11 km, isothermal to 20,
    +1 K/km to 32."""
    gmr = 34.1632                    # g0 M / R, K/km
    tb, pb, lo = 288.15, 1013.25, 0.0
    t, p = np.empty_like(z), np.empty_like(z)
    for top, lapse in ((11.0, -6.5), (20.0, 0.0), (32.0, 1.0)):
        m = (z >= lo) & (z <= top) if lo == 0.0 else (z > lo) & (z <= top)
        dz = z[m] - lo
        t[m] = tb + lapse * dz
        p[m] = (pb * np.exp(-gmr * dz / tb) if lapse == 0.0 else
                pb * (t[m] / tb) ** (-gmr / lapse))
        pb = pb * (np.exp(-gmr * (top - lo) / tb) if lapse == 0.0 else
                   ((tb + lapse * (top - lo)) / tb) ** (-gmr / lapse))
        tb, lo = tb + lapse * (top - lo), top
    return t, p


def sonde(spec: dict, zb: np.ndarray, rng) -> dict:
    """One sonde's levels (z km, p mb, t K, rh %) and its path: h1, h2,
    and the boundaries from h1 to h2."""
    h1, top = zb[0], zb[-1]
    b0, b1 = spec["burst_km"]
    if top < b1:                     # a cut grid: the burst range with it
        f = (top - h1) / (b1 - h1)
        b0, b1 = h1 + (b0 - h1) * f, top
    burst = float(np.round(rng.uniform(b0, b1), 3))
    dz = spec["level_km"]
    n = int((burst - h1) / dz - 0.5)
    z = h1 + dz * np.arange(1, n + 1) + rng.uniform(-0.2, 0.2, n) * dz
    z = np.round(np.concatenate([[h1], z, [burst]]), 3)
    t, p = _usstd(z)
    off, tilt = rng.uniform(-spec["dt_k"], spec["dt_k"], 2)
    t = (t + off + tilt * (2.0 * (z - h1) / (b1 - h1) - 1.0)
         + rng.normal(0.0, spec["jitter_k"], len(z)))
    p = p * rng.uniform(*spec["p_scale"])
    rh = 80.0 * np.exp(-(z - h1) / 4.0) * np.exp(
        -np.maximum(z - 11.0, 0.0) / 1.5)
    rh = np.clip(rh * rng.uniform(*spec["h2o_scale"])
                 * np.exp(rng.normal(0.0, 0.05, len(z))), 1.0, 100.0)
    h2 = float(zb[zb <= burst][-1])
    return dict(z=z, p=p, t=t, rh=rh, h1=h1, h2=h2, zbnd=zb[zb <= h2])


def block_text(grid: dict, s: dict, k: int, nmol: int) -> str:
    """One '$' block: records 1.1-1.4 of an IATM=1 run on the grid, then
    3.1 (MODEL 0, ITYPE 2, IBMAX, NOZERO 1, NMOL), 3.2 (H1, H2, ANGLE 0),
    3.3B (the boundaries, 8 a line), 3.4 (IMMAX) and a 3.5 + 3.6 pair a
    level."""
    v1, dv, nwn = grid["v1"], grid["dvset"], grid["nwn"]
    rec13 = (f"{_e10(v1)}{v1 + (nwn - 1) * dv:10.5f}{_e10(0.0)}"
             f"{_e10(dv)}" + _e10(0.0) * 4 + "    0      0.000E+00    0")
    zb = s["zbnd"]
    out = [f"$ sonde {k:05d}", REC12, rec13, REC14,
           f"{0:5d}{2:5d}{len(zb):5d}{1:5d}{1:5d}{nmol:5d}{0:5d}"
           + " 0  0" + f"{0.0:10.3f}" * 4,
           f"{s['h1']:10.3f}{s['h2']:10.3f}{0.0:10.3f}"]
    out += ["".join(f"{v:10.3f}" for v in zb[j:j + 8])
            for j in range(0, len(zb), 8)]
    out.append(f"{len(s['z']):5d} SONDE {k:05d}")
    tail = "     0.000" * (nmol - 1)
    for z, p, t, rh in zip(s["z"], s["p"], s["t"], s["rh"]):
        out.append(f"{z:10.3f}{p:10.4f}{t:10.3f}     AA   {JCHAR[:nmol]}")
        out.append(f"{rh:10.3f}{tail}")
    return "\n".join(out) + "\n"


def write_sondes(cfg: dict, seed: int, n_files: int, n_prof: int,
                 root) -> dict:
    """Write the pool; returns dict(tape5s [paths], tape3, lines (the
    TAPE3 records), sondes [per file, lists of dicts])."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng([seed, 0x736F6E6465])
    raw = synthetic_lines(cfg["lines"], int(rng.integers(2 ** 63)))
    write_tape3(root / "TAPE3", raw)
    spec = cfg["profile"]
    zb = boundaries(spec)
    tape5s, per_file = [], []
    for i in range(n_files):
        ss = [sonde(spec, zb, rng) for _ in range(n_prof)]
        path = root / f"MONORTM.{i}.IN"
        path.write_text("".join(block_text(cfg["grid"], s, k + 1,
                                           spec["nmol"])
                                for k, s in enumerate(ss)) + "%%%%\n")
        tape5s.append(path)
        per_file.append(ss)
    return dict(tape5s=tape5s, tape3=root / "TAPE3", lines=raw,
                sondes=per_file)
