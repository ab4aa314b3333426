"""The reference's capacity envelope through the port's pipeline.

NWNMX = 80000 wavenumbers (RTMmono.f90:10) x 200 layers
(monortm_sub.F90:369-375) x a 250k-line catalog (lnfl_mod.f90:5), in one
`pipeline.run` on one device: TAPE5 parse, TAPE3 load, layered profile
ingest, the line-sum plans, the engine split, OD, RT and the MONORTM.OUT
writer.  The port's counterpart of the JAX package's
tools/bench_envelope_e2e.py, with the same inputs, written with the
port's own writers: an IATM=0 MONORTM.IN whose record 1.3 gives a
uniform grid by DVSET, a 200-layer MONORTM_PROF.IN (surface to 0.05 hPa)
written as TAPE7, and a synthetic TAPE3 of two thirds H2O and one third
O2 lines (`testing.synthetic_catalog_mw`).

    python -m monortm_tpu_torch.envelope [--outdir DIR] [--nlay 200]
        [--lines 250000] [--nwn 80000] [--engine auto] [--device cuda]

prints the wall time of the run, nominal evaluations per second (layers
x wavenumbers x lines / wall, the JAX tool's count), the HOST PULL bytes,
peak device memory, the stage report, the engine split, each forward
kernel's launches and Tb at the first and last wavenumber.  `--nwn`
below 80000 keeps the band and coarsens DVSET; `--device cpu` runs the
plain line sums (e.g. `--nlay 6 --lines 3000 --nwn 2000`).
"""

from __future__ import annotations

import argparse
import re
import time
from pathlib import Path

import numpy as np
import torch

from monortm_tpu_torch.io.profin import Profile
from monortm_tpu_torch.io.tape3 import write_tape3
from monortm_tpu_torch.io.tape5 import NWNMX
from monortm_tpu_torch.io.tape7 import write_tape7
from monortm_tpu_torch.testing import synthetic_catalog_mw
from monortm_tpu_torch.types import HostState, ProfileMeta

# record 1.3: V1, and DVSET of the 80000-point grid, whose V2 is
# V1 + (NWNMX - 1) * DVSET
V1, DVSET = 0.3, 0.69e-3
DEFAULT_OUTDIR = Path(__file__).resolve().parents[1] / "build" / "envelope"


def _e10(x: float) -> str:
    """Fortran's E10.3 (0.ddd mantissa) of x >= 0."""
    if x == 0.0:
        return " 0.000E+00"
    e = int(np.floor(np.log10(x))) + 1
    m = round(x / 10.0 ** e, 3)
    if m >= 1.0:
        m, e = m / 10.0, e + 1
    return f"{m:6.3f}E{e:+03d}".rjust(10)


def tape5_text(nwn: int = NWNMX, wn_list=None) -> str:
    """MONORTM.IN of the envelope: IATM=0, a uniform grid of `nwn` points
    from V1 over about the 80000-point grid's band (for a smaller `nwn`,
    DVSET widened and rounded to E10.3's three digits); at NWNMX the JAX
    tool's text.  With `wn_list`, records 1.3 list those wavenumbers
    instead (V1 < 0: NWN, then one per line)."""
    if wn_list is None:
        dvset = float(_e10(DVSET * (NWNMX - 1) / (nwn - 1)))
        v2 = V1 + (nwn - 1) * dvset
        grid = (f"uniform {nwn}-wn grid",
                f"{_e10(V1)}{v2:10.5f}{_e10(0.0)}{_e10(dvset)}"
                + _e10(0.0) * 4 + "    0      0.000E+00    0\n")
    else:
        wn = [float(w) for w in wn_list]
        grid = (f"{len(wn)} listed wn",
                f"{-wn[0]:10.3E}{wn[-1]:10.3E}" + _e10(0.0) * 6
                + "    0      0.000E+00    0\n" + f"{len(wn)}\n"
                + "".join(f"{w:19.13f}\n" for w in wn))
    return (f"* reference capacity envelope (IATM=0, {grid[0]})\n"
            "$ Rundeck envelope\n"
            "    1         1    0    1    0         0    0    0    0    0"
            "         0\n" + grid[1] +
            "     0.    1.0       0.000E+00 0.000E+00 0.000E+00 0.000E+00 "
            "0.000E+00\n"
            "%%%%\n")


def make_profile(nlay: int) -> Profile:
    """The JAX tool's `make_profile`: `nlay` layers from 1013 to 0.05 hPa,
    H2O, CO2, O3 and O2 columns, nmol = 7, looking up from the ground."""
    p = np.geomspace(1013.0, 0.05, nlay)
    t = 288.0 - 65.0 * (1.0 - (p / 1013.0) ** 0.22)
    t = np.clip(t, 190.0, 300.0)
    tz = np.concatenate([[t[0] + 1.0], t - 0.5])
    col = p / p.sum()
    wkl = np.zeros((nlay, 39))
    wkl[:, 0] = 4.5e22 * col * np.exp(-np.arange(nlay) / (nlay / 4))
    wkl[:, 1] = 7.5e21 * col
    wkl[:, 2] = 9.0e18 * col
    wkl[:, 6] = 4.5e24 * col
    wbrodl = 1.7e25 * col
    state = HostState(p=p, t=t, tz=tz, wkl=wkl, wbrodl=wbrodl,
                      clw=np.zeros(nlay))
    alt = np.concatenate([[0.0], np.cumsum(np.full(nlay, 70.0 / nlay))])
    pz = np.concatenate([[1013.25], p - (p - np.roll(p, -1)) / 2])
    pz[-1] = p[-1] * 0.9
    meta = ProfileMeta(nmol=7, angle=0.0, h1=0.0, h2=70.0, altz=alt, pz=pz)
    return Profile(state=state, meta=meta, hmod="ENVELOPE")


def catalog_raw(lines: int):
    """The envelope's TAPE3 lines: two thirds H2O, one third O2 (each O2
    line with its coupling record), plus the fixture's two N2 lines."""
    n_h2o = lines * 2 // 3
    return synthetic_catalog_mw(n_h2o=n_h2o, n_o2=lines - n_h2o,
                                raw_lines=True)


def write_inputs(outdir, nlay: int = 200, lines: int = 250_000,
                 nwn: int = NWNMX) -> dict:
    """Write MONORTM.IN, MONORTM_PROF.IN and TAPE3 into `outdir`; returns
    `pipeline.run`'s file arguments."""
    d = Path(outdir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "MONORTM.IN").write_text(tape5_text(nwn))
    write_tape7(d / "MONORTM_PROF.IN", [make_profile(nlay)])
    write_tape3(d / "TAPE3", catalog_raw(lines))
    return dict(filein=d / "MONORTM.IN", fileprof=d / "MONORTM_PROF.IN",
                hfile=d / "TAPE3")


def run_envelope(outdir, nlay: int = 200, lines: int = 250_000,
                 nwn: int = NWNMX, engine: str = "auto",
                 device: str = "cuda", files: dict | None = None,
                 echo=print) -> dict:
    """Write the inputs (unless `files` names them) and run them through
    `pipeline.run` once; `echo` gets each line of the report.  Returns the
    result and the readings: wall s, evals per s, host pull bytes, peak
    device bytes (None on the CPU), the engine split per chunk, each
    forward kernel's launches and the stage report."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL
    from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL

    outdir = Path(outdir)
    t0 = time.perf_counter()
    files = files or write_inputs(outdir, nlay, lines, nwn)
    echo(f"inputs ready in {time.perf_counter() - t0:.1f} s")
    dev = torch.device(device)
    kernels = (VOIGT_KERNEL, LORENTZ_KERNEL)
    for k in kernels:
        k.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = pipeline.run(**files, outdir=outdir, engine=engine, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)

    log = (outdir / "MONORTM.LOG").read_text()
    pull = int(re.search(r"HOST PULL: (\d+)", log).group(1))
    stages = log[log.index(" STAGE"):].rstrip() if " STAGE" in log else ""
    n_wn = len(res.wn)
    evals = nlay * n_wn * lines
    tb = np.asarray(res.tb[0])
    out = dict(result=res, wall_s=wall, evals_per_s=evals / wall,
               host_pull_bytes=pull, peak_bytes=peak,
               split=[(n, e, len(lor)) for n, e, lor in res.engines],
               launches={k.name: k.launches for k in kernels},
               stages=stages, tb_finite=bool(np.isfinite(tb).all()))
    echo(f"envelope: 1 profile x {nlay} layers x {n_wn} wn x {lines} "
         f"lines on {dev}")
    echo(f"  wall {wall:.3f} s ({evals / wall:.4e} nominal od-evals/s, "
         f"parse and writer included)")
    echo(f"  host pull: {pull} bytes")
    echo("  peak device memory: " + ("n/a on the CPU" if peak is None
                                     else f"{peak / 2**30:.3f} GiB"))
    for n, e, n_lor in out["split"]:
        echo(f"  engine split: {n} profile(s): {e}, {n_lor} of {nlay} "
             f"rows all-Lorentz")
    echo(f"  forward kernel launches: {out['launches']}")
    for ln in stages.splitlines():
        echo("  " + ln.strip())
    echo(f"  Tb[0]={tb[0]:.4f} K  Tb[-1]={tb[-1]:.4f} K  "
         f"finite={out['tb_finite']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default=str(DEFAULT_OUTDIR))
    ap.add_argument("--nlay", type=int, default=200)
    ap.add_argument("--lines", type=int, default=250_000)
    ap.add_argument("--nwn", type=int, default=NWNMX)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run_envelope(a.outdir, a.nlay, a.lines, a.nwn, a.engine, a.device,
                       echo=lambda s: print(s, flush=True))
    return 0 if out["tb_finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
