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

    python -m monortm_tpu_torch.envelope --grad [same options]

is the counterpart of the JAX package's tools/bench_envelope.py --grad:
the retrieval adjoint at the envelope.  It builds `MonoRTM` and the
layered state from the same files through the port's host stages
(`build_model`), takes tb_obs from the state warmed by 1 K, and runs
`torch.autograd` of mean((tb - tb_obs)^2) through `MonoRTM.tb` (surface
at 288 K, emissivity 0.95, looking down) by every float field of the
state, once.  It prints the wall seconds of a forward and of
value_and_grad, peak device memory of value_and_grad, each kernel's
launches and its time by CUDA events around its wrapper's calls, and
whether every gradient is finite and not all zero; on the CPU the plain
line sums and their plain adjoints run.
"""

from __future__ import annotations

import argparse
import contextlib
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
from monortm_tpu_torch.types import FIELDS, HostState, LayerState, ProfileMeta

# record 1.3: V1, and DVSET of the 80000-point grid, whose V2 is
# V1 + (NWNMX - 1) * DVSET
V1, DVSET = 0.3, 0.69e-3
# the retrieval's boundary (chip_smoke.py phase 6's): surface temperature
# K, emissivity, looking down
TSFC, EMIS, IRT = 288.0, 0.95, 3
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

    outdir = Path(outdir)
    t0 = time.perf_counter()
    files = files or write_inputs(outdir, nlay, lines, nwn)
    echo(f"inputs ready in {time.perf_counter() - t0:.1f} s")
    dev = torch.device(device)
    kernels = line_kernels().values()
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


def build_model(files: dict, device="cuda"):
    """(MonoRTM, LayerState, MONORTM.IN block) of the envelope's files,
    through the port's host stages as `pipeline.run` builds them: the
    TAPE5 block, the profile's layered state (float32) and the line
    catalog loaded over the grid's band in the pipeline's line tiles."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.convert import state_from_numpy
    from monortm_tpu_torch.io.profin import read_profiles
    from monortm_tpu_torch.io.tape5 import Tape5Reader
    from monortm_tpu_torch.lines import load_catalog
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.ops.lineshape import LineConfig

    prof = read_profiles(files["fileprof"])[0]
    cfg = Tape5Reader(files["filein"]).read_block()
    model = MonoRTM(
        cfg.wn, cfg.dvset,
        load_catalog(files["hfile"], float(cfg.wn[0]), float(cfg.wn[-1]),
                     tile=pipeline.LINE_TILE),
        nmol=prof.meta.nmol, line_cfg=LineConfig(ibrd=cfg.ibrd),
        device=device, wn_tile=pipeline.WN_TILE,
        line_tile=pipeline.LINE_TILE)
    return model, state_from_numpy(prof.state, device, torch.float32), cfg


def line_kernels():
    """The two instantiations of the line-sum kernels, by engine."""
    from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL
    from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
    return {"full": VOIGT_KERNEL, "lorentz": LORENTZ_KERNEL}


@contextlib.contextmanager
def kernel_events(kernels: dict, on_bwd=None):
    """While the block runs, CUDA events around every forward and
    adjoint call of each kernel's wrapper (`launch`, `launch_bwd`), into
    the dict it yields: {(engine, "fwd" | "bwd"): [(start, end), ...]}.
    on_bwd(engine, args, outputs), where given, sees each adjoint call."""
    events = {(e, d): [] for e in kernels for d in ("fwd", "bwd")}

    def timed(k, e, d, method):
        def call(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = method(k, *a)
            end.record()
            events[(e, d)].append((start, end))
            if d == "bwd" and on_bwd is not None:
                on_bwd(e, a, out)
            return out
        return call

    for e, k in kernels.items():
        k.launch = timed(k, e, "fwd", type(k).launch)
        k.launch_bwd = timed(k, e, "bwd", type(k).launch_bwd)
    try:
        yield events
    finally:
        for k in kernels.values():
            del k.launch, k.launch_bwd


def event_ms(events: dict) -> dict:
    """Device ms of each entry of `kernel_events`' dict, summed over its
    calls (after a synchronize)."""
    return {key: sum(a.elapsed_time(b) for a, b in v)
            for key, v in events.items()}


def tb_of(model, state, engine: str, lor_layers):
    """Tb of `state` at the retrieval's boundary (TSFC, EMIS, IRT)."""
    emis = torch.full((len(model.wn),), EMIS, device=model.device)
    return model.tb(state, TSFC, emis, 1.0 - emis, irt=IRT, engine=engine,
                    lor_layers=lor_layers)


def envelope_grad(model, state, echo=print, on_bwd=None) -> dict:
    """The retrieval adjoint of `model` at `state` (see the module
    docstring): returns the loss, the gradients by field, the wall s of
    the forward and of value_and_grad, the peak device bytes of
    value_and_grad (None on the CPU), the engine split, each kernel's
    (forward, adjoint) launches in value_and_grad, the kernels the
    adjoint's library started there, each kernel's ms by CUDA events in
    value_and_grad, and tb_obs.  on_bwd: see kernel_events."""
    dev = model.device
    cuda = dev.type == "cuda"
    kernels = line_kernels()
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    nwn = len(model.wn)
    engine, lor = model.engine_split(state)
    warm = LayerState(p=state.p, t=state.t + 1.0, tz=state.tz + 1.0,
                      wkl=state.wkl, wbrodl=state.wbrodl, clw=state.clw)
    with torch.no_grad():
        # the first call also builds and loads the kernels
        tb_obs = tb_of(model, warm, engine, lor)
        sync()
        t0 = time.perf_counter()
        tb_of(model, state, engine, lor)
        sync()
        fwd_s = time.perf_counter() - t0

    for k in kernels.values():
        k.launches = k.bwd_launches = 0
    started = ({e: k.bwd_kernels_started() for e, k in kernels.items()}
               if cuda else {})
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with (kernel_events(kernels, on_bwd) if cuda
          else contextlib.nullcontext({})) as events:
        t0 = time.perf_counter()
        leaves = LayerState(**{f: getattr(state, f).detach()
                               .requires_grad_() for f in FIELDS})
        loss = torch.mean((tb_of(model, leaves, engine, lor) - tb_obs)
                          ** 2)
        grads = torch.autograd.grad(loss, [getattr(leaves, f)
                                           for f in FIELDS])
        sync()
        vag_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    out = dict(
        loss=float(loss.detach()), grads=dict(zip(FIELDS, grads)),
        forward_s=fwd_s, value_and_grad_s=vag_s, peak_bytes=peak,
        engine=engine, lor_layers=list(lor), tb_obs=tb_obs,
        launches={e: (k.launches, k.bwd_launches)
                  for e, k in kernels.items()},
        kernels_started={e: k.bwd_kernels_started() - started[e]
                         for e, k in kernels.items()} if cuda else {},
        kernel_ms=event_ms(events))
    nlay = state.p.shape[-1]
    n_lines = int(np.sum(model.od_model.catalog.valid))
    echo(f"envelope value_and_grad: 1 profile x {nlay} layers x {nwn} wn "
         f"x {n_lines} lines on {dev}; engine {engine}, {len(lor)} of "
         f"{nlay} rows all-Lorentz")
    echo(f"  forward {fwd_s:.3f} s, value_and_grad {vag_s:.3f} s, loss "
         f"{out['loss']:.6e}")
    echo("  peak device memory of value_and_grad: "
         + ("n/a on the CPU" if peak is None else f"{peak / 2**30:.3f} GiB"))
    echo(f"  (forward, adjoint) launches: {out['launches']}"
         + (f"; kernels the adjoint library started: "
            f"{out['kernels_started']}" if cuda else ""))
    for (e, d), ms in out["kernel_ms"].items():
        echo(f"  {e} {'forward' if d == 'fwd' else 'adjoint'} kernel: "
             f"{ms:.3f} ms by CUDA events")
    ok = True
    for f, g in out["grads"].items():
        fin, nz = bool(torch.isfinite(g).all()), bool((g != 0).any())
        ok &= fin and nz
        echo(f"  d loss / d {f}: max|g|={float(g.abs().max()):.4e}, "
             f"finite {fin}, not all zero {nz}")
    out["grads_ok"] = ok
    return out


def run_envelope_grad(outdir, nlay: int = 200, lines: int = 250_000,
                      nwn: int = NWNMX, device: str = "cuda",
                      echo=print) -> dict:
    """Write the inputs, build the model and run `envelope_grad`."""
    t0 = time.perf_counter()
    model, state, _ = build_model(write_inputs(outdir, nlay, lines, nwn),
                                  device)
    echo(f"inputs and model ready in {time.perf_counter() - t0:.1f} s")
    return envelope_grad(model, state, echo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default=str(DEFAULT_OUTDIR))
    ap.add_argument("--nlay", type=int, default=200)
    ap.add_argument("--lines", type=int, default=250_000)
    ap.add_argument("--nwn", type=int, default=NWNMX)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grad", action="store_true",
                    help="the retrieval adjoint (value_and_grad through "
                         "MonoRTM.tb) instead of pipeline.run")
    a = ap.parse_args(argv)
    echo = lambda s: print(s, flush=True)
    if a.grad:
        out = run_envelope_grad(a.outdir, a.nlay, a.lines, a.nwn, a.device,
                                echo=echo)
        return 0 if out["grads_ok"] else 1
    out = run_envelope(a.outdir, a.nlay, a.lines, a.nwn, a.engine, a.device,
                       echo=echo)
    return 0 if out["tb_finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
