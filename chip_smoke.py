#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the line-sum kernels from `monortm_tpu_torch/csrc/` (the forward
`linesum.cu` and its adjoint `linesum_bwd.cu`, one nvcc each, started
together) and runs, at bench.py's workload (8 profiles x 40 layers x 1024
wavenumbers over 0.3-55 cm^-1 x 3074 lines, hybrid engine split computed
on the GPU):

  1 build;
  2 each forward instantiation (VOIGT true / false) against its plain
    PyTorch version;
  3 `MonoRTM.forward` once, checking that it went through both forward
    kernels and agrees with the CPU path on one profile;
  4 forward timings, each forward kernel beside its plain version;
  5 each adjoint instantiation against its plain version (seeded
    cotangents on the small and bench plans at 1013 / 20 / 0.02 hPa, with
    layers at 1013 and 0.02 hPa alternating in one call, and the real
    cotangent of the loss on the main path's operands; the Voigt
    instantiation's partials by shift, hw and ad against the plain
    version run in float64; every call twice, bitwise equal; the
    (layer, line) pairs whose SD-Voigt lanes the Voigt adjoint defers to
    its second kernel against a count made here);
  6 the retrieval adjoint: value and gradient of mean((tb - tb_obs)^2)
    with tb_obs from the state warmed by 1 K, checking that it went
    through both adjoint kernels, that every gradient is finite and not
    zero, the small model's gradient against the CPU path, and central
    differences at one layer of each engine (SD-Voigt, all-Lorentz);
  7 timings: value_and_grad and forward medians (interleaved), each
    adjoint kernel beside its plain version, peak memory;
  8 the pipeline (`pipeline.run`, what `python -m monortm_tpu_torch.cli`
    runs) at full width: a rundir written with the port's own writers
    (TAPE3 of the same 3074 lines, MONORTM.IN with the 1024 wavenumbers
    as an explicit list, MONORTM_PROF.IN of 64 profiles x 40 layers
    written as TAPE7), run once to warm and then 3 times each with the
    chunk cap forced to 64 and to 8 profiles; wall seconds, profiles/s,
    the stage report and each forward kernel's launches; every Tb finite,
    MONORTM.OUT byte-identical between two runs and between the caps
    (when every profile's layers took the same engine at both; the engine
    split of each chunk is printed), profile 1 at every device stage
    bitwise the same in a chunk of 64 and of 8 (`batch_stages`; the two
    forward instantiations on the all-Lorentz layers are compared and
    printed, not required equal), profile 1's Tb and total OD against the
    port's CPU pipeline on a 1-profile copy, and a small IATM=1 rundir (US
    standard, 0-30 km) on the card to finite Tb;
  9 float64 at full width through the dense engine: phase 8's rundir cut
    to its first 8 profiles, `run(dtype=torch.float64)` twice at a cap of
    8 and once at 2, MONORTM.OUT byte-identical across the three, no
    line-sum kernel launched, wall seconds, profiles/s, peak memory and
    the dense block's shape; profile 1 against the port's CPU float64
    pipeline on every 32nd wavenumber (Tb within 1e-9 K, total OD at rtol
    1e-10, atol 1e-14); the float32 dense engine writes the same bytes
    with `torch.backends.cuda.matmul.allow_tf32` on and off;
  10 an infrared-to-UV grid (three wavenumbers inside each activation
    range of the twelve sub-continua a microwave grid leaves off, and
    Rayleigh above 820 cm^-1) through the default float32 kernels and the
    hybrid split: both forward kernels launch, od_total, every continuum
    species and Tb agree with the CPU path at the forward tolerance, and
    no sub-continuum's OD is all zero on its band.

Run from the repository root:  python3 chip_smoke.py
(`python3 chip_smoke.py --batch-stages` builds the kernels and runs only
phase 8's stage-by-stage chunk comparison.)
Exits non-zero (and prints no result line) without a CUDA device or when
any phase fails; a phase prints all of its comparisons before it fails.
The line before the last two lists each kernel with its launches on the
main path (`launches` counts calls of the wrapper; an adjoint row's
`kernels_per_launch` is the kernels its library started on the main path
over those calls: the Voigt adjoint's two), its worst error against its plain version (max_abs_err, and max_rel_err = the
worst err / max|ref| over the kernel's outputs), its time, its plain
version's time and its bound.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

RTOL = 2e-5          # tests/test_pallas.py's kernel tolerance
ATOL_REL = 2e-6      # atol = ATOL_REL * max|ref|
TB_ATOL = 2e-3       # K, the forward's brightness-temperature tolerance
BATCH, NLAY, NWN = 8, 40, 1024
PER_LN = ("shift", "stild", "hw", "ad", "k3v", "ya", "yb")
FIELDS = ("p", "t", "tz", "wkl", "wbrodl", "clw")

# Adjoint kernel vs its plain version: rtol 2e-5 and atol = BWD_ATOL *
# max|ref| for every cotangent; the two sum over wavenumbers in other
# orders.  The Voigt instantiation's partials by shift, hw and ad
# (SD_PARTIALS) are held against the plain adjoint run in float64 (with
# float32's fallback to the plain Voigt at delta > 1e6, which the kernel
# follows): the kernel evaluates an SD-Voigt lane's partials in double
# (csrc/linesum_math.cuh, sd_shape), while in float32 they lose their
# digits where the speed-dependent width is small, in the plain float32
# adjoint too.  Phase 5 prints the plain float32 adjoint's own error
# against float64 beside the kernel's.
BWD_ATOL = 1e-5
SD_PARTIALS = ("shift", "hw", "ad")

# FP32 operations per kept (layer, wavenumber, line) evaluation, counted by
# hand from csrc/linesum_math.cuh (an add, multiply, compare, divide, sqrt,
# exp or cos is one operation, a fused multiply-add two), by lane class:
# Lorentz, Lorentz with k2, SD-Voigt, SD-Voigt with k2.  SD-Voigt lanes are
# counted at Humlicek region 1, the cheapest, and in the adjoint as one
# float Dual evaluation at the FP32 rate, although their partials run in
# double beside a float value (sd_shape), which takes longer.  So the
# operation bound is a lower bound.  OPS is the forward's flat count of
# PRs 1-3 (the unhoisted evaluation, every class alike); its bound is
# printed beside the per-class one (FWD_LORENTZ_OPS), so that times stay
# comparable with older ones.
OPS = {("fwd", True): (26, 33, 82, 151), ("fwd", False): (22, 29, 0, 0)}
FWD_SD_OPS = (82, 151)
BWD_SD_OPS = (465, 875)
# A Lorentz lane of the forward, by the line's class of the branch trees
# (linesum_math.cuh, TreeClass order) without / with k2, from fwd_pair and
# fwd_tree; what a staged line carries (FwdLine) is not counted.  Every
# class: d1 4, sls * stild and its add 2, k1 3 (d1^2, the add, the
# divide), k2 3; the window test 1 (not coupled O2); dsum 1 and the mirror
# test 1 where the class reads the mirror term.  Then:
#   O2 coupled, XF1   dsum 1, y1 3, y2 3, sls 3 (always k2)  -> 22
#   O2 coupled        dsum 1, sls 1 (always k2)              -> 14
#   O2                window, dsum, mirror 3, sls 1          -> 13 / 16
#   CO2, XF15         window 1, ped 3, k3 * ped 1, y1 3,
#                     sls 6 (never k2)                       -> 23
#   CO2               window 1, ped 3, k3 * ped 1, sls 1     -> 15
#   coupled           window, dsum, mirror 3, y1 3, sls 3    -> 18
#     with mirror     ... y2 3, sls 5                        -> 26
#   plain             window, dsum, mirror 3, sls 2 (3)      -> 14 / 18
# The last row is an uncoupled O2 line outside the window: d1 and the
# window test.  VOIGT=true adds the lane switch, 1, to every row but it.
FWD_LORENTZ_OPS = ((22, 22), (14, 14), (13, 16), (23, 23), (15, 15),
                   (18, 26), (14, 18), (5, 5))
# A Lorentz lane of the adjoint, by the line's class of the branch trees
# (linesum_math.cuh, TreeClass order) without / with k2, from
# lorentz_class_adjoint as written for VOIGT=false; VOIGT=true adds the
# lane switch, 1.  Every class: pair_of 9, lorentz_partials 10 per shape
# (value 3, r 1, d/dd 3, d/dhw 3), gs 1, s_dsum - s_d1 1, the shift and hw
# sums 2 each, the stild sum 2; a class with Y factors adds the ya and yb
# sums, 2 each.  Then sls and its partials (s_d1, s_dsum, s_hw, s_ya, s_yb):
#   O2 coupled, XF1   y1, y2 6, sls 3; 3, 3, 3, 3, 1           -> 63
#   O2 coupled        sls 1; s_hw 1 (always k2)                -> 39
#   O2                sls 1; s_hw 1                            -> 29 / 39
#   CO2, XF15         y1 3, ped 3, sls 7; ped_d1 2, a_y1 1,
#                     7, 4, 1 (never k2)                       -> 59
#   CO2               ped 3, sls 2; ped_d1 2, 2, 2 (never k2)  -> 38
#   coupled           y1 3, sls 2; 3, 2, 2, 1                  -> 44
#     with mirror     y1, y2 6, sls 5; 3, 3, 5, 3, 3           -> 69
#   plain             sls 1 (3 with k2); s_hw 3                -> 31 / 43
# A value the source forms twice counts once; what a thread computes once
# (LinePre) and products of two such constants are not counted.  The last
# row is an uncoupled O2 line outside the window: pair_of alone.
BWD_LORENTZ_OPS = ((63, 63), (39, 39), (29, 39), (59, 59), (38, 38),
                   (44, 69), (31, 43), (9, 9))
# the adjoint's count while a Lorentz lane carried dual numbers through
# the shapes and the pedestal at every wavenumber: its bound is printed
# beside the present one, so that times stay comparable with older ones
OPS_DUAL = {("bwd", True): (140, 188, 465, 875),
            ("bwd", False): (131, 179, 0, 0)}
PEAK_FLOPS = 67e12   # H100 SXM FP32, non-tensor
PEAK_BYTES = 3.35e12

# phase 8: the pipeline's rundir.  MONORTM.IN records 1.1-1.4 of an IATM=0
# run (ICNTNM=1, IEMIT=1, IPLOT=1, explicit wavenumber list, TBOUND 0,
# emissivity 1) and of an IATM=1 run over 0.2-1.2 cm^-1 whose records
# 3.1-3.3 layer the US standard atmosphere from 0 to 30 km, looking up
# from the ground (tests/test_atmos.py CASE1_REST)
PIPE_NPROF, PIPE_CAPS, PIPE_REPS = 64, (64, 8), 3
# phase 9: float64 on phase 8's rundir cut to its first profiles; profile
# 1 against the CPU on every F64_CPU_WN_STEP-th wavenumber, at the e2e
# oracle's float64 budgets (tests/test_e2e_oracle.py:27-28)
F64_NPROF, F64_CAPS, F64_CPU_WN_STEP = 8, (8, 2), 32
F64_TB_ATOL, F64_OD_RTOL, F64_OD_ATOL = 1e-9, 1e-10, 1e-14
# phase 10: sub-continuum -> (species, a wavenumber range inside its
# activation test), three points each
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
REC12 = ("    1         1         1              1         {iatm}"
         "              0    0")
REC14 = ("     0.    1.0       0.000E+00 0.000E+00 0.000E+00 0.000E+00 "
         "0.000E+00")
IATM0_TAPE5 = ("$ chip smoke: synthetic microwave run\n" + REC12.format(iatm=0)
               + "\n-0.300E+00 5.500E+01" + " 0.000E+00" * 6
               + "    0      0.000E+00    0\n{nwn}\n{wn}" + REC14 + "\n%%%%\n")
IATM1_TAPE5 = "\n".join([
    "$ chip smoke: IATM=1, US standard 0-30 km", REC12.format(iatm=1),
    " 2.000E-01 1.200E+00 0.000E+00 1.000E-01" + " 0.000E+00" * 4
    + "    0      0.000E+00    0", REC14,
    "    6    2    0    1    1   22    1",
    "     0.000    30.000       0.000",
    "     0.000     3.000     3.000     0.000     0.000",
    "-1", "%%%%"]) + "\n"


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


FAILED = []     # comparisons that failed in the running phase


def compare(got, ref, what, atol_rel=ATOL_REL, rtol=RTOL):
    """(max abs error, max abs error / max|ref|) of got vs ref; records a
    failure beyond rtol/atol, which fails the phase at its end."""
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    bad = err > atol_rel * scale + rtol * ref.abs()
    rel = float(err.max()) / max(scale, 1e-300)
    log(f"  {what}: max_abs_err={float(err.max()):.3e} max|ref|={scale:.3e} "
        f"err/max={rel:.2e} violations={int(bad.sum())}")
    if not bool(torch.isfinite(got).all()):
        FAILED.append(f"{what}: non-finite values")
    if bool(bad.any()):
        FAILED.append(f"{what}: kernel disagrees with plain version beyond "
                      f"rtol={rtol}, atol={atol_rel}*max|ref|")
    return float(err.max()), rel


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lane_counts(pre, mol, wn_hi, wn_lo, cand_map, cand_valid, nt, wt,
                n_mol, voigt):
    """Kept evaluations of one line sum by lane class (see OPS), counted on
    this call's data with the kernels' masks; the kept SD-Voigt lanes of
    each (layer, line) over all wavenumbers, int64 [L, N]; and the kept
    Lorentz lanes by (row of FWD_LORENTZ_OPS / BWD_LORENTZ_OPS, k2)."""
    dev = pre["stild"].device
    cm, cv = cand_map.cpu().numpy(), cand_valid.cpu().numpy()
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    sd_lanes = torch.zeros(pre["stild"].shape, dtype=torch.int64, device=dev)
    by_class = torch.zeros(2 * len(BWD_LORENTZ_OPS), dtype=torch.int64,
                           device=dev)
    fl = {k: pre["flags"][k] > 0.5 for k in pre["flags"]}
    w = lambda c, a, b: torch.where(c, a, b)
    cls = w(fl["o2"], w(fl["cpl"], w(fl["xf1"], 0, 1), 2),
            w(fl["co2"], w(fl["cpl"] & fl["xf15"], 3, 4),
              w(fl["cpl"], 5, 6)))
    mol_ok = (mol >= 1) & (mol <= n_mol)
    c01, c99 = float(np.float32(0.01)), float(np.float32(0.99))
    for i in range(cm.shape[0]):
        wh = wn_hi[i * wt:(i + 1) * wt][None, :, None]
        wl = wn_lo[i * wt:(i + 1) * wt][None, :, None]
        for j in range(cm.shape[1]):
            if not cv[i, j]:
                continue
            sl = slice(int(cm[i, j]) * nt, (int(cm[i, j]) + 1) * nt)
            nh, nlo = pre["nu_hi"][sl], pre["nu_lo"][sl]
            sh = pre["shift"][:, sl][:, None, :]
            d1 = (wh - nh) + (wl - nlo) - sh
            dsum = wh + (nh + (nlo + sh))
            o2 = fl["o2"][sl]
            keep = ((d1.abs() <= 25.0) | o2) & fl["valid"][sl] & mol_ok[sl]
            k2 = ((dsum - 25.0) <= 0.0) | (o2 & fl["cpl"][sl])
            if voigt:
                hw = pre["hw"][:, sl][:, None, :]
                ad = pre["ad"][:, sl][:, None, :]
                lor = (d1.abs() > 100.0 * ad) | (hw * c01 > ad * c99)
            else:
                lor = torch.ones_like(keep)
            counts += torch.stack([(keep & lor & ~k2).sum(),
                                   (keep & lor & k2).sum(),
                                   (keep & ~lor & ~k2).sum(),
                                   (keep & ~lor & k2).sum()])
            sd_lanes[:, sl] += (keep & ~lor).sum(1)
            outside = (cls[sl] == 2) & (d1.abs() > 25.0)
            row = torch.where(outside, len(BWD_LORENTZ_OPS) - 1, cls[sl])
            by_class += torch.bincount((2 * row + k2)[keep & lor],
                                       minlength=by_class.numel())
    counts = counts.tolist()
    check(int(by_class.sum()) == counts[0] + counts[1],
          "lane counts by class do not add up")
    return counts, sd_lanes, by_class.view(-1, 2).tolist()


def bound(direction, voigt, counts, n_bytes, ops_table=OPS):
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    ops = sum(c * o for c, o in zip(counts, ops_table[(direction, voigt)]))
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_by_class(direction, voigt, counts, by_class, n_bytes):
    """The bound with the Lorentz lanes counted class by class
    (FWD_LORENTZ_OPS or BWD_LORENTZ_OPS); the SD-Voigt lanes at
    FWD_SD_OPS or BWD_SD_OPS."""
    per_class, sd = ((FWD_LORENTZ_OPS, FWD_SD_OPS) if direction == "fwd"
                     else (BWD_LORENTZ_OPS, BWD_SD_OPS))
    switch = [voigt] * len(per_class)
    if direction == "fwd":
        switch[-1] = 0      # outside the window: no lane switch
    ops = sum(n * (o + v) for ns, os_, v in zip(by_class, per_class, switch)
              for n, o in zip(ns, os_))
    ops += sum(c * o for c, o in zip(counts[2:], sd))
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def line_bytes(args, direction, voigt):
    """Bytes a line sum must move: each input read once, each output
    written once (float32 / int32 operands)."""
    pre, mol, wn_hi, wn_lo, cm, cv, nt, wt, n_mol = args[:9]
    L, n = pre["stild"].shape
    wp = wn_hi.shape[0]
    per_ln = 7 if voigt else 5
    inputs = (per_ln * L * n + 5 * n + 2 * wp + 2 * cm.numel()) * 4
    sf = L * wp * n_mol * 4
    if direction == "fwd":
        return inputs + sf
    return inputs + sf + per_ln * L * n * 4


def write_rundir(d: Path, raw, keep: int, wn_step: int = 1) -> None:
    """TAPE3 (the lines `raw`), MONORTM.IN and MONORTM_PROF.IN of phase 8,
    written with the port's writers; MONORTM_PROF.IN holds the first
    `keep` profiles of synthetic_state(nlay=NLAY, batch=PIPE_NPROF),
    written as TAPE7 (levels from 1013 to 45 hPa, looking up); MONORTM.IN
    lists every `wn_step`-th of the NWN wavenumbers."""
    from monortm_tpu_torch.io.profin import Profile
    from monortm_tpu_torch.io.tape3 import write_tape3
    from monortm_tpu_torch.io.tape7 import write_tape7
    from monortm_tpu_torch.testing import synthetic_state
    from monortm_tpu_torch.types import HostState, ProfileMeta

    d.mkdir(parents=True, exist_ok=True)
    write_tape3(d / "TAPE3", raw)
    wn = np.linspace(0.3, 55.0, NWN)[::wn_step]
    (d / "MONORTM.IN").write_text(IATM0_TAPE5.format(
        nwn=len(wn), wn="".join(f"{w:19.13f}\n" for w in wn)))
    st = synthetic_state(nlay=NLAY, batch=PIPE_NPROF, device="cpu",
                         dtype=torch.float64)
    pz = np.geomspace(1013.0, 45.0, NLAY + 1)
    altz = -7.0 * np.log(pz / 1013.0)
    profs = [Profile(
        state=HostState(**{f: getattr(st, f)[i].numpy() for f in FIELDS}),
        meta=ProfileMeta(nmol=22, angle=0.0, h1=0.0, h2=float(altz[-1]),
                         altz=altz, pz=pz), hmod="SYNTHETIC")
        for i in range(keep)]
    write_tape7(d / "MONORTM_PROF.IN", profs, xid="chip smoke")


def rundir_files(d: Path) -> dict:
    return dict(filein=d / "MONORTM.IN", fileprof=d / "MONORTM_PROF.IN",
                hfile=d / "TAPE3")


def drive(files, outdir, cap=None, **kw):
    """One `pipeline.run` on the card with stdout kept and the chunk cap
    forced to `cap` profiles (None: the memory cap); returns (result,
    wall s, stdout)."""
    from monortm_tpu_torch import pipeline
    best_max_batch = pipeline._max_batch
    pipeline._max_batch = (best_max_batch if cap is None
                           else lambda *a, **k: cap)
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = pipeline.run(**{**files, **kw}, outdir=outdir,
                               device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, buf.getvalue()
    finally:
        pipeline._max_batch = best_max_batch


def stage_report(outdir: Path) -> str:
    """MONORTM.LOG's HOST PULL, ENGINE SPLIT and STAGE TIMING lines."""
    text = (outdir / "MONORTM.LOG").read_text()
    return text[text.index(" HOST PULL"):].rstrip()


def split_of(res) -> list:
    """Each profile's (engine, the layers the all-Lorentz kernel took) in
    a pipeline run, in input order."""
    return [(e, lor) for n, e, lor in res.engines for _ in range(n)]


def batch_stages(model, state, n_small: int) -> list:
    """Profile 1 at each device stage of a pipeline chunk, computed in a
    chunk of all of `state`'s profiles and in one of its first `n_small`:
    [(stage, bitwise equal, max abs difference)] in the pipeline's order.
    The engine split is each chunk's own, as the pipeline takes it; the
    line OD of each engine is also compared over every layer."""
    from monortm_tpu_torch.models.rt import rad_up_dn
    from monortm_tpu_torch.ops.lineshape import line_params
    from monortm_tpu_torch.pipeline import _lsum
    from monortm_tpu_torch.types import LayerState
    od = model.od_model

    def stages(st):
        out = {}
        with torch.no_grad():
            scor = od.tips.scor(st.t)
            sf = scor.reshape(scor.shape[:-2] + (39 * 9,))
            out["TIPS scor"] = scor
            lp = line_params(od.dev_cat, st.p, st.t, st.wkl, st.wbrodl, sf,
                             od.line_cfg)
            out.update({f"prologue {k}": v for k, v in lp.items()})
            split = od.engine_split(st)
            for e in ("full", "lorentz"):
                out[f"line OD, {e} engine, every layer"] = od.line_od(
                    st, sf, engine=e)
            res = od(st, engine=split[0], lor_layers=split[1])
            out["line OD by molecule (split)"] = res.od_by_mol
            out.update({f"continuum {k}": v for k, v in res.oc.items()})
            out["cloud OD"] = res.od_clw
            out["total OD"] = res.od_total
            out["layer sum of total OD"] = _lsum(res.od_total)
            out["layer sum by molecule"] = _lsum(res.od_by_mol)
            rup, rdn, trtot, sumexp_dn, odtot = rad_up_dn(
                res.od_total, st.t[..., None, :], st.tz[..., None, :],
                od.wn_t)
            out.update({"RT odtot": odtot, "RT sumexp_dn": sumexp_dn,
                        "RT rup": rup, "RT rdn": rdn, "RT trtot": trtot})
        return split, out

    small = LayerState(**{f: getattr(state, f)[:n_small] for f in FIELDS})
    split_b, big = stages(state)
    split_s, sml = stages(small)
    rows = [(f"engine split {split_b[0]} {list(split_b[1])} vs "
             f"{split_s[0]} {list(split_s[1])}", split_b == split_s, 0.0)]
    for k, v in big.items():
        a, b = v[0], sml[k][0]
        rows.append((k, bool(torch.equal(a, b)),
                     float((a.double() - b.double()).abs().max())))
    return rows


def engines_agree(model, state) -> tuple:
    """(layers where every line is in the Lorentz regime, whether the two
    forward instantiations give bitwise-equal sums there, max abs
    difference) over `state`'s profiles."""
    od = model.od_model
    with torch.no_grad():
        _, lor = od.engine_split(state)
        if not lor:
            return (), True, 0.0
        ix = torch.as_tensor(lor, device=state.p.device)
        scor = od.tips.scor(state.t)
        sf = scor.reshape(scor.shape[:-2] + (39 * 9,))
        a, b = (od.line_od(state, sf, engine=e).index_select(-3, ix)
                for e in ("full", "lorentz"))
    return lor, bool(torch.equal(a, b)), float((a - b).abs().max())


def phase8_pipeline(tmp: Path, kernels, reset_counts) -> dict:
    """Phase 8 (see the module docstring); returns each forward kernel's
    launches in the first timed run at the cap of 64, and the lines."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.io.tape3 import RawLines
    from monortm_tpu_torch.testing import synthetic_catalog_mw

    # the first N2 line moved to the front, so that every 250-record panel
    # of the TAPE3 ends on a line and not on an O2 coupling record: the
    # reader skips a panel whose last record's wavenumber field (there a
    # coupling coefficient, negative for some) lies below max(0, v1 - 25)
    # (RDLNFL's panel skip), and this way the run keeps all 3074 lines
    raw = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, raw_lines=True)
    order = np.r_[len(raw) - 2, :len(raw) - 2, len(raw) - 1]
    raw = RawLines(**{f: getattr(raw, f)[order]
                      for f in RawLines.__dataclass_fields__})
    write_rundir(tmp / "rundir", raw, PIPE_NPROF)
    write_rundir(tmp / "one", raw, 1)
    files = rundir_files(tmp / "rundir")

    res, wall, _ = drive(files, tmp / "warm")
    n_lines = int((tmp / "warm" / "MONORTM.LOG").read_text()
                  .split("TOTAL NUMBER OF LINES =")[1].split()[0])
    log(f"  warm run (cap from the device's free memory: "
        f"{[n for n, _, _ in res.engines]} profiles per chunk): "
        f"{wall:.3f} s; {n_lines} lines read from TAPE3")
    check(n_lines == 3074, f"the pipeline read {n_lines} lines, not 3074")
    launches = None
    outs, splits = {}, {}
    for cap in PIPE_CAPS:
        walls = []
        for rep in range(PIPE_REPS):
            out = tmp / f"cap{cap}_{rep}"
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            res, wall, stdout = drive(files, out, cap=cap)
            counts = {e: k.launches for e, k in kernels.items()}
            splits[(cap, rep)] = split_of(res)
            walls.append(wall)
            tb = np.stack(res.tb)
            log(f"  cap {cap} run {rep + 1}: {wall:.3f} s, "
                f"{PIPE_NPROF / wall:.3f} profiles/s; forward kernel "
                f"launches {counts}; chunks (profiles, engine, number of "
                f"all-Lorentz layers) "
                f"{[(n, e, len(lor)) for n, e, lor in res.engines]}; peak "
                f"device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            check(tb.shape == (PIPE_NPROF, NWN), f"tb shape {tb.shape}")
            if not np.isfinite(tb).all():
                FAILED.append(f"cap {cap} run {rep + 1}: non-finite Tb")
            if stdout.count("PROCESSING PROFILE NUMBER") != PIPE_NPROF:
                FAILED.append(f"cap {cap} run {rep + 1}: wrote "
                              f"{stdout.count('PROCESSING')} profiles")
            if not all(n > 0 for n in counts.values()):
                FAILED.append(f"cap {cap} run {rep + 1}: a forward kernel "
                              f"did not launch: {counts}; engines "
                              f"{res.engines}")
            if launches is None:
                launches = counts
            outs[(cap, rep)] = (out / "MONORTM.OUT").read_bytes()
        log(f"  cap {cap}: median {statistics.median(walls):.3f} s, "
            f"{PIPE_NPROF / statistics.median(walls):.3f} profiles/s "
            f"(walls {[round(w, 3) for w in walls]})")
        log("  " + stage_report(tmp / f"cap{cap}_{PIPE_REPS - 1}")
            .replace("\n", "\n  "))
        for rep in range(1, PIPE_REPS):
            if outs[(cap, rep)] != outs[(cap, 0)]:
                FAILED.append(f"cap {cap}: MONORTM.OUT of run {rep + 1} "
                              f"differs from run 1")
        log(f"  cap {cap}: engine split of each chunk (profiles, engine, "
            f"all-Lorentz layers): {res.engines}")
    c0, c1 = ((c, 0) for c in PIPE_CAPS)
    same_split = splits[c0] == splits[c1]
    same_bytes = outs[c0] == outs[c1]
    log(f"  MONORTM.OUT byte-identical between runs of one cap: "
        f"{all(outs[(c, r)] == outs[(c, 0)] for c in PIPE_CAPS for r in range(PIPE_REPS))}"
        f"; every profile's layers took the same engine at caps "
        f"{PIPE_CAPS[0]} and {PIPE_CAPS[1]}: {same_split}; cap "
        f"{PIPE_CAPS[0]} vs cap {PIPE_CAPS[1]}: {same_bytes}")
    # the two forward instantiations are not bitwise equal on a layer both
    # may take (batch_stages / engines_agree), so only runs in which every
    # profile's layers took the same engine are held to the same bytes
    if same_split and not same_bytes:
        FAILED.append(f"MONORTM.OUT differs between caps {PIPE_CAPS[0]} "
                      f"and {PIPE_CAPS[1]} under the same engine split")
    if not same_split:
        log("  caps not compared byte for byte: the engine split differs")

    # profile 1 against the port's CPU pipeline (plain line sums) on a
    # 1-profile copy of the rundir
    gpu = res.results[0]
    t0 = time.perf_counter()
    one = tmp / "one"
    files_one = dict(filein=one / "MONORTM.IN",
                     fileprof=one / "MONORTM_PROF.IN", hfile=one / "TAPE3")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = pipeline.run(**files_one, outdir=one / "out",
                           device="cpu").results[0]
    log(f"  CPU pipeline (1 profile) in {time.perf_counter() - t0:.1f} s")
    tb_err = float(np.max(np.abs(gpu.tb - ref.tb)))
    log(f"  profile 1 tb vs CPU pipeline: max_abs_err={tb_err:.3e} K")
    if tb_err > TB_ATOL:
        FAILED.append(f"profile 1 Tb differs from the CPU pipeline by "
                      f"{tb_err} K")
    compare(torch.as_tensor(gpu.otot), torch.as_tensor(ref.otot),
            "profile 1 total OD vs CPU pipeline")

    # IATM=1: the layering on the host, the rest on the card
    (tmp / "iatm1").mkdir()
    (tmp / "iatm1" / "MONORTM.IN").write_text(IATM1_TAPE5)
    res1, wall, _ = drive(files, tmp / "iatm1" / "out",
                          filein=tmp / "iatm1" / "MONORTM.IN")
    tb1 = np.stack(res1.tb)
    log(f"  IATM=1 run: {wall:.3f} s, {tb1.shape[0]} profile x "
        f"{tb1.shape[1]} wavenumbers, {res1.engines}, Tb "
        f"{float(tb1.min()):.4f}-{float(tb1.max()):.4f} K")
    if tb1.shape != (1, 11) or not np.isfinite(tb1).all():
        FAILED.append(f"IATM=1 run: Tb {tb1}")
    return {"launches": launches, "raw": raw}


def phase9_float64(tmp: Path, raw, kernels, reset_counts) -> None:
    """Phase 9 (see the module docstring)."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.lines import load_catalog
    from monortm_tpu_torch.models.od import (DENSE_LINE_TILE, DENSE_ROWS,
                                             DENSE_WN_TILE, build_dense_tiles)
    from monortm_tpu_torch.ops.lineshape import catalog_to_host

    write_rundir(tmp / "rundir8", raw, F64_NPROF)
    write_rundir(tmp / "one_sub", raw, 1, wn_step=F64_CPU_WN_STEP)
    files = rundir_files(tmp / "rundir8")
    cat = load_catalog(files["hfile"], 0.3, 55.0, tile=pipeline.LINE_TILE)
    tiles = build_dense_tiles(cat, catalog_to_host(cat, torch.float64),
                              np.linspace(0.3, 55.0, NWN), DENSE_WN_TILE,
                              DENSE_LINE_TILE)
    log(f"  dense block: {DENSE_ROWS} layer rows x {tiles['wt']} "
        f"wavenumbers x {tiles['win']['mol'].shape[1]} windowed / "
        f"{tiles['o2']['mol'].shape[1]} O2 lines; "
        f"{len(tiles['cand'])} wavenumber tiles")
    outs = {}
    for name, cap in (("cap 8, run 1", F64_NPROF), ("cap 8, run 2", F64_NPROF),
                      (f"cap {F64_CAPS[1]}", F64_CAPS[1])):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res, wall, _ = drive(files, tmp / f"f64 {name}", cap=cap,
                             dtype=torch.float64)
        counts = {e: k.launches for e, k in kernels.items()}
        tb = np.stack(res.tb)
        log(f"  float64 {name}: {wall:.3f} s, {F64_NPROF / wall:.4f} "
            f"profiles/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; chunks "
            f"{[(n, e) for n, e, _ in res.engines]}; line-sum kernel "
            f"launches {counts}")
        if tb.dtype != np.float64 or tb.shape != (F64_NPROF, NWN) \
                or not np.isfinite(tb).all():
            FAILED.append(f"float64 {name}: Tb {tb.dtype} {tb.shape}")
        if any(counts.values()) or any(e != "dense" for _, e, _ in
                                       res.engines):
            FAILED.append(f"float64 {name}: a float32 kernel engine ran")
        outs[name] = ((tmp / f"f64 {name}" / "MONORTM.OUT").read_bytes(),
                      res)
    names = list(outs)
    log("  " + stage_report(tmp / f"f64 {names[1]}").replace("\n", "\n  "))
    for a, b in ((names[0], names[1]), (names[0], names[2])):
        same = outs[a][0] == outs[b][0]
        log(f"  float64 MONORTM.OUT {a} vs {b}: byte-identical {same}")
        if not same:
            FAILED.append(f"float64 MONORTM.OUT {a} differs from {b}")

    # profile 1 against the port's CPU float64 pipeline, on every
    # F64_CPU_WN_STEP-th wavenumber (the CPU's dense engine takes minutes
    # for all 1024)
    gpu = outs[names[1]][1].results[0]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ref = pipeline.run(**rundir_files(tmp / "one_sub"),
                           outdir=tmp / "one_sub" / "out", device="cpu",
                           dtype=torch.float64).results[0]
    sub = slice(None, None, F64_CPU_WN_STEP)
    tb_err = float(np.max(np.abs(gpu.tb[sub] - ref.tb)))
    od_bad = np.abs(gpu.otot[sub] - ref.otot) > (
        F64_OD_ATOL + F64_OD_RTOL * np.abs(ref.otot))
    od_rel = float(np.max(np.abs(gpu.otot[sub] - ref.otot)
                          / np.maximum(np.abs(ref.otot), 1e-300)))
    log(f"  CPU float64 pipeline (1 profile, {len(ref.tb)} wavenumbers) in "
        f"{time.perf_counter() - t0:.1f} s; profile 1 tb vs CPU: "
        f"max_abs_err={tb_err:.3e} K; total OD max rel err {od_rel:.3e}, "
        f"violations of rtol {F64_OD_RTOL} atol {F64_OD_ATOL}: "
        f"{int(od_bad.sum())}")
    if tb_err > F64_TB_ATOL or od_bad.any():
        FAILED.append(f"float64 profile 1 differs from the CPU pipeline: "
                      f"Tb {tb_err} K, OD max rel {od_rel}")

    # the float32 dense engine with TF32 allowed writes the same bytes
    f32 = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            res, wall, _ = drive(files, tmp / f"f32 dense tf32 {tf32}",
                                 dtype=torch.float32, engine="dense")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        f32[tf32] = (tmp / f"f32 dense tf32 {tf32}" /
                     "MONORTM.OUT").read_bytes()
        log(f"  float32 dense engine, allow_tf32={tf32}: {wall:.3f} s, "
            f"{F64_NPROF / wall:.4f} profiles/s")
    log(f"  float32 dense MONORTM.OUT with TF32 allowed vs not: "
        f"byte-identical {f32[True] == f32[False]}")
    if f32[True] != f32[False]:
        FAILED.append("float32 dense MONORTM.OUT changes with allow_tf32")


def phase10_infrared(cat, state, dev, kernels, reset_counts) -> None:
    """Phase 10 (see the module docstring)."""
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.types import LayerState

    wn = np.unique(np.concatenate([np.linspace(a, b, 3)
                                   for _, a, b in IR_BANDS.values()]))
    m = MonoRTM(wn, 0.0, cat, nmol=22, device=dev)
    names = [s.name for s in m.od_model.cont.subs]
    log(f"  {len(wn)} wavenumbers {wn[0]:.1f}-{wn[-1]:.1f} cm^-1; "
        f"sub-continua {names}; Rayleigh "
        f"{m.od_model.cont.rayleigh_base is not None}")
    emis = torch.full((len(wn),), 0.95, device=dev)
    engine, lor = m.engine_split(state)
    reset_counts()
    out = m.forward(state, 288.0, emis, 1.0 - emis, irt=3, engine=engine,
                    lor_layers=lor)
    torch.cuda.synchronize()
    counts = {e: k.launches for e, k in kernels.items()}
    log(f"  engine {engine}, {len(lor)} all-Lorentz layers; forward kernel "
        f"launches {counts}")
    if not all(counts.values()):
        FAILED.append(f"infrared forward: a kernel did not launch {counts}")
    cpu = MonoRTM(wn, 0.0, cat, nmol=22, device="cpu")
    st0 = LayerState(**{f: getattr(state, f)[0].cpu() for f in FIELDS})
    ref = cpu.forward(st0, 288.0, emis.cpu(), 1.0 - emis.cpu(), irt=3,
                      engine=engine, lor_layers=lor)
    compare(out.od.od_total[0].cpu(), ref.od.od_total,
            "infrared od_total vs CPU")
    for sp, v in ref.od.oc.items():
        compare(out.od.oc[sp][0].cpu(), v, f"infrared {sp} continuum vs CPU")
    tb_err = float((out.rt.tb[0].cpu() - ref.rt.tb).abs().max())
    log(f"  infrared tb vs CPU: max_abs_err={tb_err:.3e} K")
    if tb_err > TB_ATOL or not bool(torch.isfinite(out.rt.tb).all()):
        FAILED.append(f"infrared tb differs from the CPU path by {tb_err} K")
    for name, (sp, a, b) in IR_BANDS.items():
        band = torch.as_tensor((wn >= a) & (wn <= b), device=dev)
        od = out.od.oc[sp][..., band]
        if name not in names and name != "rayleigh":
            FAILED.append(f"sub-continuum {name} was not built")
        if not bool((od != 0).any()):
            FAILED.append(f"sub-continuum {name}: {sp} OD all zero on "
                          f"{a}-{b} cm^-1")
        log(f"  {name}: {sp} OD on {a}-{b} cm^-1 in "
            f"[{float(od.min()):.3e}, {float(od.max()):.3e}]")


def print_batch_stages(model, dev) -> bool:
    """Print `batch_stages` for chunks of PIPE_NPROF and PIPE_CAPS[1]
    profiles of phase 8's state, and `engines_agree` over it; returns
    whether every stage of profile 1 was bitwise the same."""
    from monortm_tpu_torch.testing import synthetic_state
    st = synthetic_state(nlay=NLAY, batch=PIPE_NPROF, device=dev,
                         dtype=torch.float32)
    rows = batch_stages(model, st, PIPE_CAPS[1])
    log(f"  profile 1 in a chunk of {PIPE_NPROF} vs {PIPE_CAPS[1]} "
        f"profiles, stage by stage:")
    for name, same, diff in rows:
        log(f"    {'same' if same else 'DIFFERS'}  {name}"
            + ("" if same else f" (max abs difference {diff:.3e})"))
    first = next((name for name, same, _ in rows if not same), None)
    log(f"  first stage that depends on the chunk: {first}")
    lor, same, diff = engines_agree(model, st)
    log(f"  VOIGT=true vs VOIGT=false on the {len(lor)} all-Lorentz layers "
        f"of {PIPE_NPROF} profiles: bitwise {same}, max abs difference "
        f"{diff:.3e}")
    return first is None


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from monortm_tpu_torch.ops import linesum_kernel
    from monortm_tpu_torch.ops.linesum import (VOIGT_KERNEL,
                                               line_sum_bwd_plain,
                                               precompute)
    from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
    from monortm_tpu_torch.ops.voigt import sdvoigt
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.testing import (synthetic_catalog_mw,
                                           synthetic_state)
    from monortm_tpu_torch.types import LayerState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    kernels = {"full": VOIGT_KERNEL, "lorentz": LORENTZ_KERNEL}
    t_phase = time.perf_counter()

    def phase_done(k):
        nonlocal t_phase
        log(f"phase {k} took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        check(not FAILED, f"phase {k}: " + "; ".join(FAILED))

    def reset_counts():
        for k in kernels.values():
            k.launches = k.bwd_launches = 0

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    libs = linesum_kernel.build(verbose=True)
    log(f"phase 1 build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_done(1)
    if argv == ["--batch-stages"]:
        # the chunk-dependence diagnosis of phase 8 alone
        cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=256)
        wn = np.linspace(0.3, 55.0, NWN)
        model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
        return 0 if print_batch_stages(model, dev) else 1

    def with_p(st, p_hpa):
        return LayerState(p=torch.full_like(st.p, p_hpa), t=st.t, tz=st.tz,
                          wkl=st.wkl, wbrodl=st.wbrodl, clw=st.clw)

    def operands(model, state, engine, layers):
        """The kernel operands the forward gives `engine` for `layers`,
        with the plan's reverse map last."""
        od = model.od_model
        ix = torch.as_tensor(layers, device=dev)
        sub = LayerState(p=state.p.index_select(-1, ix),
                         t=state.t.index_select(-1, ix), tz=state.tz,
                         wkl=state.wkl.index_select(-2, ix),
                         wbrodl=state.wbrodl.index_select(-1, ix),
                         clw=state.clw)
        scor = od.tips.scor(sub.t)
        plan = od.dev_plans[engine]
        pre = precompute(plan["cat"], sub.p.reshape(-1), sub.t.reshape(-1),
                         sub.wkl.reshape(-1, 39), sub.wbrodl.reshape(-1),
                         scor.reshape(-1, 39 * 9), od.line_cfg)
        return (pre, plan["cat"]["mol"], plan["wn_hi"], plan["wn_lo"],
                plan["cand_map"], plan["cand_valid"], plan["nt"], plan["wt"],
                od.nmol, plan["rev"])

    def without_sd(pre):
        """The operands with the catalog's speed dependence off, as the
        prologue forms them for sdep = 0."""
        pre = dict(pre)
        pre["sdep"] = torch.zeros_like(pre["sdep"])
        pre["k3v"] = sdvoigt(torch.tensor(25.0, device=dev), pre["hw"],
                             pre["ad"], torch.zeros_like(pre["hw"]))
        return pre

    def kernel_vs_plain(args, engine, what):
        got = kernels[engine](*args[:9])
        ref = kernels[engine].plain(*args[:9])
        torch.cuda.synchronize()
        return compare(got, ref, what)

    def bwd_vs_plain(args, g, engine, what):
        """Each cotangent of the adjoint kernel against the plain adjoint:
        float32, or for SD_PARTIALS of the Voigt instantiation float64;
        returns the worst (max abs error, err / max|ref|) over the
        seven."""
        k = kernels[engine]
        pre, mol, wh, wl, cm, cv, nt, wt, n_mol, rev = args
        got = k.launch_bwd(pre, mol, wh, wl, *rev, nt, wt, n_mol, g)
        again = k.launch_bwd(pre, mol, wh, wl, *rev, nt, wt, n_mol, g)
        if not all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None):
            FAILED.append(f"{what}: two runs of the adjoint kernel differ")
        ref = k.plain_bwd(pre, mol, wh, wl, cm, cv, nt, wt, n_mol, g)
        if k.voigt:
            d = lambda v: v.double() if torch.is_tensor(v) else v
            ref64 = line_sum_bwd_plain(
                {n: d(v) for n, v in pre.items()}, mol, d(wh), d(wl), cm,
                cv, nt, wt, n_mol, d(g), f32_fallback=True)
        torch.cuda.synchronize()
        worst = (0.0, 0.0)
        for i, (name, a) in enumerate(zip(PER_LN, got)):
            if ref[i] is None:
                check(a is None, f"{what} {name}: expected no cotangent")
                continue
            if k.voigt and name in SD_PARTIALS:
                b = ref64[i]
                e32 = float((ref[i].double() - b).abs().max()
                            / b.abs().max().clamp_min(1e-300))
                e = compare(a.double(), b, f"{what} d{name} vs float64 "
                            f"(plain float32: {e32:.2e} of max)", BWD_ATOL)
            else:
                e = compare(a, ref[i], f"{what} d{name}", BWD_ATOL)
            worst = tuple(map(max, worst, e))
        return worst

    def deferred_vs_count(args, what, layers_with_none=()):
        """The (layer, line) pairs the last Voigt adjoint call deferred to
        its second kernel against those with kept SD-Voigt lanes counted
        here; `layers_with_none` must have none (their blocks leave the
        second kernel at once)."""
        _, sd_lanes, _ = lane_counts(*args[:9], voigt=True)
        marked = kernels["full"].deferred != 0
        per_layer = sd_lanes.sum(1).tolist()
        log(f"  {what}: {int(sd_lanes.sum())} deferred SD-Voigt pairs in "
            f"{int(marked.sum())} of {marked.numel()} (layer, line); per "
            f"layer {per_layer[:8]}{'...' if len(per_layer) > 8 else ''}")
        if not torch.equal(marked, sd_lanes > 0):
            FAILED.append(f"{what}: the kernel deferred "
                          f"{int(marked.sum())} (layer, line) pairs, "
                          f"{int((sd_lanes > 0).sum())} have SD-Voigt lanes")
        if any(per_layer[i] for i in layers_with_none):
            FAILED.append(f"{what}: SD-Voigt lanes in {layers_with_none}")
        return per_layer

    small_wn = np.linspace(0.4, 50.0, 64)
    small = MonoRTM(small_wn, float(small_wn[1] - small_wn[0]),
                    synthetic_catalog_mw(n_h2o=48, n_o2=16, tile=128),
                    nmol=22, device=dev)
    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512)
    n_lines = int(np.sum(np.asarray(cat.valid)))
    wn = np.linspace(0.3, 55.0, NWN)
    model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)

    # ---- phase 2: each forward kernel vs its plain version -------------
    log("phase 2 kernel vs plain (rtol=2e-5, atol=2e-6*max|ref|)")
    for name, m, nlay, batch in (("small", small, 4, None),
                                 ("bench", model, NLAY, BATCH)):
        st = synthetic_state(nlay=nlay, batch=batch, device=dev,
                             dtype=torch.float32)
        # the two pressure regimes of tests/test_pallas.py:88-100
        for p_hpa in (1013.0, 0.02):
            for engine in ("full", "lorentz"):
                kernel_vs_plain(operands(m, with_p(st, p_hpa), engine,
                                         list(range(nlay))), engine,
                                f"{name} {p_hpa} hPa {engine}")
    phase_done(2)

    state = synthetic_state(nlay=NLAY, batch=BATCH, device=dev,
                            dtype=torch.float32)
    emis = torch.full((NWN,), 0.95, device=dev)
    refl = 1.0 - emis
    tsfc = torch.full((BATCH, 1), 288.0, device=dev)
    engine, lor = model.engine_split(state)
    voigt = [i for i in range(NLAY) if i not in set(lor)]
    log(f"engine split on the GPU: {engine}, {len(lor)} of {NLAY} layers "
        f"all-Lorentz")
    check(engine == "hybrid", f"expected the hybrid split, got {engine}")

    def forward():
        return model.forward(state, tsfc, emis, refl, irt=3, engine=engine,
                             lor_layers=lor)

    # the retrieval loss of parallel/sharding.py:97-99 against the state
    # warmed by 1 K, so that its gradient is not zero
    warm = LayerState(p=state.p, t=state.t + 1.0, tz=state.tz + 1.0,
                      wkl=state.wkl, wbrodl=state.wbrodl, clw=state.clw)
    with torch.no_grad():
        tb_obs = model.tb(warm, tsfc, emis, refl, irt=3, engine=engine,
                          lor_layers=lor)

    def loss_of(m, st, obs, ts, em, eng, lo):
        tb = m.tb(st, ts, em, 1.0 - em, irt=3, engine=eng, lor_layers=lo)
        return torch.mean((tb - obs) ** 2)

    def value_and_grad(m=model, st=state, obs=tb_obs, ts=tsfc, em=emis,
                       eng=engine, lo=lor):
        leaves = LayerState(**{f: getattr(st, f).detach().requires_grad_()
                               for f in FIELDS})
        loss = loss_of(m, leaves, obs, ts, em, eng, lo)
        grads = torch.autograd.grad(loss, [getattr(leaves, f)
                                           for f in FIELDS])
        return loss.detach(), dict(zip(FIELDS, grads))

    # ---- phase 3: the forward at the bench workload --------------------
    log("phase 3 forward at the bench workload")
    reset_counts()
    out = forward()
    torch.cuda.synchronize()
    launches = {e: k.launches for e, k in kernels.items()}
    log(f"  kernel launches in the forward: {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    tb = out.rt.tb
    check(tuple(tb.shape) == (BATCH, NWN), f"tb shape {tuple(tb.shape)}")
    check(bool(torch.isfinite(tb).all()), "non-finite tb")
    check(bool(((tb > 2.7) & (tb < 330.0)).all()), "tb outside 2.7-330 K")
    check(bool(torch.isfinite(out.od.od_total).all()), "non-finite od")

    # the CPU path (plain line sums) on profile 0 is the reference
    t0 = time.perf_counter()
    cpu_model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22,
                        device="cpu")
    st0 = LayerState(**{f: getattr(state, f)[0].cpu() for f in FIELDS})
    ref = cpu_model.forward(st0, 288.0, emis.cpu(), refl.cpu(), irt=3,
                            engine=engine, lor_layers=lor)
    log(f"  CPU reference (profile 0) in {time.perf_counter() - t0:.1f}"
        f" s")
    compare(out.od.od_total[0].cpu(), ref.od.od_total, "od_total vs CPU")
    tb_err = float((tb[0].cpu() - ref.rt.tb).abs().max())
    log(f"  tb vs CPU: max_abs_err={tb_err:.3e} K")
    check(tb_err <= TB_ATOL, f"tb differs from the CPU path by {tb_err} K")
    phase_done(3)

    results = {}
    main_args = {"full": operands(model, state, "full", voigt),
                 "lorentz": operands(model, state, "lorentz", list(lor))}

    # ---- phase 4: forward timings --------------------------------------
    log("phase 4 timings")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd_ms = statistics.median(times) * 1e3
    evals = BATCH * NLAY * NWN * n_lines
    log(f"  forward: median {fwd_ms:.3f} ms over 10, "
        f"od_evals_per_s={evals / (fwd_ms / 1e3):.4e} "
        f"({BATCH}x{NLAY}x{NWN}x{n_lines})")
    for eng, replaces in (
            ("full", "monortm_tpu/ops/linesum_pallas.py:94"),
            ("lorentz", "monortm_tpu/ops/linesum_lorentz.py:63")):
        args = main_args[eng]
        err, rel = kernel_vs_plain(args, eng, f"bench main-path operands "
                                              f"{eng}")
        k = kernels[eng]
        ms = cuda_ms(lambda: k(*args[:9]), 20)
        plain_ms = cuda_ms(lambda: k.plain(*args[:9]), 3)
        counts, _, by_class = lane_counts(*args[:9], voigt=k.voigt)
        n_bytes = line_bytes(args, "fwd", k.voigt)
        f_ms, f_by = bound("fwd", k.voigt, counts, n_bytes)
        log(f"  {eng} kernel: bound {f_ms:.4f} ms ({f_by}) at the flat "
            f"count of operations {OPS[('fwd', k.voigt)]}")
        b_ms, b_by = bound_by_class("fwd", k.voigt, counts, by_class,
                                    n_bytes)
        info = k.fwd_info(args[6], args[7], args[8])
        L = args[0]["stild"].shape[0]
        log(f"  {eng} kernel: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; lanes lor/lor+k2/sd/sd+k2 "
            f"{counts}; Lorentz lanes by class without / with k2 "
            f"{by_class}) (L={L} layers); built {info}")
        results[f"linesum_{k.name}"] = {
            "name": f"linesum_{k.name}", "route": "cuda",
            "source": "monortm_tpu_torch/csrc/linesum.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "bound_ms_flat_count": f_ms,
            "registers": info["registers"],
            "blocks_per_sm": info["blocks_per_sm"]}
    phase_done(4)

    # ---- phase 5: each adjoint kernel vs its plain version --------------
    captured = {}
    log(f"phase 5 adjoint kernel vs plain (rtol={RTOL}, atol={BWD_ATOL}"
        f"*max|ref|; Voigt {SD_PARTIALS} against float64)")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, m, nlay in (("small", small, 4), ("bench", model, NLAY)):
        st = synthetic_state(nlay=nlay, device=dev, dtype=torch.float32)
        for p_hpa, sd_on in ((1013.0, True), (20.0, True), (0.02, True),
                             (0.02, False)):
            for eng in ("full", "lorentz"):
                args = operands(m, with_p(st, p_hpa), eng,
                                list(range(nlay)))
                if not sd_on:
                    args = (without_sd(args[0]),) + args[1:]
                L, wp = args[0]["stild"].shape[0], args[2].shape[0]
                g = torch.randn((L, wp, args[8]), generator=gen,
                                device=dev)
                bwd_vs_plain(args, g, eng, f"{name} {p_hpa} hPa "
                             f"{'SD on' if sd_on else 'SD off'} {eng}")
        # layers at 1013 and 0.02 hPa alternating: blocks full of SD-Voigt
        # lanes beside blocks with none, in one call
        mixed = torch.where(torch.arange(nlay, device=dev) % 2 == 0,
                            1013.0, 0.02).to(st.p.dtype)
        args = operands(m, LayerState(p=mixed, t=st.t, tz=st.tz, wkl=st.wkl,
                                      wbrodl=st.wbrodl, clw=st.clw),
                        "full", list(range(nlay)))
        L, wp = args[0]["stild"].shape[0], args[2].shape[0]
        g = torch.randn((L, wp, args[8]), generator=gen, device=dev)
        bwd_vs_plain(args, g, "full", f"{name} 1013 / 0.02 hPa full")
        per_layer = deferred_vs_count(args, f"{name} 1013 / 0.02 hPa",
                                      range(0, nlay, 2))
        # (the small plan's 64 wavenumbers lie off every line's core)
        if name == "bench" and not all(per_layer[i]
                                       for i in range(1, nlay, 2)):
            FAILED.append(f"{name} 1013 / 0.02 hPa: a near-vacuum layer has "
                          f"no SD-Voigt lane: {per_layer}")
    # the real cotangent of the loss, captured once from the main path
    for eng, k in kernels.items():
        def record(*a, _e=eng, _k=k):
            captured[_e] = a
            return type(_k).launch_bwd(_k, *a)
        k.launch_bwd = record
    try:
        value_and_grad()
    finally:
        for k in kernels.values():
            del k.launch_bwd
    for eng in kernels:
        err, rel = bwd_vs_plain(main_args[eng], captured[eng][-1], eng,
                                f"bench main-path operands {eng}")
        results[f"linesum_bwd_{kernels[eng].name}"] = {
            "max_abs_err": err, "max_rel_err": rel}
    deferred_vs_count(main_args["full"], "bench main-path operands")
    phase_done(5)

    # ---- phase 6: the retrieval adjoint at the bench workload -----------
    log("phase 6 value_and_grad of mean((tb - tb_obs)^2) at the bench "
        "workload")
    reset_counts()
    started = {e: k.bwd_kernels_started() for e, k in kernels.items()}
    loss, grads = value_and_grad()
    torch.cuda.synchronize()
    counts6 = {e: (k.launches, k.bwd_launches)
               for e, k in kernels.items()}
    started = {e: k.bwd_kernels_started() - started[e]
               for e, k in kernels.items()}
    log(f"  loss {float(loss):.6e}; (forward, adjoint) launches: "
        f"{counts6}; kernels the adjoint library started: {started}")
    check(all(a > 0 and b > 0 for a, b in counts6.values()),
          f"a kernel of the path did not launch: {counts6}")
    for f, gr in grads.items():
        log(f"  d loss / d {f}: max|g|={float(gr.abs().max()):.4e} "
            f"shape {tuple(gr.shape)}")
        check(bool(torch.isfinite(gr).all()), f"non-finite grad {f}")
        check(float(gr.abs().max()) > 0.0, f"zero grad {f}")
    for name, (a, b) in counts6.items():
        results[f"linesum_{kernels[name].name}"]["launches"] = a
        results[f"linesum_bwd_{kernels[name].name}"].update(
            launches=b, kernels_per_launch=started[name] / b)

    # the small model's full-pipeline gradient against the CPU path
    sst = synthetic_state(nlay=4, batch=2, device=dev,
                          dtype=torch.float32)
    s_eng, s_lor = small.engine_split(sst)
    s_em = torch.full((len(small_wn),), 0.95, device=dev)
    s_ts = torch.full((2, 1), 288.0, device=dev)
    with torch.no_grad():
        s_obs = small.tb(LayerState(p=sst.p, t=sst.t + 1.0,
                                    tz=sst.tz + 1.0, wkl=sst.wkl,
                                    wbrodl=sst.wbrodl, clw=sst.clw),
                         s_ts, s_em, 1.0 - s_em, irt=3, engine=s_eng,
                         lor_layers=s_lor)
    _, g_gpu = value_and_grad(small, sst, s_obs, s_ts, s_em, s_eng,
                              s_lor)
    small_cpu = MonoRTM(small_wn, float(small_wn[1] - small_wn[0]),
                        synthetic_catalog_mw(n_h2o=48, n_o2=16, tile=128),
                        nmol=22, device="cpu")
    cpu = lambda x: x.cpu()
    _, g_cpu = value_and_grad(
        small_cpu, LayerState(**{f: cpu(getattr(sst, f))
                                 for f in FIELDS}),
        cpu(s_obs), cpu(s_ts), cpu(s_em), s_eng, s_lor)
    log(f"  small model ({s_eng}, Lorentz layers {s_lor}) gradient vs "
        f"the CPU path (rtol=5e-3, atol=1e-4*max|ref|)")
    for f in FIELDS:
        compare(g_gpu[f].cpu(), g_cpu[f], f"d loss / d {f}",
                atol_rel=1e-4, rtol=5e-3)

    # central differences through the forward at profile 0's layer
    # of each engine with the largest gradient.  The loss is summed
    # in float64 from the float32 Tb, whose ~2e-5 K rounding over the
    # 8192 values leaves ~1e-8 of noise in a 2 x 4 K difference:
    # atol=2e-8, rtol=5e-2 (test_pallas.py:328-341).
    def loss_t(t):
        with torch.no_grad():
            st = LayerState(p=state.p, t=t, tz=state.tz, wkl=state.wkl,
                            wbrodl=state.wbrodl, clw=state.clw)
            tb = model.tb(st, tsfc, emis, refl, irt=3, engine=engine,
                          lor_layers=lor)
            return float(torch.mean((tb.double() - tb_obs) ** 2))

    eps = 4.0
    gt = grads["t"]
    for layers, kind in ((voigt, "SD-Voigt engine"),
                         (list(lor), "all-Lorentz engine")):
        il = max(layers, key=lambda i: abs(float(gt[0, i])))
        tp, tm = state.t.clone(), state.t.clone()
        tp[0, il] += eps
        tm[0, il] -= eps
        fd = (loss_t(tp) - loss_t(tm)) / (2 * eps)
        an = float(gt[0, il])
        log(f"  central difference, {kind} layer {il}: autograd "
            f"{an:.6e}, fd {fd:.6e} (eps={eps} K)")
        check(abs(an - fd) <= 5e-2 * abs(fd) + 2e-8,
              f"gradient of layer {il} ({kind}) differs from central "
              f"differences: {an} vs {fd}")
    phase_done(6)

    # ---- phase 7: timings ----------------------------------------------
    log("phase 7 timings")
    fwd_t, vag_t = [], []
    for _ in range(12):
        for fn, acc in ((forward, fwd_t), (value_and_grad, vag_t)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
    log(f"  forward median {statistics.median(fwd_t) * 1e3:.3f} ms, "
        f"value_and_grad median {statistics.median(vag_t) * 1e3:.3f} ms "
        f"(12 each, interleaved)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    value_and_grad()
    torch.cuda.synchronize()
    log(f"  value_and_grad peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    log(f"  forward peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for eng in kernels:
        k = kernels[eng]
        pre, mol, wh, wl, cm, cv, nt, wt, n_mol, rev = main_args[eng]
        g = captured[eng][-1]
        ms = cuda_ms(lambda: k.launch_bwd(pre, mol, wh, wl, *rev, nt, wt,
                                          n_mol, g), 10)
        plain_ms = cuda_ms(lambda: k.plain_bwd(pre, mol, wh, wl, cm, cv,
                                               nt, wt, n_mol, g), 1)
        counts, _, by_class = lane_counts(*main_args[eng][:9],
                                          voigt=k.voigt)
        n_bytes = line_bytes(main_args[eng], "bwd", k.voigt)
        d_ms, d_by = bound("bwd", k.voigt, counts, n_bytes, OPS_DUAL)
        log(f"  {eng} adjoint kernel: bound {d_ms:.4f} ms ({d_by}) at the "
            f"dual-number count of operations {OPS_DUAL[('bwd', k.voigt)]}")
        b_ms, b_by = bound_by_class("bwd", k.voigt, counts, by_class,
                                    n_bytes)
        info = k.bwd_info(nt, wt, n_mol)
        log(f"  {eng} adjoint kernel: {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}; lanes {counts}; Lorentz "
            f"lanes by class without / with k2 {by_class}) "
            f"(L={pre['stild'].shape[0]} layers); built {info}")
        results[f"linesum_bwd_{k.name}"].update({
            "name": f"linesum_bwd_{k.name}", "route": "cuda",
            "source": "monortm_tpu_torch/csrc/linesum_bwd.cu",
            "replaces": "monortm_tpu/ops/linesum_pallas.py:328",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "bound_ms_dual_count": d_ms, "registers": info["registers"],
            "blocks_per_sm": info["blocks_per_sm"]})
    phase_done(7)

    # ---- phase 8: the pipeline at full width ----------------------------
    log(f"phase 8 pipeline: {PIPE_NPROF} profiles x {NLAY} layers x {NWN} "
        f"wavenumbers x {n_lines} lines, chunk caps {PIPE_CAPS}")
    if not print_batch_stages(model, dev):
        FAILED.append("a stage of profile 1 depends on its chunk")
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = Path(tmp_dir.name)
    pipe = phase8_pipeline(tmp, kernels, reset_counts)
    for eng, k in kernels.items():
        results[f"linesum_{k.name}"]["pipeline_launches"] = \
            pipe["launches"][eng]
    phase_done(8)

    # ---- phase 9: float64 through the dense engine ----------------------
    log(f"phase 9 float64 pipeline: phase 8's rundir, its first {F64_NPROF} "
        f"profiles, caps {F64_CAPS}")
    phase9_float64(tmp, pipe["raw"], kernels, reset_counts)
    tmp_dir.cleanup()
    phase_done(9)

    # ---- phase 10: an infrared grid through the default kernels ---------
    log("phase 10 infrared forward: every MT_CKD sub-continuum and Rayleigh")
    phase10_infrared(cat, state, dev, kernels, reset_counts)
    phase_done(10)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    rows = list(results.values())
    check(len(rows) == 4 and all(set(keys) <= set(r) for r in rows)
          and all(r["launches"] for r in rows),
          f"incomplete kernel results: {rows}")
    extra = ("bound_ms_flat_count", "bound_ms_dual_count", "registers",
             "blocks_per_sm", "kernels_per_launch", "pipeline_launches")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
