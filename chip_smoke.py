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
    kernels and agrees with the CPU path on every 8th wavenumber of one
    profile; a model with `LineConfig(chi_fn=...)` on the card is refused
    with an error naming chi_fn (a Python callable cannot enter the
    kernels);
  4 forward timings, each forward kernel beside its plain version;
  5 each adjoint instantiation against its plain version (seeded
    cotangents on the small and bench plans at 1013 / 20 / 0.02 hPa, with
    layers at 1013 and 0.02 hPa alternating in one call, and the real
    cotangent of the loss on the main path's operands; the Voigt
    instantiation's partials by shift, hw and ad against the plain
    version run in float64, where the plain float32 adjoint's dhw must
    be within 1.5e-6 * max (C2; the kernel's is printed beside it, held
    at the adjoint's atol of 1e-5 * max); every call twice,
    bitwise equal; the
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
    port's CPU pipeline on a 1-profile copy listing every 8th wavenumber,
    and a small IATM=1 rundir (US standard, 0-30 km) on the card to
    finite Tb;
  9 float64 at full width through the dense engine: phase 8's rundir cut
    to its first 4 profiles, `run(dtype=torch.float64)` twice at a cap
    of 4 and once at 2, MONORTM.OUT byte-identical across the three, no
    line-sum kernel launched, wall seconds, profiles/s, peak memory and
    the dense block's shape; profile 1 against the port's CPU float64
    pipeline on every 32nd wavenumber (Tb within 1e-9 K, total OD at rtol
    1e-10, atol 1e-14); the dense engine at other tiles (F64_TILES, 64
    wavenumbers x 512 lines: `run(engine="xla", wn_tile=64,
    line_tile=512)`, the JAX CLI's flags), its chunk cap left to
    `_max_batch`: every profile's Tb within 1e-9 K and total OD at rtol
    1e-10 of the default tiles' run, every chunk dense and no kernel
    launched, its wall seconds, profiles/s, peak memory and chunk cap
    beside the default tiles'; the float32 dense engine writes the same
    bytes with `torch.backends.cuda.matmul.allow_tf32` on and off, and
    at F64_TILES a MONORTM.OUT within rtol 5e-5, atol 1e-4 K of them;
  10 an infrared-to-UV grid (three wavenumbers inside each activation
    range of the twelve sub-continua a microwave grid leaves off, and
    Rayleigh above 820 cm^-1) through the default float32 kernels and the
    hybrid split: both forward kernels launch, od_total, every continuum
    species and Tb agree with the CPU path at the forward tolerance, and
    no sub-continuum's OD is all zero on its band;
  11 cross-sections (IXSECT=1) through the pipeline at full width: an
    IATM=0 rundir of 40 layers x 1024 wavenumbers inside the synthetic
    cross-section band (CCL4 and F11 over 780-820 cm^-1), bench's 3074
    lines moved into it, cut to 4 profiles (depth, for the host's
    `xsec-prep` time), run twice on the card: MONORTM.OUT byte-identical,
    XSEC_OD non-zero, the VOIGT=true kernel launched (at 780-820 cm^-1 no
    layer's lines are all in the Lorentz regime, so the engine split sends
    every layer to it), each stage's seconds; profile 1 against the port's
    CPU pipeline on a 1-profile copy, on every 8th wavenumber (Tb within
    2e-3 K, OD at the forward tolerance);
  12 the native host helper (`monortm_tpu_torch.native`, g++): built;
    the IATM=1 layering of phase 8's MONORTM.IN with the helper and with
    the Python walk (MONORTM_TPU_TORCH_NATIVE=0): AMERGE outputs bitwise,
    the layered state within rtol 1e-12; `load_catalog` on phase 8's
    TAPE3 and on a synthetic TAPE3 of 200002 records written with
    `write_tape3`: resolved lines and packed catalog equal field by field;
    seconds per profile of the layering and seconds of the catalog
    stage, each side.
  13 meshes: gloo ranks sharing the one card (`--backend gloo --device
    cuda:0`; NCCL refuses two ranks on one card, so this shows
    correctness, not scaling), started by `parallel.distributed.spawn`:
    the CLI with `--distributed` on phase 8's rundir at meshes 2x1, 1x2
    and 2x2, MONORTM.OUT byte-identical to phase 8's cap-64 run when the
    engine split is the same, every rank launching both forward kernels;
    1x1x2 (the candidate columns over two line ranks) twice with
    `--netcdf`, byte-identical run to run, Tb within 2e-3 K and the layer
    OD at the forward tolerance of a single-device NetCDF run; float64 at
    1x2 on phase 9's cut, byte-identical to phase 9; and
    `shard_forward_and_grad` at bench.py's workload on 1x2 and 2x1
    (`--mesh-rank`, one process per rank): loss and gathered gradients
    against phase 6's single-device value_and_grad (rtol 1e-5, atol 1e-6
    x max), every rank launching all four kernels, and each rank's forward
    and adjoint kernels against their plain versions on its own plan (the
    layers each engine took, a seeded cotangent).  Each rank's backend,
    device and launches and each mesh's wall seconds are printed.
  14 the reference's capacity envelope: (a) each forward and adjoint
    instantiation on 65600 flat rows of a one-tile plan (past CUDA's
    65535 limit on gridDim.y, which the wrapper launches in blocks),
    bitwise equal to the same rows launched in two calls, 2 CUDA calls
    each, the rows past the limit against the plain forward; (b) the JAX
    package's capacity check (250k H2O lines over 0.5-3000 cm^-1, 8192
    wn, 40 layers): fewer candidate columns than a fifth of the line
    tiles, finite OD from the VOIGT=true kernel; (c) one profile x 200
    layers x 80000 wn x 250k lines through `pipeline.run`
    (`monortm_tpu_torch.envelope`, the JAX tools/bench_envelope_e2e.py's
    inputs): wall, nominal evaluations per second, HOST PULL, peak
    memory against `_max_batch`'s estimate, the stage report, the engine
    split, each forward kernel's launches and its time by CUDA events
    around them (one timed wrapper call per launch), every Tb finite;
    (d) the envelope's model rebuilt from its files (the run's grid and
    engine split), each forward kernel against its plain version on
    sampled blocks of its plans (the two highest- and lowest-pressure
    rows of each engine by the first, last and two O2-band wn tiles),
    both against the plain sum in float64, with the kernel's and plain
    version's times and the bound of that sample grid (16 blocks, so no
    roofline of the kernel at the envelope); (e) every 2500th wavenumber
    as an explicit list: the float32 kernels' Tb within 0.05 K of the
    float64 dense engine's, and the envelope run's Tb there within the
    forward's 2e-3 K of the list's.
  15 the retrieval adjoint at the envelope, on phase 14's rebuilt model
    and state (`monortm_tpu_torch.envelope.envelope_grad`, what
    `python -m monortm_tpu_torch.envelope --grad` runs): value and
    gradient of phase 6's loss through `MonoRTM.tb` by every float field,
    once: all four kernels launched (the deferred pass by the library's
    count of started kernels), every gradient finite and not all zero,
    peak memory against `_profile_bytes`' forward estimate, wall seconds,
    each kernel's time by CUDA events; central differences at one layer
    of each engine (phase 6's eps and tolerance); each adjoint
    instantiation on sampled pairs, the first and last row of its launch
    (the engine's highest- and lowest-pressure layers) by the line tile
    nearest the band's middle and the one of the 60 GHz O2 band, each
    swept over its whole reverse-map row (a sub-plan of those tiles), on
    the real cotangent of the full run: bitwise the full launch's, within
    the adjoint's tolerance of the plain float32 adjoint, both printed
    against the plain adjoint in float64; each adjoint kernel's device
    time in one call at the envelope by torch.profiler (sweep and deferred
    pass apart), the deferral words against the (layer, line) pairs with
    SD-Voigt lanes, the slots the deferred pass visits, and the bound of
    each of the four kernels at the envelope (lanes counted by interval,
    `lane_counts_by_interval`, which phase 4 holds equal to `lane_counts`
    at the bench cell).

Run from the repository root:  python3 chip_smoke.py
(`python3 chip_smoke.py --batch-stages` builds the kernels and runs only
phase 8's stage-by-stage chunk comparison; `--envelope` builds them and
runs only phases 14 and 15, printing their readings as JSON; `--float64`
runs only phase 9, building nothing; `--mesh-rank DIR MESH` is one rank
of phase 13's gradient check, started by phase 13.)
Exits non-zero (and prints no result line) without a CUDA device or when
any phase fails; a phase prints all of its comparisons before it fails.
The line before the last two lists each kernel with its launches on the
main path (`launches` counts calls of the wrapper; an adjoint row's
`kernels_per_launch` is the kernels its library started on the main path
over those calls: the Voigt adjoint's two), its worst error against its plain version (max_abs_err, and max_rel_err = the
worst err / max|ref| over the kernel's outputs), its time, its plain
version's time and its bound; phase 14 adds each kernel's CUDA calls on
65600 rows, and each forward kernel's launches and time in the envelope
run and its readings on the sampled blocks; phase 15 each kernel's bound
at the envelope, its launches and time in the envelope's value_and_grad,
and each adjoint's readings on the sampled pairs.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import functools
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
# phases 3 and 8: the CPU references (plain line sums on the host) on
# every CPU_WN_STEP-th wavenumber of one profile (all 1024 took ~70 s
# each on the card's host)
CPU_WN_STEP = 8
# phase 9: float64 on phase 8's rundir cut to its first profiles; profile
# 1 against the CPU on every F64_CPU_WN_STEP-th wavenumber, at the e2e
# oracle's float64 budgets (tests/test_e2e_oracle.py:27-28)
F64_NPROF, F64_CAPS, F64_CPU_WN_STEP = 4, (4, 2), 32
F64_TB_ATOL, F64_OD_RTOL, F64_OD_ATOL = 1e-9, 1e-10, 1e-14
# phase 9: the dense engine's other tiles (wavenumbers, lines), the JAX
# CLI's --wn-tile / --line-tile; float32 MONORTM.OUT there against the
# default tiles' at the pipeline's tolerance (tests/test_torch_pipeline.py)
F64_TILES = (64, 512)
RTOL_OUT, ATOL_OUT = 5e-5, 1e-4
# phase 11: cross-sections at full width, cut to XS_NPROF profiles;
# profile 1 against the CPU on every XS_CPU_WN_STEP-th wavenumber (the
# CPU's plain Voigt sums take minutes for all 1024)
XS_NPROF, XS_CPU_WN_STEP = 4, 8
# C2: the plain float32 adjoint's dhw against float64 (the kernel's is
# printed beside it)
C2_LIMIT = 1.5e-6
# phase 12: the big synthetic TAPE3 (records), the layering's repeats
NATIVE_H2O, NATIVE_O2, NATIVE_REPS = 180000, 10000, 5
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


# phase 14: the reference's capacity envelope (monortm_tpu_torch.envelope,
# 1 profile x 200 layers x 80000 wn x 250k lines).  (a) flat rows past
# CUDA's gridDim.y limit on a one-tile plan, split in two calls for the
# reference; (d) ENV_SAMPLE_ROWS rows at each end of each engine's
# pressures, by the first and last wn tiles and the tiles holding
# ENV_O2_WN (the O2 band); (e) every ENV_LIST_STEP-th wavenumber as an
# explicit list, float32 kernels against the float64 dense engine: within
# TB64_LIMIT (the JAX package's hardware budget, tests/test_tpu_golden.py),
# a reading above TB_ATOL is reported
ROWS_BIG, NLAY_ENV = 65600, 200
# phase 15: the sampled pairs' O2 line tile holds the O2 line nearest this
# wavenumber, cm^-1 (the 60 GHz band)
ENV_O2_BAND = 2.0
ENV_SAMPLE_ROWS, ENV_O2_WN, ENV_LIST_STEP = 2, (2.0, 8.0), 2500
TB64_LIMIT = 0.05


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


def first_true(pred, n: int, shape, dev):
    """For a predicate pred(j) on index tensors j of `shape` that is
    false then true along j in [0, n): the first j where it holds, n where
    it never does (a binary search, each step one call of pred)."""
    lo = torch.zeros(shape, dtype=torch.int64, device=dev)
    hi = torch.full(shape, n, dtype=torch.int64, device=dev)
    for _ in range(max(n, 1).bit_length()):
        mid = torch.minimum((lo + hi) // 2, torch.tensor(n - 1, device=dev))
        p = pred(mid) & (lo < hi)
        hi = torch.where(p, mid, hi)
        lo = torch.where(p | (lo >= hi), lo, mid + 1)
    return hi


def lane_counts_by_interval(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                            nt, wt, n_mol, voigt, rows_per_chunk=8):
    """lane_counts' three results, counted without evaluating the pairs:
    along the grid, each mask of a (layer, line) is an interval of
    wavenumber indices (d1 and dsum are non-decreasing in the index, in
    float32 too), found by binary search on the kernels' own float32
    expressions; a line's lanes are the indices of the interval that lie
    in wavenumber tiles listing its tile, counted from each tile's
    cumulative count of listing tiles.  The wavenumber tiles must be
    ordered (they are, the grid is sorted).  Rows go in chunks of
    `rows_per_chunk`.  Equal to lane_counts (phase 4 checks it at the
    bench cell, tests/test_torch_envelope.py on the CPU)."""
    dev = pre["stild"].device
    L, n = pre["stild"].shape
    n_wt, wp = cand_map.shape[0], wn_hi.shape[0]
    k_tiles = n // nt
    listed = torch.zeros((k_tiles, n_wt), dtype=torch.int64, device=dev)
    cv = cand_valid > 0
    i_of = torch.arange(n_wt, device=dev)[:, None].expand_as(cand_map)
    listed[cand_map[cv].long(), i_of[cv]] = 1
    ctile = torch.nn.functional.pad(listed.cumsum(1), (1, 0))
    tile = torch.arange(n, device=dev) // nt

    def cum(j):
        """Listed wavenumbers of each line's tile before index j."""
        t = j // wt
        part = (j - t * wt) * listed[tile, torch.clamp(t, max=n_wt - 1)]
        return wt * ctile[tile, t] + part

    def count(a, b):
        return cum(b) - cum(torch.minimum(a, b))

    fl = {k: pre["flags"][k] > 0.5 for k in pre["flags"]}
    w = lambda c, a, b: torch.where(c, a, b)
    cls = w(fl["o2"], w(fl["cpl"], w(fl["xf1"], 0, 1), 2),
            w(fl["co2"], w(fl["cpl"] & fl["xf15"], 3, 4),
              w(fl["cpl"], 5, 6)))
    ok = fl["valid"] & (mol >= 1) & (mol <= n_mol)
    o2, o2cpl = fl["o2"], fl["o2"] & fl["cpl"]
    c01, c99 = float(np.float32(0.01)), float(np.float32(0.99))
    nh, nlo = pre["nu_hi"], pre["nu_lo"]
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    by_class = torch.zeros((len(BWD_LORENTZ_OPS), 2), dtype=torch.int64,
                           device=dev)
    sd_lanes = torch.zeros((L, n), dtype=torch.int64, device=dev)
    for r0 in range(0, L, rows_per_chunk):
        rs = slice(r0, min(r0 + rows_per_chunk, L))
        sh = pre["shift"][rs]
        shape = sh.shape
        d1 = lambda j: (wn_hi[j] - nh) + (wn_lo[j] - nlo) - sh
        dsum = lambda j: wn_hi[j] + (nh + (nlo + sh))
        search = lambda pred: first_true(pred, wp, shape, dev)
        zero = torch.zeros(shape, dtype=torch.int64, device=dev)
        end = torch.full(shape, wp, dtype=torch.int64, device=dev)
        win = (search(lambda j: d1(j) >= -25.0),
               search(lambda j: d1(j) > 25.0))
        k2_end = torch.where(o2cpl, end,
                             search(lambda j: (dsum(j) - 25.0) > 0.0))
        keep = (torch.where(o2, zero, win[0]), torch.where(o2, end, win[1]))
        both = lambda a, b: (torch.maximum(a[0], b[0]),
                             torch.minimum(a[1], b[1]))
        if voigt:
            ad100 = 100.0 * pre["ad"][rs]
            zlor = pre["hw"][rs] * c01 > pre["ad"][rs] * c99
            sd = both((search(lambda j: d1(j) >= -ad100),
                       search(lambda j: d1(j) > ad100)), keep)
            sd = (sd[0], torch.where(zlor, sd[0], sd[1]))
        else:
            sd = (zero, zero)
        cap = lambda iv: (iv[0], torch.minimum(iv[1], k2_end))
        okr = ok.expand(shape)
        # kept lanes, SD-Voigt lanes, the window's and the SD-Voigt lanes
        # in it, each without and with k2
        ivs = []
        for iv in (keep, sd, win, both(sd, win)):
            ivs += [iv, cap(iv)]
        n_keep, n_keep2, n_sd, n_sd2, n_win, n_win2, n_sdw, n_sdw2 = (
            torch.where(okr, count(*iv), 0) for iv in ivs)
        lor, lor2 = n_keep - n_keep2 - (n_sd - n_sd2), n_keep2 - n_sd2
        counts += torch.stack([lor.sum(), lor2.sum(), (n_sd - n_sd2).sum(),
                               n_sd2.sum()])
        sd_lanes[rs] = n_sd
        # uncoupled O2 outside the window: the last row of the tables
        out = (cls == 2).expand(shape)
        out2 = torch.where(out, (n_keep2 - n_win2) - (n_sd2 - n_sdw2), 0)
        out1 = torch.where(out, (n_keep - n_win) - (n_sd - n_sdw), 0) - out2
        c = cls.expand(shape)
        for k2, v in ((0, lor - out1), (1, lor2 - out2)):
            by_class[:, k2] += torch.bincount(c.reshape(-1),
                                              v.reshape(-1),
                                              minlength=len(by_class)
                                              ).to(torch.int64)
        by_class[-1, 0] += out1.sum()
        by_class[-1, 1] += out2.sum()
    counts = counts.tolist()
    check(int(by_class.sum()) == counts[0] + counts[1],
          "lane counts by class do not add up")
    return counts, sd_lanes, by_class.tolist()


def operands(model, state, engine, layers):
    """The kernel operands the forward gives `engine` for `layers` (on a
    mesh, this rank's plan and profile block), with the plan's reverse map
    last."""
    from monortm_tpu_torch.ops.linesum import precompute
    from monortm_tpu_torch.types import LayerState
    od = model.od_model
    ix = torch.as_tensor(layers, device=state.p.device)
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


def pipeline_lines():
    """The TAPE3 lines of phases 8 and 9: bench.py's 3074.

    The first N2 line is moved to the front, so that every 250-record
    panel of the TAPE3 ends on a line and not on an O2 coupling record:
    the reader skips a panel whose last record's wavenumber field (there a
    coupling coefficient, negative for some) lies below max(0, v1 - 25)
    (RDLNFL's panel skip), and this way the run keeps all 3074 lines."""
    from monortm_tpu_torch.io.tape3 import RawLines
    from monortm_tpu_torch.testing import synthetic_catalog_mw

    raw = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, raw_lines=True)
    order = np.r_[len(raw) - 2, :len(raw) - 2, len(raw) - 1]
    return RawLines(**{f: getattr(raw, f)[order]
                       for f in RawLines.__dataclass_fields__})


def phase8_pipeline(tmp: Path, kernels, reset_counts) -> dict:
    """Phase 8 (see the module docstring); returns each forward kernel's
    launches in the first timed run at the cap of 64, and the lines."""
    from monortm_tpu_torch import pipeline

    raw = pipeline_lines()
    write_rundir(tmp / "rundir", raw, PIPE_NPROF)
    write_rundir(tmp / "one", raw, 1, wn_step=CPU_WN_STEP)
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
    # 1-profile copy of the rundir listing every CPU_WN_STEP-th wavenumber
    gpu = res.results[0]
    sub = slice(None, None, CPU_WN_STEP)
    t0 = time.perf_counter()
    one = tmp / "one"
    files_one = dict(filein=one / "MONORTM.IN",
                     fileprof=one / "MONORTM_PROF.IN", hfile=one / "TAPE3")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = pipeline.run(**files_one, outdir=one / "out",
                           device="cpu").results[0]
    log(f"  CPU pipeline (1 profile, {len(ref.tb)} wavenumbers) in "
        f"{time.perf_counter() - t0:.1f} s")
    tb_err = float(np.max(np.abs(gpu.tb[sub] - ref.tb)))
    log(f"  profile 1 tb vs CPU pipeline: max_abs_err={tb_err:.3e} K")
    if tb_err > TB_ATOL:
        FAILED.append(f"profile 1 Tb differs from the CPU pipeline by "
                      f"{tb_err} K")
    compare(torch.as_tensor(gpu.otot[sub]), torch.as_tensor(ref.otot),
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


def same_tokens(a: Path, b: Path, rtol: float, atol: float) -> tuple:
    """Two MONORTM.OUT files token by token: (lines and non-numeric tokens
    equal, numeric tokens off by more than atol + rtol * |b|, the largest
    numeric difference)."""
    la, lb = a.read_text().splitlines(), b.read_text().splitlines()
    same, bad, worst = len(la) == len(lb), 0, 0.0
    for sa, sb in zip(la, lb):
        ta, tb = sa.split(), sb.split()
        same &= len(ta) == len(tb)
        for x, y in zip(ta, tb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                same &= x == y
                continue
            worst = max(worst, abs(fx - fy))
            bad += abs(fx - fy) > atol + rtol * abs(fy)
    return same, bad, worst


def dense_block(files: Path, wn_tile: int, line_tile: int) -> str:
    """The dense engine's block and tiles on phase 9's rundir."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.lines import load_catalog
    from monortm_tpu_torch.models.od import DENSE_ROWS, build_dense_tiles
    from monortm_tpu_torch.ops.lineshape import catalog_to_host

    cat = load_catalog(files["hfile"], 0.3, 55.0, tile=pipeline.LINE_TILE)
    tiles = build_dense_tiles(cat, catalog_to_host(cat, torch.float64),
                              np.linspace(0.3, 55.0, NWN), wn_tile,
                              line_tile)
    n_win = len(tiles["win"]["mol"])
    return (f"{DENSE_ROWS} layer rows x {tiles['wt']} wavenumbers x "
            f"{tiles['win']['mol'].shape[1]} windowed / "
            f"{tiles['o2']['mol'].shape[1]} O2 lines; "
            f"{len(tiles['cand'])} wavenumber tiles, {n_win} windowed and "
            f"{len(tiles['o2_idx'])} O2 line tiles, "
            f"{sum(map(len, tiles['cand']))} windowed candidates")


def phase9_float64(tmp: Path, raw, kernels, reset_counts) -> None:
    """Phase 9 (see the module docstring)."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.models.od import DENSE_LINE_TILE, DENSE_WN_TILE

    write_rundir(tmp / "rundir_f64", raw, F64_NPROF)
    write_rundir(tmp / "one_sub", raw, 1, wn_step=F64_CPU_WN_STEP)
    files = rundir_files(tmp / "rundir_f64")
    for wt, lt in ((DENSE_WN_TILE, DENSE_LINE_TILE), F64_TILES):
        log(f"  dense block at wn_tile {wt}, line_tile {lt}: "
            f"{dense_block(files, wt, lt)}")
    outs, walls, peaks = {}, {}, {}
    for name, cap in ((f"cap {F64_CAPS[0]}, run 1", F64_CAPS[0]),
                      (f"cap {F64_CAPS[0]}, run 2", F64_CAPS[0]),
                      (f"cap {F64_CAPS[1]}", F64_CAPS[1])):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res, wall, _ = drive(files, tmp / f"f64 {name}", cap=cap,
                             dtype=torch.float64)
        counts = {e: k.launches for e, k in kernels.items()}
        tb = np.stack(res.tb)
        walls[name] = wall
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  float64 {name}: {wall:.3f} s, {F64_NPROF / wall:.4f} "
            f"profiles/s, peak device memory {peaks[name]:.3f} GiB; chunks "
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

    # the dense engine at other tiles (the JAX CLI's --engine xla
    # --wn-tile --line-tile), the chunk cap left to _max_batch: against
    # the default tiles' run of the same chunk (the cap of 4)
    wt, lt = F64_TILES
    caps = []

    def recorded(*a, **k):
        """_max_batch, noting its arguments and the cap it chose."""
        caps.append((a, k, best_max_batch(*a, **k)))
        return caps[-1][2]

    best_max_batch = pipeline._max_batch
    pipeline._max_batch = recorded
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res_t, wall_t, _ = drive(files, tmp / "f64 tiles",
                                 dtype=torch.float64, engine="xla",
                                 wn_tile=wt, line_tile=lt)
    finally:
        pipeline._max_batch = best_max_batch
    peak_t = torch.cuda.max_memory_allocated() / 2**30
    counts = {e: k.launches for e, k in kernels.items()}
    args, kw, cap_t = caps[0]
    cap_0 = best_max_batch(*args, **{**kw, "wn_tile": DENSE_WN_TILE,
                                     "line_tile": DENSE_LINE_TILE})
    ref_res = outs[names[1]][1]
    tb_t, tb_0 = np.stack(res_t.tb), np.stack(ref_res.tb)
    tb_err = float(np.max(np.abs(tb_t - tb_0)))
    ot_t = np.stack([r.otot for r in res_t.results])
    ot_0 = np.stack([r.otot for r in ref_res.results])
    od_bad = np.abs(ot_t - ot_0) > F64_OD_ATOL + F64_OD_RTOL * np.abs(ot_0)
    od_rel = float(np.max(np.abs(ot_t - ot_0)
                          / np.maximum(np.abs(ot_0), 1e-300)))
    log(f"  float64 engine xla at wn_tile {wt}, line_tile {lt}: "
        f"{wall_t:.3f} s, {F64_NPROF / wall_t:.4f} profiles/s, peak device "
        f"memory {peak_t:.3f} GiB, _max_batch's cap {cap_t} (budget "
        f"{args[4] / 2**30:.3f} GiB; {cap_0} at the default tiles); chunks "
        f"{[(n, e) for n, e, _ in res_t.engines]}; line-sum kernel "
        f"launches {counts}")
    log(f"  ... against the default tiles ({DENSE_WN_TILE}, "
        f"{DENSE_LINE_TILE}; {names[1]}: {walls[names[1]]:.3f} s, "
        f"{F64_NPROF / walls[names[1]]:.4f} profiles/s, peak "
        f"{peaks[names[1]]:.3f} GiB): Tb max_abs_err={tb_err:.3e} K, total "
        f"OD max rel err {od_rel:.3e}, violations of rtol {F64_OD_RTOL} "
        f"atol {F64_OD_ATOL}: {int(od_bad.sum())}")
    if tb_t.shape != tb_0.shape or not np.isfinite(tb_t).all() \
            or tb_err > F64_TB_ATOL or od_bad.any():
        FAILED.append(f"float64 at tiles {F64_TILES} differs from the "
                      f"default tiles: Tb {tb_err} K, OD max rel {od_rel}")
    if any(counts.values()) or any(e != "dense" for _, e, _ in
                                   res_t.engines):
        FAILED.append(f"float64 at tiles {F64_TILES}: a float32 kernel "
                      f"engine ran")

    # the float32 dense engine with TF32 allowed writes the same bytes,
    # and at F64_TILES the forward's tolerance of them
    f32 = {}
    for name, kw in (("tf32 False", {}),
                     ("tf32 True", {}),
                     ("tiles", dict(engine="xla", wn_tile=wt,
                                    line_tile=lt))):
        torch.backends.cuda.matmul.allow_tf32 = name == "tf32 True"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            res, wall, _ = drive(files, tmp / f"f32 dense {name}",
                                 dtype=torch.float32,
                                 **({"engine": "dense"} | kw))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        counts = {e: k.launches for e, k in kernels.items()}
        f32[name] = tmp / f"f32 dense {name}" / "MONORTM.OUT"
        log(f"  float32 dense engine, {name}: {wall:.3f} s, "
            f"{F64_NPROF / wall:.4f} profiles/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; chunks "
            f"{[(n, e) for n, e, _ in res.engines]}; line-sum kernel "
            f"launches {counts}")
        if any(counts.values()) or any(e != "dense" for _, e, _ in
                                       res.engines):
            FAILED.append(f"float32 dense {name}: a kernel engine ran")
    same = f32["tf32 True"].read_bytes() == f32["tf32 False"].read_bytes()
    log(f"  float32 dense MONORTM.OUT with TF32 allowed vs not: "
        f"byte-identical {same}")
    if not same:
        FAILED.append("float32 dense MONORTM.OUT changes with allow_tf32")
    ok, bad, worst = same_tokens(f32["tiles"], f32["tf32 False"], RTOL_OUT,
                                 ATOL_OUT)
    log(f"  float32 dense MONORTM.OUT at tiles {F64_TILES} vs the default "
        f"tiles: layout equal {ok}, largest difference {worst:.3e}, "
        f"violations of rtol {RTOL_OUT} atol {ATOL_OUT}: {bad}")
    if not ok or bad:
        FAILED.append(f"float32 dense MONORTM.OUT at tiles {F64_TILES} "
                      f"differs from the default tiles' ({bad} tokens)")


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


def phase11_xsec(tmp: Path, kernels, reset_counts) -> None:
    """Phase 11 (see the module docstring)."""
    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.testing import make_xsec_rundir

    rundir = dict(nprof=XS_NPROF, nlay=NLAY, nwn=NWN, n_h2o=2048,
                  n_o2=1024)
    make_xsec_rundir(tmp / "xsec", **rundir)
    make_xsec_rundir(tmp / "xsec_one", keep=1, wn_step=XS_CPU_WN_STEP,
                     **rundir)
    files = rundir_files(tmp / "xsec")
    outs = []
    for rep in range(2):
        out = tmp / f"xsec_out{rep}"
        reset_counts()
        res, wall, stdout = drive(files, out)
        counts = {e: k.launches for e, k in kernels.items()}
        odx = [float(np.asarray(r.odx).max()) for r in res.results]
        log(f"  run {rep + 1}: {wall:.3f} s, {XS_NPROF / wall:.4f} "
            f"profiles/s; forward kernel launches {counts}; engine split "
            f"(profiles, engine, all-Lorentz layers) {res.engines}; "
            f"XSEC_OD max per profile {odx}")
        tb = np.stack(res.tb)
        if tb.shape != (XS_NPROF, NWN) or not np.isfinite(tb).all():
            FAILED.append(f"xsec run {rep + 1}: Tb {tb.shape}")
        if counts["full"] == 0:
            FAILED.append(f"xsec run {rep + 1}: the VOIGT=true kernel did "
                          f"not launch: {counts}")
        if min(odx) <= 0.0:
            FAILED.append(f"xsec run {rep + 1}: XSEC_OD is zero")
        text = (out / "MONORTM.OUT").read_text()
        col = [float(r.split()[-1]) for r in text.splitlines()
               if r.split() and r.split()[0].isdigit()
               and len(r.split()) > 12]
        if len(col) != XS_NPROF * NWN or min(col) <= 0.0:
            FAILED.append(f"xsec run {rep + 1}: MONORTM.OUT's XSEC_OD "
                          f"column ({len(col)} rows) has zeros")
        outs.append(text)
    report = stage_report(tmp / "xsec_out1")
    log("  " + report.replace("\n", "\n  "))
    xs_s = float(report.split("xsec-prep")[1].split()[0])
    log(f"  xsec-prep: {xs_s:.3f} s, {xs_s / XS_NPROF:.3f} s per profile "
        f"({NLAY} layers x {NWN} wavenumbers x 2 species)")
    log(f"  MONORTM.OUT byte-identical between the two runs: "
        f"{outs[0] == outs[1]}")
    if outs[0] != outs[1]:
        FAILED.append("xsec MONORTM.OUT differs between two runs")

    gpu = res.results[0]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ref = pipeline.run(**rundir_files(tmp / "xsec_one"),
                           outdir=tmp / "xsec_one" / "out",
                           device="cpu").results[0]
    sub = slice(None, None, XS_CPU_WN_STEP)
    tb_err = float(np.max(np.abs(gpu.tb[sub] - ref.tb)))
    log(f"  CPU pipeline (1 profile, {len(ref.tb)} wavenumbers) in "
        f"{time.perf_counter() - t0:.1f} s; profile 1 tb vs CPU: "
        f"max_abs_err={tb_err:.3e} K")
    if tb_err > TB_ATOL:
        FAILED.append(f"xsec profile 1 Tb differs from the CPU pipeline by "
                      f"{tb_err} K")
    compare(torch.as_tensor(gpu.otot[sub]), torch.as_tensor(ref.otot),
            "xsec profile 1 total OD vs CPU pipeline")
    compare(torch.as_tensor(np.asarray(gpu.odx)[..., sub]),
            torch.as_tensor(np.asarray(ref.odx)),
            "xsec profile 1 XSEC_OD vs CPU pipeline")


def phase12_native(tmp: Path) -> None:
    """Phase 12 (see the module docstring)."""
    import os
    from monortm_tpu_torch import lines, native
    from monortm_tpu_torch.atmos import layering
    from monortm_tpu_torch.atmos.tape5_atm import atmpth
    from monortm_tpu_torch.io.tape3 import read_tape3, write_tape3
    from monortm_tpu_torch.io.tape5 import Tape5Reader
    from monortm_tpu_torch.testing import synthetic_catalog_mw

    built = native.lib_path().exists()
    t0 = time.perf_counter()
    path = native.build()
    log(f"  {path.name} ({native.CXX} {' '.join(native.CXX_FLAGS)}): "
        + ("built at its first use in this run (phase 8's IATM=1 layering)"
           if built else f"built in {time.perf_counter() - t0:.2f} s"))

    def python_walk(on: bool):
        if on:
            os.environ[native.SWITCH] = "0"
        else:
            os.environ.pop(native.SWITCH, None)

    (tmp / "iatm1_native").mkdir(exist_ok=True)
    (tmp / "iatm1_native" / "MONORTM.IN").write_text(IATM1_TAPE5)
    blk = Tape5Reader(tmp / "iatm1_native" / "MONORTM.IN").read_block()
    merges = []
    real = layering.PathEngine.amerge

    def amerge(self, *a):
        merges.append(real(self, *a))
        return merges[-1]

    layering.PathEngine.amerge = amerge
    side = {}
    try:
        for py in (False, True):
            python_walk(py)
            merges.clear()
            secs = []
            for _ in range(NATIVE_REPS):
                t0 = time.perf_counter()
                prof = atmpth(blk.rest, blk.v1, blk.v2)
                secs.append(time.perf_counter() - t0)
            per_profile = len(merges) // NATIVE_REPS
            side[py] = (prof, merges[-per_profile:], statistics.median(secs))
    finally:
        layering.PathEngine.amerge = real
        python_walk(False)
    (nat, nat_m, nat_s), (pyt, py_m, py_s) = side[False], side[True]
    same_merge = len(nat_m) == len(py_m) > 0 and all(
        all(np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(a, b)) for a, b in zip(nat_m, py_m))
    worst = max(float(np.max(np.abs(getattr(nat.state, f)
                                    - getattr(pyt.state, f))
                             / np.maximum(np.abs(getattr(pyt.state, f)),
                                          1e-300)))
                for f in FIELDS)
    log(f"  IATM=1 layering ({len(nat.state.p)} layers, {len(nat_m)} AMERGE "
        f"calls per profile): native {nat_s:.4f} s, Python walk "
        f"{py_s:.4f} s per profile (median of {NATIVE_REPS}); AMERGE "
        f"outputs bitwise equal {same_merge}; layered state max relative "
        f"difference {worst:.3e}")
    if not same_merge:
        FAILED.append("IATM=1 AMERGE outputs differ between native and "
                      "Python walk")
    if not all(np.allclose(getattr(nat.state, f), getattr(pyt.state, f),
                           rtol=1e-12, atol=0) for f in FIELDS):
        FAILED.append(f"IATM=1 layered state differs beyond rtol 1e-12: "
                      f"{worst}")

    big = synthetic_catalog_mw(n_h2o=NATIVE_H2O, n_o2=NATIVE_O2,
                               raw_lines=True)
    write_tape3(tmp / "TAPE3_big", big)
    for name, tape3, v1, v2 in (
            ("phase 8's TAPE3", tmp / "rundir" / "TAPE3", 0.3, 55.0),
            (f"synthetic TAPE3 of {len(big)} records", tmp / "TAPE3_big",
             0.3, 55.0)):
        raw = read_tape3(tape3, v1, v2)
        res = {}
        for py in (False, True):
            python_walk(py)
            try:
                t0 = time.perf_counter()
                cat = lines.load_catalog(tape3, v1, v2, tile=256)
                res[py] = (cat, time.perf_counter() - t0)
            finally:
                python_walk(False)
        resolved = (native.group_resolve_lines(raw),
                    lines.resolve(lines.group(raw)))
        bad = [f for f in lines.ResolvedLines.__dataclass_fields__
               if not np.array_equal(getattr(resolved[0], f),
                                     getattr(resolved[1], f))]
        bad += [f"packed {f}" for f in lines.PackedCatalog.__dataclass_fields__
                if not np.array_equal(getattr(res[False][0], f),
                                      getattr(res[True][0], f))]
        log(f"  load_catalog on {name} ({len(raw)} records read, "
            f"{res[False][0].n_lines} lines): native {res[False][1]:.3f} s, "
            f"Python walk {res[True][1]:.3f} s; fields that differ: {bad}")
        if bad:
            FAILED.append(f"load_catalog on {name}: native and Python "
                          f"differ in {bad}")


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


# phase 13: the meshes of CLI runs on phase 8's rundir (ranks), the line
# axis, float64 on phase 9's cut, and the gradient on bench.py's workload
MESH_CLI = (("2x1", 2), ("1x2", 2), ("2x2", 4))
MESH_GRAD = (("1x2", 2), ("2x1", 2))
GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-6   # vs the single-device gradient
MESH_TIMEOUT = 300


def spawn_cli(files, outdir: Path, n: int, mesh: str, *extra):
    """`python -m monortm_tpu_torch.cli --distributed` as n gloo ranks on
    the one card (cuda:0); returns (wall s, [(exit code, output)])."""
    from monortm_tpu_torch.parallel.distributed import spawn
    argv = ["-m", "monortm_tpu_torch.cli", "--in", str(files["filein"]),
            "--prof", str(files["fileprof"]), "--tape3", str(files["hfile"]),
            "--outdir", str(outdir), "--distributed", "--backend", "gloo",
            "--device", "cuda:0", "--mesh", mesh, *extra]
    t0 = time.perf_counter()
    outs = spawn(argv, n, cwd=Path(__file__).resolve().parent,
                 timeout=MESH_TIMEOUT)
    return time.perf_counter() - t0, outs


def rank_lines(what, outs) -> list:
    """Each rank's backend / device line and forward launches, printed;
    a rank that failed fails the phase.  Returns the launches."""
    launches = []
    for r, (rc, text) in enumerate(outs):
        info = [ln.split(": ", 1)[1] for ln in text.splitlines()
                if ln.startswith(f"monortm-tpu-torch: rank {r}")]
        log(f"  {what} rank {r}: exit {rc}; " + "; ".join(info))
        if rc != 0:
            FAILED.append(f"{what}: rank {r} exited {rc}")
            log("  " + text[-3000:].replace("\n", "\n  "))
            launches.append(None)
            continue
        tail = [ln for ln in info if "launches" in ln]
        launches.append(json.loads(tail[-1].split("launches ", 1)[1])
                        if tail else None)
    return launches


def engine_lines(outdir: Path) -> list:
    return [ln for ln in (outdir / "MONORTM.LOG").read_text().splitlines()
            if ln.startswith(" ENGINE SPLIT")]


def mesh_rank(d: Path, mesh_arg: str) -> int:
    """A rank of phase 13's gradient check (`--mesh-rank DIR MESH`, under
    `parallel.distributed.spawn`): shard_forward_and_grad at bench.py's
    workload on the card, its gradients gathered against the single-device
    ones in DIR/inputs.pt, and each forward and adjoint kernel against its
    plain version on this rank's plan; writes DIR/MESH-rankR.json."""
    import torch.distributed as dist
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL
    from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
    from monortm_tpu_torch.parallel import distributed
    from monortm_tpu_torch.parallel.sharding import (make_mesh, shard_batch,
                                                     shard_forward_and_grad,
                                                     shard_state)
    from monortm_tpu_torch.testing import synthetic_catalog_mw
    from monortm_tpu_torch.types import LayerState

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init_distributed("gloo")
    dims = [int(v) for v in mesh_arg.split("x")]
    mesh = make_mesh(n_prof=dims[0], n_wn=dims[1])
    inp = torch.load(d / "inputs.pt")
    wn = np.linspace(0.3, 55.0, NWN)
    model = MonoRTM(wn, float(wn[1] - wn[0]),
                    synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512),
                    nmol=22, device=dev, mesh=mesh)
    od = model.od_model
    state = LayerState(**{f: inp["state"][f].to(dev) for f in FIELDS})
    st = shard_state(state, mesh)
    emis = inp["emis"].to(dev)
    split = model.engine_split(st)
    kernels = {"full": VOIGT_KERNEL, "lorentz": LORENTZ_KERNEL}
    for k in kernels.values():
        k.launches = k.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = shard_forward_and_grad(model, mesh, 3, *split)(
        st, shard_batch(inp["tsfc"].to(dev), mesh), emis, 1.0 - emis,
        shard_batch(inp["tb_obs"].to(dev), mesh))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
           "backend": dist.get_backend(), "split": [split[0],
                                                    list(split[1])],
           "value_and_grad_s": wall,
           "launches": {k.name: [k.launches, k.bwd_launches]
                        for k in kernels.values()},
           "loss": float(loss), "loss_single": float(inp["loss"])}
    if abs(float(loss) - float(inp["loss"])) > GRAD_RTOL * abs(
            float(inp["loss"])):
        FAILED.append(f"loss {float(loss)} vs {float(inp['loss'])}")
    for f in FIELDS:
        g = distributed.gather(getattr(grads, f), mesh).cpu()
        out[f"grad_{f}"] = compare(g, inp["grads"][f], f"rank {mesh.rank} "
                                   f"d loss / d {f} vs single device",
                                   GRAD_ATOL_REL, GRAD_RTOL)
    # each kernel against its plain version on this rank's plan, at the
    # layers the main path gave it, with a seeded cotangent
    lor = list(split[1])
    layers = {"full": [i for i in range(NLAY) if i not in set(lor)],
              "lorentz": lor}
    gen = torch.Generator().manual_seed(mesh.rank)
    for eng, k in kernels.items():
        if not layers[eng]:
            continue
        args = operands(model, st, eng, layers[eng])
        pre, mol, wh, wl, cm, cv, nt, wt, n_mol, rev = args
        what = f"rank {mesh.rank} {k.name}"
        out[f"fwd_{k.name}"] = compare(k(*args[:9]), k.plain(*args[:9]),
                                       f"{what} forward vs plain")
        g = torch.randn((pre["stild"].shape[0], wh.shape[0], n_mol),
                        generator=gen).to(dev)
        got = k.launch_bwd(pre, mol, wh, wl, *rev, nt, wt, n_mol, g)
        ref = k.plain_bwd(pre, mol, wh, wl, cm, cv, nt, wt, n_mol, g)
        out[f"bwd_{k.name}"] = max(
            (compare(a, b, f"{what} adjoint d{n} vs plain", BWD_ATOL)
             for n, a, b in zip(PER_LN, got, ref) if b is not None),
            key=lambda e: e[1])
        out[f"plan_{k.name}"] = [list(cm.shape), list(rev[0].shape)]
    out["failed"] = list(FAILED)
    (d / f"{mesh_arg}-rank{mesh.rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 1 if FAILED else 0


def phase13_mesh(tmp: Path, grad_inputs: dict) -> dict:
    """Phase 13 (see the module docstring); returns each kernel's launches
    per rank, by mesh."""
    from scipy.io import netcdf_file

    from monortm_tpu_torch import pipeline
    from monortm_tpu_torch.parallel.distributed import spawn
    files = rundir_files(tmp / "rundir")
    single = tmp / f"cap{PIPE_CAPS[0]}_0"
    launches = {}
    for mesh, n in MESH_CLI:
        out = tmp / f"mesh {mesh}"
        wall, outs = spawn_cli(files, out, n, mesh)
        launches[mesh] = rank_lines(f"mesh {mesh}", outs)
        if not (out / "MONORTM.OUT").exists():
            continue
        same_split = engine_lines(out) == engine_lines(single)
        same = (out / "MONORTM.OUT").read_bytes() == \
            (single / "MONORTM.OUT").read_bytes()
        log(f"  mesh {mesh} ({n} ranks): {wall:.3f} s; engine split "
            f"{engine_lines(out)}; the same split as phase 8 cap "
            f"{PIPE_CAPS[0]}: {same_split}; MONORTM.OUT byte-identical to "
            f"it: {same}")
        if not all(lc and all(lc.values()) for lc in launches[mesh]):
            FAILED.append(f"mesh {mesh}: a rank did not launch both forward "
                          f"kernels: {launches[mesh]}")
        if same_split and not same:
            FAILED.append(f"mesh {mesh}: MONORTM.OUT differs from the "
                          "single-device run under the same engine split")

    # the line axis: float32 partial sums over two line ranks, held at the
    # forward's tolerance against a single-device NetCDF run, and to the
    # same bytes from run to run
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.run(**files, outdir=tmp / "single nc", device="cuda",
                     netcdf=True)
    log(f"  single-device NetCDF run: {time.perf_counter() - t0:.3f} s")
    runs = []
    for rep in range(2):
        out = tmp / f"mesh 1x1x2 {rep}"
        wall, outs = spawn_cli(files, out, 2, "1x1x2", "--netcdf")
        lc = rank_lines(f"mesh 1x1x2 run {rep + 1}", outs)
        launches[f"1x1x2 run {rep + 1}"] = lc
        log(f"  mesh 1x1x2 run {rep + 1}: {wall:.3f} s")
        if not all(c and all(c.values()) for c in lc):
            FAILED.append(f"mesh 1x1x2: a rank did not launch both forward "
                          f"kernels: {lc}")
        runs.append(out)
    if all((r / "MONORTM.OUT").exists() for r in runs):
        same = (runs[0] / "MONORTM.OUT").read_bytes() == \
            (runs[1] / "MONORTM.OUT").read_bytes()
        log(f"  mesh 1x1x2: MONORTM.OUT byte-identical between runs: {same}")
        if not same:
            FAILED.append("mesh 1x1x2: MONORTM.OUT differs between runs")

        def nc_stack(d):
            """Every profile's BT [P, W] and layer OD [P, W, L]."""
            tb, od = [], []
            for i in range(1, PIPE_NPROF + 1):
                with netcdf_file(str(d / f"MONORTM.{i:05d}.nc"),
                                 mmap=False) as nc:
                    tb.append(np.array(nc.variables["BT"][:]))
                    od.append(np.array(
                        nc.variables["LAYER_OPTICAL_DEPTH"][:]))
            return torch.as_tensor(np.stack(tb)), torch.as_tensor(
                np.stack(od))

        (tb_m, od_m), (tb_s, od_s) = nc_stack(runs[0]), nc_stack(
            tmp / "single nc")
        tb_err = float((tb_m - tb_s).abs().max())
        log(f"  mesh 1x1x2 Tb vs single device: max_abs_err={tb_err:.3e} K")
        if tb_err > TB_ATOL:
            FAILED.append(f"mesh 1x1x2: Tb {tb_err} K from the single run")
        compare(od_m, od_s, "mesh 1x1x2 layer OD vs single device")

    # float64 on phase 9's cut: the dense engine's tiles split over wn
    out = tmp / "mesh 1x2 f64"
    wall, outs = spawn_cli(rundir_files(tmp / "rundir_f64"), out, 2, "1x2",
                           "--precision", "float64")
    launches["1x2 float64"] = rank_lines("mesh 1x2 float64", outs)
    if (out / "MONORTM.OUT").exists():
        phase9 = tmp / f"f64 cap {F64_CAPS[0]}, run 1" / "MONORTM.OUT"
        same = (out / "MONORTM.OUT").read_bytes() == phase9.read_bytes()
        log(f"  mesh 1x2 float64 ({F64_NPROF} profiles): {wall:.3f} s; "
            f"MONORTM.OUT byte-identical to phase 9's: {same}")
        if not same:
            FAILED.append("mesh 1x2 float64: MONORTM.OUT differs from "
                          "phase 9's")

    # shard_forward_and_grad at bench.py's workload
    gd = tmp / "grad"
    gd.mkdir()
    torch.save(grad_inputs, gd / "inputs.pt")
    for mesh, n in MESH_GRAD:
        t0 = time.perf_counter()
        outs = spawn([str(Path(__file__).resolve()), "--mesh-rank", str(gd),
                      mesh], n, timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        launches[f"{mesh} value_and_grad"] = []
        for r, (rc, text) in enumerate(outs):
            js = gd / f"{mesh}-rank{r}.json"
            if rc != 0 or not js.exists():
                FAILED.append(f"grad mesh {mesh}: rank {r} exited {rc}")
                log("  " + text[-4000:].replace("\n", "\n  "))
                continue
            res = json.loads(js.read_text())
            launches[f"{mesh} value_and_grad"].append(res["launches"])
            FAILED.extend(f"grad mesh {mesh} rank {r}: {f}"
                          for f in res["failed"])
            log(f"  grad mesh {mesh} rank {r} {res['coords']} on "
                f"{res['device']} ({res['backend']}): value_and_grad "
                f"{res['value_and_grad_s']:.3f} s, split {res['split'][0]} "
                f"({len(res['split'][1])} all-Lorentz layers), (forward, "
                f"adjoint) launches {res['launches']}; loss {res['loss']:.6e}"
                f" (single {res['loss_single']:.6e}); worst grad err/max "
                f"{max(res[f'grad_{f}'][1] for f in FIELDS):.2e}; kernel vs "
                f"plain on the rank's plan (cand map, reverse map shapes "
                + ", ".join(f"{k}: {res.get('plan_' + k)} fwd "
                            f"{res.get('fwd_' + k)} bwd {res.get('bwd_' + k)}"
                            for k in ("voigt", "lorentz")) + ")")
            if not all(a > 0 and b > 0 for a, b in res["launches"].values()):
                FAILED.append(f"grad mesh {mesh} rank {r}: a kernel did not "
                              f"launch: {res['launches']}")
        log(f"  grad mesh {mesh} ({n} ranks): {wall:.3f} s")
    return launches



def timed_call(fn):
    """(fn(), its device time in ms by CUDA events, synchronised)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def rows_of(pre, rows):
    """The operands of `pre` for the flat layer rows `rows` (a slice):
    the per-(layer, line) ones sliced, the per-line ones as they are."""
    return {k: (v[rows] if k in PER_LN else v) for k, v in pre.items()}


def phase14_rows(dev, kernels) -> dict:
    """Phase 14 (a): each forward and adjoint instantiation on ROWS_BIG
    flat rows of a one-tile plan (128 wavenumbers across the centre of
    an H2O line of the small catalog, pressures spread from 1013 to 0.02
    hPa, so that the Voigt adjoint defers SD-Voigt lanes), bitwise
    against the same rows in two calls; the rows past the limit against
    the plain forward.  Returns the CUDA calls of each wrapper call."""
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.ops.linesum_kernel import MAX_GRID_ROWS
    from monortm_tpu_torch.testing import (synthetic_catalog_mw,
                                           synthetic_state)
    from monortm_tpu_torch.types import LayerState

    cat = synthetic_catalog_mw(n_h2o=48, n_o2=16, tile=128)
    h2o = np.nonzero(np.asarray(cat.valid) & (np.asarray(cat.mol) == 1))[0]
    nu = float(np.asarray(cat.nu0)[h2o[len(h2o) // 2]])
    wn = nu + np.linspace(-5e-3, 5e-3, 128)
    small = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
    nlay = 4
    st = synthetic_state(nlay=nlay, batch=ROWS_BIG // nlay, device=dev,
                         dtype=torch.float32)
    p = torch.logspace(np.log10(1013.0), np.log10(0.02), ROWS_BIG,
                       device=dev).reshape(st.p.shape)
    st = LayerState(p=p, t=st.t, tz=st.tz, wkl=st.wkl, wbrodl=st.wbrodl,
                    clw=st.clw)
    gen = torch.Generator(device=dev).manual_seed(14)
    halves = (slice(0, ROWS_BIG // 2), slice(ROWS_BIG // 2, ROWS_BIG))
    calls = {}
    for eng, k in kernels.items():
        pre, mol, wh, wl, cm, cv, nt, wt, n_mol, rev = operands(
            small, st, eng, list(range(nlay)))
        L = pre["stild"].shape[0]
        check(L == ROWS_BIG and L > MAX_GRID_ROWS and cm.shape[0] == 1,
              f"(a) needs one wn tile and > {MAX_GRID_ROWS} rows: {L}, "
              f"{tuple(cm.shape)}")
        plan = (mol, wh, wl, cm, cv, nt, wt, n_mol)
        n0 = k.launches
        whole = k.launch(pre, *plan)
        torch.cuda.synchronize()
        calls[eng] = [k.launches - n0]
        two = torch.cat([k.launch(rows_of(pre, h), *plan) for h in halves])
        same = torch.equal(whole, two)
        log(f"  (a) {eng} forward on {L} rows: {calls[eng][0]} CUDA calls; "
            f"bitwise equal to two calls of {L // 2}: {same}")
        if not same:
            FAILED.append(f"(a) {eng} forward: {L} rows differ from two "
                          f"calls")
        tail = slice(MAX_GRID_ROWS - 64, L)
        compare(whole[tail], k.plain(rows_of(pre, tail), *plan),
                f"(a) {eng} forward rows {tail.start}-{L - 1} vs plain")
        del whole, two
        g = torch.randn((L, wh.shape[0], n_mol), generator=gen, device=dev)
        n0 = k.bwd_launches
        got = k.launch_bwd(pre, mol, wh, wl, *rev, nt, wt, n_mol, g)
        got += (k.deferred,)
        torch.cuda.synchronize()
        calls[eng].append(k.bwd_launches - n0)
        parts = []
        for h in halves:
            parts.append(k.launch_bwd(rows_of(pre, h), mol, wh, wl, *rev,
                                      nt, wt, n_mol, g[h])
                         + (k.deferred,))
        names = PER_LN + ("deferred",)
        diff = [n for i, n in enumerate(names) if got[i] is not None
                and not torch.equal(got[i],
                                    torch.cat([pt[i] for pt in parts]))]
        n_def = int((got[-1] != 0).sum()) if k.voigt else 0
        log(f"  (a) {eng} adjoint on {L} rows: {calls[eng][1]} CUDA calls; "
            f"bitwise equal to two calls: {not diff}"
            + (f"; {n_def} deferred (layer, line) pairs" if k.voigt else ""))
        if diff:
            FAILED.append(f"(a) {eng} adjoint: {diff} differ from two calls")
        if k.voigt and not n_def:
            FAILED.append("(a) the Voigt adjoint deferred no lane")
        if calls[eng] != [2, 2]:
            FAILED.append(f"(a) {eng}: {calls[eng]} CUDA calls for {L} "
                          f"rows, expected 2 each")
    return calls


def phase14_capacity(dev, kernels) -> None:
    """Phase 14 (b): the JAX package's capacity check
    (tests/test_pallas.py::test_pallas_capacity_250k_lines_8k_wn) on the
    card: 250k H2O lines over 0.5-3000 cm^-1, 8192 wn over 0.3-55
    cm^-1, synthetic_state(nlay=40), the VOIGT=true kernel."""
    from monortm_tpu_torch.models.od import ODModel
    from monortm_tpu_torch.testing import capacity_catalog, synthetic_state

    t0 = time.perf_counter()
    cat = capacity_catalog()
    wn = np.linspace(0.3, 55.0, 8192)
    od = ODModel(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
    n_tiles = len(od.plan["cat"]["mol"]) // od.plan["nt"]
    n_cand = od.plan["cand_map"].shape[1]
    log(f"  (b) capacity: {int(np.sum(cat.valid))} lines in {n_tiles} tiles "
        f"of {od.plan['nt']}, {n_cand} candidate columns for "
        f"{od.plan['cand_map'].shape[0]} wn tiles (limit {n_tiles / 5:.1f});"
        f" catalog and model {time.perf_counter() - t0:.1f} s")
    if not n_cand < n_tiles / 5:
        FAILED.append(f"(b) {n_cand} candidate columns, not < {n_tiles} / 5")
    st = synthetic_state(nlay=40, device=dev, dtype=torch.float32)
    scor = od.tips.scor(st.t)
    n0 = kernels["full"].launches
    with torch.no_grad():
        sf, ms = timed_call(lambda: od.line_od(
            st, scor.reshape(40, 39 * 9), engine="full"))
    finite = bool(torch.isfinite(sf).all())
    log(f"  (b) VOIGT=true line OD {tuple(sf.shape)} in {ms:.3f} ms, "
        f"{kernels['full'].launches - n0} launch, finite: {finite}, "
        f"max {float(sf.abs().max()):.4e}")
    if not finite or kernels["full"].launches == n0:
        FAILED.append("(b) the capacity check's OD is not finite or the "
                      "kernel did not launch")


def phase14_envelope(tmp: Path, kernels, reset_counts):
    """Phase 14 (c)-(e) (see the module docstring): the envelope through
    `monortm_tpu_torch.envelope.run_envelope`, each forward kernel timed
    in it by CUDA events around its launches; the kernels against their
    plain versions on sampled blocks of its plan, with their times and
    bounds there; the 32-wavenumber list at float32 and float64.  Returns
    each forward kernel's readings, and the envelope's rebuilt model, its
    state and its files for phase 15."""
    from monortm_tpu_torch import envelope, pipeline
    from monortm_tpu_torch.ops.linesum import _contrib_voigt, sweep_plain
    from monortm_tpu_torch.ops.linesum_lorentz import _contrib_lorentz

    d = tmp / "envelope"
    reset_counts()
    with envelope.kernel_events(kernels) as events:
        env = envelope.run_envelope(d, device="cuda", echo=log)
    launches = {e: k.launches for e, k in kernels.items()}
    ms = {e: v for (e, kind), v in envelope.event_ms(events).items()
          if kind == "fwd"}
    res = env["result"]
    (n, split, lor), = res.engines
    log(f"  (c) envelope: engine split {split}, {len(lor)} of {NLAY_ENV} "
        f"rows all-Lorentz; forward launches {launches}; kernel time by "
        f"CUDA events around the wrapper's calls {ms} ms")
    if not env["tb_finite"]:
        FAILED.append("(c) the envelope's Tb is not all finite")
    if not all(launches.values()):
        FAILED.append(f"(c) a forward kernel did not launch: {launches}")
    # at <= MAX_GRID_ROWS rows a wrapper call is one CUDA call, so every
    # counted launch lies inside a timed pair of events
    timed_calls = {e: len(v) for (e, kind), v in events.items()
                   if kind == "fwd"}
    if timed_calls != launches:
        FAILED.append(f"(c) timed wrapper calls {timed_calls} are not the "
                      f"launches {launches}")

    # (d) the envelope's model, built from its files as pipeline.run
    # builds it
    files = dict(filein=d / "MONORTM.IN", fileprof=d / "MONORTM_PROF.IN",
                 hfile=d / "TAPE3")
    model, state, cfg = envelope.build_model(files, "cuda")
    nmol = model.od_model.nmol
    wn = res.wn
    same = (np.array_equal(cfg.wn, wn) and sorted(
        model.engine_split(state)[1]) == sorted(lor))
    if not same:
        FAILED.append("(d) the rebuilt model's grid or engine split is not "
                      "the envelope run's")
    n_lines = len(model.od_model.plan["cat"]["mol"])
    est = pipeline._profile_bytes(len(wn), NLAY_ENV, nmol, n_lines)
    log(f"  (c) _max_batch's estimate per profile {est / 2**30:.3f} GiB "
        f"against the measured peak {env['peak_bytes'] / 2**30:.3f} GiB: "
        f"{est / env['peak_bytes']:.2f}x")

    # (d) the kernels against their plain versions on sampled blocks
    lor = list(lor)
    voigt = [i for i in range(NLAY_ENV) if i not in set(lor)]
    o2_tiles = [int(np.searchsorted(wn, w)) // 128 for w in ENV_O2_WN]
    tiles = [0, *o2_tiles, -(-len(wn) // 128) - 1]
    out = {}
    for eng, layers in (("full", voigt), ("lorentz", lor)):
        k = kernels[eng]
        rows = sorted(set(layers[:ENV_SAMPLE_ROWS]
                          + layers[-ENV_SAMPLE_ROWS:]))
        args = operands(model, state, eng, rows)
        pre, mol, wh, wl, cm, cv, nt, wt, n_mol, _ = args
        cols = torch.cat([torch.arange(i * wt, (i + 1) * wt) for i in tiles]
                         ).to(wh.device)
        ix = torch.as_tensor(tiles, device=cm.device)
        sub = (pre, mol, wh[cols].contiguous(), wl[cols].contiguous(),
               cm[ix].contiguous(), cv[ix].contiguous(), nt, wt, n_mol)
        got = k(*sub)
        ref, plain_ms = timed_call(lambda: k.plain(*sub))
        err, rel = compare(got, ref, f"(d) {eng} rows {rows} (p "
                           f"{float(state.p[rows[0]]):.4g}-"
                           f"{float(state.p[rows[-1]]):.4g} hPa) x wn tiles "
                           f"{tiles}")
        # both against the plain sum in float64 (float32's branches)
        d64 = lambda v: v.double() if torch.is_tensor(v) else v
        pre64 = {n: d64(v) for n, v in pre.items()}
        contrib = (functools.partial(_contrib_voigt, f32_fallback=True)
                   if k.voigt else _contrib_lorentz)
        ref64 = sweep_plain(contrib, pre64, mol, *map(d64, sub[2:4]),
                            *sub[4:9])
        scale = float(ref64.abs().max())
        e64 = {name: float((v.double() - ref64).abs().max()) / scale
               for name, v in (("kernel", got), ("plain float32", ref))}
        log(f"  (d) {eng} against the plain sum in float64, err/max: "
            + ", ".join(f"{n} {e:.3e}" for n, e in e64.items()))
        sub_ms = cuda_ms(lambda: k(*sub), 5)
        t0 = time.perf_counter()
        counts, _, by_class = lane_counts(*sub, voigt=k.voigt)
        t_count = time.perf_counter() - t0
        b_ms, b_by = bound_by_class("fwd", k.voigt, counts, by_class,
                                    line_bytes(sub, "fwd", k.voigt))
        n_blocks = int(cv.sum())
        log(f"  (d) {eng} on the sample ({len(rows)} rows x "
            f"{int(cv[ix].sum())} of the plan's {n_blocks} candidate "
            f"blocks): {sub_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; lanes lor/lor+k2/sd/sd+k2 {counts}); "
            f"lane_counts took {t_count:.2f} s here, ~"
            f"{t_count * n_blocks / int(cv[ix].sum()):.0f} s for the whole "
            f"plan (phase 15 counts the envelope's bound by interval)")
        out[eng] = {"envelope_launches": launches[eng],
                    "envelope_ms": ms[eng],
                    "envelope_sample": {
                        "rows": rows, "wn_tiles": tiles, "ms": sub_ms,
                        "plain_ms": plain_ms, "sample_bound_ms": b_ms,
                        "sample_bound_by": b_by, "max_abs_err": err,
                        "max_rel_err": rel,
                        "kernel_vs_float64": e64["kernel"],
                        "plain_vs_float64": e64["plain float32"]}}

    # (e) every ENV_LIST_STEP-th wavenumber, float32 against float64
    ld = tmp / "envelope_list"
    ld.mkdir()
    (ld / "MONORTM.IN").write_text(envelope.tape5_text(
        wn_list=wn[::ENV_LIST_STEP]))
    list_files = dict(filein=ld / "MONORTM.IN",
                      fileprof=d / "MONORTM_PROF.IN", hfile=d / "TAPE3")
    tb = {}
    for name, dtype in (("float32", torch.float32),
                        ("float64", torch.float64)):
        r, wall, _ = drive(list_files, ld / name, dtype=dtype)
        tb[name] = r.tb[0]
        log(f"  (e) {len(r.wn)} listed wn at {name}: {wall:.3f} s, engine "
            f"split {[(n, e, len(lo)) for n, e, lo in r.engines]}")
    err64 = float(np.abs(tb["float32"].astype(np.float64)
                         - tb["float64"]).max())
    err_env = float(np.abs(res.tb[0][::ENV_LIST_STEP].astype(np.float64)
                           - tb["float32"]).max())
    log(f"  (e) Tb float32 kernels vs float64 dense: max_abs_err="
        f"{err64:.4e} K (limit {TB64_LIMIT} K"
        + (f"; above {TB_ATOL} K: float32 accumulation over the envelope's "
           f"lines per wavenumber" if err64 > TB_ATOL else "") + ")")
    log(f"  (e) the envelope run's Tb at those wavenumbers vs the list's "
        f"float32 Tb: max_abs_err={err_env:.4e} K")
    if not err64 <= TB64_LIMIT:
        FAILED.append(f"(e) Tb {err64} K from float64, over {TB64_LIMIT}")
    if not err_env <= TB_ATOL:
        FAILED.append(f"(e) the envelope run's Tb is {err_env} K from the "
                      f"list run's, over {TB_ATOL}")
    for e in out:
        out[e]["tb_vs_float64_K"] = err64
    return out, (model, state, files)


def phase14(tmp: Path, dev, kernels, reset_counts):
    """Phase 14 (see the module docstring): (a) row blocks, (b) the
    capacity check, (c)-(e) the envelope; returns the readings for the
    kernels line, by kernel name, and the envelope's rebuilt model, state
    and files."""
    out = {}
    calls = phase14_rows(dev, kernels)
    phase14_capacity(dev, kernels)
    env, built = phase14_envelope(tmp, kernels, reset_counts)
    for eng, k in kernels.items():
        out[f"linesum_{k.name}"] = {**env[eng],
                                    "row_block_calls": calls[eng][0]}
        out[f"linesum_bwd_{k.name}"] = {"row_block_calls": calls[eng][1]}
    return out, built


def sample_tiles(plan, wn) -> list:
    """Phase 15's line tiles of a plan: the one holding the valid line
    nearest the band's middle among the lines of no O2, and the one
    holding the valid O2 line nearest ENV_O2_BAND."""
    cat, nt = plan["cat"], plan["nt"]
    nu = (cat["nu0_hi"].double() + cat["nu0_lo"].double()).cpu().numpy()
    mol = cat["mol"].cpu().numpy()
    valid = cat["valid"].cpu().numpy().astype(bool)
    tiles = []
    for sel, at in ((valid & (mol != 7), 0.5 * (wn[0] + wn[-1])),
                    (valid & (mol == 7), ENV_O2_BAND)):
        idx = np.nonzero(sel)[0]
        tiles.append(int(idx[np.argmin(np.abs(nu[idx] - at))]) // nt)
    return sorted(set(tiles))


def sub_cand_map(rev_map, rev_valid, n_wt: int):
    """The candidate map of a sub-plan whose line tiles are the rows of
    `rev_map` (numbered 0, 1, ...): each wavenumber tile lists those of
    them whose reverse row holds it (int32 device tensors)."""
    rm, rv = rev_map.cpu().numpy(), rev_valid.cpu().numpy()
    cm = np.zeros((n_wt, rm.shape[0]), np.int32)
    cv = np.zeros_like(cm)
    for j in range(rm.shape[0]):
        for i in rm[j][rv[j] > 0]:
            slot = int(cv[i].sum())
            cm[i, slot], cv[i, slot] = j, 1
    return (torch.as_tensor(cm, device=rev_map.device),
            torch.as_tensor(cv, device=rev_map.device))


def adjoint_kernel_ms(k, args, g) -> dict:
    """Device ms of each kernel one adjoint call starts, by
    torch.profiler, and of the call by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pre, mol, wh, wl, cm, cv, nt, wt, n_mol, rev = args
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = timed_call(lambda: k.launch_bwd(pre, mol, wh, wl, *rev, nt,
                                                wt, n_mol, g))
    out = {"call": ms}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in ("linesum_bwd_sweep", "linesum_bwd_deferred"):
            if name in e.name:
                out[name] = (out.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    return out


def deferral_slots(words, rev_valid, nt: int) -> tuple:
    """(slots the deferred pass visits, slots a 32-bit mask with one bit
    per slot below 31 and one shared by the rest would have it visit)
    over the deferral words [L, N]: the first from the words' spans; the
    second their slots below 31 and every valid slot from 31 to the row's
    end where a span reaches past 30."""
    from monortm_tpu_torch.ops.linesum_kernel import deferral_span
    first, last = deferral_span(words)
    on = words != 0
    row_len = rev_valid.sum(1).to(torch.int64)[
        torch.arange(words.shape[1], device=words.device) // nt]
    span = torch.where(on, last - first + 1, 0)
    low = torch.where(on, torch.clamp(torch.clamp(last, max=30) - first + 1,
                                      min=0), 0)
    high = torch.where(on & (last > 30), row_len - 31, 0)
    return int(span.sum()), int((low + high).sum())


def phase15(kernels, reset_counts, built) -> dict:
    """Phase 15 (see the module docstring): the retrieval adjoint at the
    envelope on phase 14's rebuilt model and state.  Returns the readings
    for the kernels line, by kernel name."""
    from monortm_tpu_torch import envelope, pipeline
    from monortm_tpu_torch.ops.linesum import line_sum_bwd_plain
    from monortm_tpu_torch.ops.linesum_kernel import PER_L
    from monortm_tpu_torch.ops.linesum_lorentz import lorentz_sum_bwd_plain
    from monortm_tpu_torch.types import LayerState

    model, state, _ = built
    od = model.od_model
    wn = model.wn
    engine, lor = model.engine_split(state)
    layers = {"full": [i for i in range(NLAY_ENV) if i not in set(lor)],
              "lorentz": list(lor)}
    tiles = {e: sample_tiles(od.dev_plans[e], wn) for e in kernels}
    captured = {}

    def on_bwd(e, args, out):
        """The sampled pairs' operands, cotangent g and results of the
        full launch: its first and last row by the sample tiles' lines."""
        pre, mol, wh, wl, rm, rv, nt, wt, n_mol, g = args
        dev = g.device
        rows = torch.tensor([0, g.shape[0] - 1], device=dev)
        cols = torch.cat([torch.arange(t * nt, (t + 1) * nt)
                          for t in tiles[e]]).to(dev)
        ti = torch.tensor(tiles[e], device=dev)
        sub = {k: pre[k][rows][:, cols].contiguous() for k in PER_LN}
        sub.update({k: pre[k][cols].contiguous() for k in PER_L})
        sub["flags"] = {k: v[cols].contiguous()
                        for k, v in pre["flags"].items()}
        captured[e] = dict(
            args=(sub, mol[cols].contiguous(), wh, wl),
            rev=(rm[ti].contiguous(), rv[ti].contiguous()),
            sizes=(nt, wt, n_mol), g=g[rows].contiguous(),
            out=[None if o is None else o[rows][:, cols].clone()
                 for o in out])

    reset_counts()
    r = envelope.envelope_grad(model, state, echo=lambda s: log("  " + s),
                               on_bwd=on_bwd)
    launches, started = r["launches"], r["kernels_started"]
    if not all(a > 0 and b > 0 for a, b in launches.values()):
        FAILED.append(f"a kernel of the path did not launch: {launches}")
    if started["full"] != 2 * launches["full"][1] or \
            started["lorentz"] != launches["lorentz"][1]:
        FAILED.append(f"the adjoint library started {started} kernels for "
                      f"{launches} launches: the deferred pass did not run")
    if not r["grads_ok"]:
        FAILED.append("a gradient is not finite or is all zero")
    n_lines = len(od.plan["cat"]["mol"])
    est = pipeline._profile_bytes(len(wn), NLAY_ENV, od.nmol, n_lines)
    log(f"  peak of value_and_grad {r['peak_bytes'] / 2**30:.3f} GiB; "
        f"_profile_bytes' forward estimate {est / 2**30:.3f} GiB per "
        f"profile, {est / r['peak_bytes']:.2f}x of it")

    # central differences at the layer of each engine with the largest
    # gradient by t, phase 6's eps and tolerance
    gt = r["grads"]["t"]

    def loss_t(t):
        st = LayerState(p=state.p, t=t, tz=state.tz, wkl=state.wkl,
                        wbrodl=state.wbrodl, clw=state.clw)
        with torch.no_grad():
            tb = envelope.tb_of(model, st, engine, lor)
        return float(torch.mean((tb.double() - r["tb_obs"]) ** 2))

    eps = 4.0
    for e, kind in (("full", "SD-Voigt engine"),
                    ("lorentz", "all-Lorentz engine")):
        il = max(layers[e], key=lambda i: abs(float(gt[i])))
        tp, tm = state.t.clone(), state.t.clone()
        tp[il] += eps
        tm[il] -= eps
        fd = (loss_t(tp) - loss_t(tm)) / (2 * eps)
        an = float(gt[il])
        log(f"  central difference, {kind} layer {il} "
            f"({float(state.p[il]):.4g} hPa): autograd {an:.6e}, fd "
            f"{fd:.6e} (eps={eps} K)")
        if not abs(an - fd) <= 5e-2 * abs(fd) + 2e-8:
            FAILED.append(f"gradient of layer {il} ({kind}) differs from "
                          f"central differences: {an} vs {fd}")

    out = {}
    d64 = lambda v: v.double() if torch.is_tensor(v) else v
    for e, k in kernels.items():
        # (the sampled pairs) the kernel on the sub-plan of the sample
        # tiles, bitwise the full launch's; the plain float32 adjoint; both
        # against the plain adjoint in float64
        c = captured[e]
        nt, wt, n_mol = c["sizes"]
        sub, mol, wh, wl = c["args"]
        cm, cv = sub_cand_map(*c["rev"], od.dev_plans[e]["cand_map"].shape[0])
        launch = lambda: k.launch_bwd(sub, mol, wh, wl, *c["rev"], nt, wt,
                                      n_mol, c["g"])
        got = launch()
        torch.cuda.synchronize()
        same = all(a is None or torch.equal(a, b)
                   for a, b in zip(got, c["out"]))
        rows = [layers[e][0], layers[e][-1]]
        what = (f"{e} adjoint, rows {rows} ({float(state.p[rows[0]]):.4g}, "
                f"{float(state.p[rows[1]]):.4g} hPa) x line tiles "
                f"{tiles[e]} (reverse rows of "
                f"{c['rev'][1].sum(1).tolist()} slots)")
        log(f"  {what}: bitwise the full launch's: {same}")
        if not same:
            FAILED.append(f"{what}: not bitwise the full launch's")
        plain, plain_ms = timed_call(lambda: k.plain_bwd(
            sub, mol, wh, wl, cm, cv, nt, wt, n_mol, c["g"]))
        pre64 = {n: d64(v) for n, v in sub.items()}
        bwd64 = line_sum_bwd_plain if k.voigt else lorentz_sum_bwd_plain
        ref64 = bwd64(pre64, mol, d64(wh), d64(wl), cm, cv, nt, wt, n_mol,
                      d64(c["g"]),
                      **({"f32_fallback": True} if k.voigt else {}))
        worst, e64 = (0.0, 0.0), {}
        for i, name in enumerate(PER_LN):
            if got[i] is None:
                continue
            worst = tuple(map(max, worst, compare(
                got[i], plain[i], f"{e} sample d{name} vs plain float32",
                BWD_ATOL)))
            scale = float(ref64[i].abs().max().clamp_min(1e-300))
            e64[name] = [float((v.double() - ref64[i]).abs().max()) / scale
                         for v in (got[i], plain[i])]
        log(f"  {e} sample against the plain adjoint in float64, err/max "
            f"(kernel, plain float32): "
            + ", ".join(f"d{n} {a:.3e} / {b:.3e}" for n, (a, b)
                        in e64.items()))
        sub_ms = cuda_ms(launch, 3)

        # (the whole plans) each kernel's device time in one adjoint call
        # by the profiler; the deferral words against the SD-Voigt lanes
        # counted here; the bound of the envelope's launches
        args = operands(model, state, e, layers[e])
        L, wp = args[0]["stild"].shape[0], args[2].shape[0]
        gen = torch.Generator(device=wh.device).manual_seed(15)
        g = torch.randn((L, wp, n_mol), generator=gen, device=wh.device)
        kms = adjoint_kernel_ms(k, args, g)
        t0 = time.perf_counter()
        counts, sd_lanes, by_class = lane_counts_by_interval(
            *args[:9], voigt=k.voigt)
        t_count = time.perf_counter() - t0
        bounds = {d: bound_by_class(d, k.voigt, counts, by_class,
                                    line_bytes(args, d, k.voigt))
                  for d in ("fwd", "bwd")}
        slots = None
        if k.voigt:
            marked = k.deferred != 0
            slots = deferral_slots(k.deferred, args[-1][1], nt)
            log(f"  {e}: {int(marked.sum())} of {marked.numel()} (layer, "
                f"line) deferred, {int((sd_lanes > 0).sum())} with kept "
                f"SD-Voigt lanes ({int(sd_lanes.sum())}); the deferred pass "
                f"visits {slots[0]} slots (a 32-bit slot mask: {slots[1]})")
            if not torch.equal(marked, sd_lanes > 0):
                FAILED.append(f"{e}: the deferral words are not the (layer, "
                              f"line) pairs with SD-Voigt lanes")
        log(f"  {e} at the envelope: lanes lor/lor+k2/sd/sd+k2 {counts} "
            f"(counted in {t_count:.1f} s); forward bound "
            f"{bounds['fwd'][0]:.3f} ms ({bounds['fwd'][1]}), adjoint bound "
            f"{bounds['bwd'][0]:.3f} ms ({bounds['bwd'][1]}); adjoint kernels "
            f"by the profiler {kms} ms; built {k.bwd_info(nt, wt, n_mol)}")
        out[f"linesum_{k.name}"] = {
            "envelope_bound_ms": bounds["fwd"][0],
            "envelope_bound_by": bounds["fwd"][1],
            "envelope_grad_launches": launches[e][0],
            "envelope_grad_ms": r["kernel_ms"][(e, "fwd")]}
        out[f"linesum_bwd_{k.name}"] = {
            "envelope_launches": launches[e][1],
            "envelope_ms": r["kernel_ms"][(e, "bwd")],
            "envelope_bound_ms": bounds["bwd"][0],
            "envelope_bound_by": bounds["bwd"][1],
            "envelope_kernel_ms": kms, "envelope_lanes": counts,
            "envelope_deferred_slots": slots,
            "envelope_sample": {
                "rows": rows, "line_tiles": tiles[e], "bitwise_full": same,
                "ms": sub_ms, "plain_ms": plain_ms, "max_abs_err": worst[0],
                "max_rel_err": worst[1], "vs_float64": e64}}
    log(f"  value_and_grad {r['value_and_grad_s']:.3f} s, forward "
        f"{r['forward_s']:.3f} s, peak {r['peak_bytes'] / 2**30:.3f} GiB, "
        f"launches {launches}, kernel ms "
        f"{ {f'{a} {b}': v for (a, b), v in r['kernel_ms'].items()} }")
    out["value_and_grad"] = {"s": r["value_and_grad_s"],
                             "forward_s": r["forward_s"],
                             "peak_bytes": r["peak_bytes"],
                             "profile_bytes_estimate": est}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-rank"]:
        return mesh_rank(Path(argv[1]), argv[2])
    from monortm_tpu_torch.ops import linesum_kernel
    from monortm_tpu_torch.ops.linesum import (VOIGT_KERNEL,
                                               line_sum_bwd_plain,
                                               precompute)
    from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
    from monortm_tpu_torch.ops.lineshape import LineConfig
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

    if argv == ["--float64"]:
        # phase 9 alone; the dense engine runs no kernel, so none is built
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            log(f"phase 9 float64 pipeline alone: {F64_NPROF} profiles, caps "
                f"{F64_CAPS}, tiles {F64_TILES}")
            phase9_float64(Path(tmp), pipeline_lines(), kernels,
                           reset_counts)
        phase_done(9)
        return 0

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
                if name == "hw":
                    # C2's limit holds the plain float32 adjoint; the
                    # kernel, which this check does not change, is held
                    # at BWD_ATOL above and its reading printed beside
                    log(f"  {what} dhw vs float64: plain float32 "
                        f"{e32:.3e}, kernel {e[1]:.3e} of max (C2 limit "
                        f"{C2_LIMIT} on the plain adjoint; kernel "
                        f"{'within' if e[1] <= C2_LIMIT else 'OVER'} it)")
                    if e32 > C2_LIMIT:
                        FAILED.append(f"{what} dhw: the plain float32 "
                                      f"adjoint is {e32:.3e} of max from "
                                      f"float64, over {C2_LIMIT}")
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
    if argv == ["--envelope"]:
        # phases 14 and 15 alone
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            log("phase 14 the reference's capacity envelope")
            env, built = phase14(Path(tmp), dev, kernels, reset_counts)
            phase_done(14)
            log("phase 15 the retrieval adjoint at the envelope")
            grad = phase15(kernels, reset_counts, built)
            del built
        phase_done(15)
        print(json.dumps({"phase14": env, "phase15": grad}))
        return 0
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

    # the CPU path (plain line sums) on profile 0, every CPU_WN_STEP-th
    # wavenumber, is the reference
    t0 = time.perf_counter()
    sub = slice(None, None, CPU_WN_STEP)
    cpu_model = MonoRTM(wn[sub], float(wn[sub][1] - wn[sub][0]), cat,
                        nmol=22, device="cpu")
    st0 = LayerState(**{f: getattr(state, f)[0].cpu() for f in FIELDS})
    ref = cpu_model.forward(st0, 288.0, emis[sub].cpu(), refl[sub].cpu(),
                            irt=3, engine=engine, lor_layers=lor)
    log(f"  CPU reference (profile 0, {len(wn[sub])} wavenumbers) in "
        f"{time.perf_counter() - t0:.1f} s")
    compare(out.od.od_total[0][sub].cpu(), ref.od.od_total,
            "od_total vs CPU")
    tb_err = float((tb[0][sub].cpu() - ref.rt.tb).abs().max())
    log(f"  tb vs CPU: max_abs_err={tb_err:.3e} K")
    check(tb_err <= TB_ATOL, f"tb differs from the CPU path by {tb_err} K")
    # the kernels refuse the CO2 chi hook (LineConfig.chi_fn): a Python
    # callable cannot enter them, and the reference holds chi at identity
    chi = MonoRTM(small_wn, float(small_wn[1] - small_wn[0]),
                  synthetic_catalog_mw(n_h2o=48, n_o2=16, tile=128),
                  nmol=22, line_cfg=LineConfig(chi_fn=lambda d: d * 0.0 + 1.0),
                  device=dev)
    try:
        chi.forward(synthetic_state(nlay=4, device=dev, dtype=torch.float32),
                    288.0, emis[:len(small_wn)], refl[:len(small_wn)], irt=3,
                    engine="full")
        FAILED.append("a model with LineConfig.chi_fn ran on the card")
    except NotImplementedError as e:
        log(f"  LineConfig(chi_fn=...) on the card: NotImplementedError "
            f"({e})")
        if "chi_fn" not in str(e):
            FAILED.append(f"the chi_fn refusal does not name it: {e}")
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
        counts, sd_lanes, by_class = lane_counts(*args[:9], voigt=k.voigt)
        fast = lane_counts_by_interval(*args[:9], voigt=k.voigt)
        if (fast[0], fast[2]) != (counts, by_class) \
                or not torch.equal(fast[1], sd_lanes):
            FAILED.append(f"{eng}: lane_counts_by_interval {fast[0]} "
                          f"{fast[2]} is not lane_counts {counts} {by_class}")
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
    phase_done(9)

    # ---- phase 10: an infrared grid through the default kernels ---------
    log("phase 10 infrared forward: every MT_CKD sub-continuum and Rayleigh")
    phase10_infrared(cat, state, dev, kernels, reset_counts)
    phase_done(10)

    # ---- phase 11: cross-sections through the pipeline ------------------
    log(f"phase 11 cross-sections (IXSECT=1): {XS_NPROF} profiles (depth "
        f"cut for xsec-prep's host time) x {NLAY} layers x {NWN} "
        f"wavenumbers inside the synthetic band, CCL4 and F11")
    phase11_xsec(tmp, kernels, reset_counts)
    phase_done(11)

    # ---- phase 12: the native host helper -------------------------------
    log("phase 12 native host helper: IATM=1 layering and load_catalog, "
        "native vs Python walk")
    phase12_native(tmp)
    phase_done(12)

    # ---- phase 13: ranks on a mesh, sharing the card over gloo ----------
    log("phase 13 meshes: gloo ranks sharing the card (correctness, not "
        "scaling), through the CLI with --distributed on phase 8's rundir, "
        f"float64 on phase 9's, value_and_grad at bench.py's workload")
    mesh_launches = phase13_mesh(tmp, {
        "state": {f: getattr(state, f).cpu() for f in FIELDS},
        "tsfc": tsfc.cpu(), "emis": emis.cpu(), "tb_obs": tb_obs.cpu(),
        "loss": loss.cpu(), "grads": {f: g.cpu() for f, g in grads.items()}})
    for k in kernels.values():
        results[f"linesum_{k.name}"]["mesh_launches"] = {
            m: [lc and lc.get(k.name) for lc in v]
            for m, v in mesh_launches.items() if "grad" not in m}
        results[f"linesum_bwd_{k.name}"]["mesh_launches"] = {
            m: [lc[k.name][1] for lc in v]
            for m, v in mesh_launches.items() if "grad" in m}
    phase_done(13)

    # ---- phase 14: the reference's capacity envelope --------------------
    log(f"phase 14 the reference's capacity envelope: row blocks past "
        f"{ROWS_BIG - 65} rows, the 250k-line x 8192-wn capacity check, 1 "
        f"profile x {NLAY_ENV} layers x 80000 wn x 250k lines through "
        f"pipeline.run, the kernels on sampled blocks, Tb against float64")
    env, built = phase14(tmp, dev, kernels, reset_counts)
    for name, r in env.items():
        results[name].update(r)
    tmp_dir.cleanup()
    phase_done(14)

    # ---- phase 15: the retrieval adjoint at the envelope ----------------
    log(f"phase 15 value_and_grad at the envelope: 1 profile x {NLAY_ENV} "
        f"layers x 80000 wn x 250k lines, phase 14's model")
    grad = phase15(kernels, reset_counts, built)
    del built
    grad.pop("value_and_grad")
    for name, r in grad.items():
        results[name].update(r)
    phase_done(15)

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
             "blocks_per_sm", "kernels_per_launch", "pipeline_launches",
             "mesh_launches", "envelope_launches", "envelope_ms",
             "envelope_sample", "tb_vs_float64_K", "row_block_calls",
             "envelope_bound_ms", "envelope_bound_by",
             "envelope_grad_launches", "envelope_grad_ms",
             "envelope_kernel_ms", "envelope_lanes",
             "envelope_deferred_slots")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
