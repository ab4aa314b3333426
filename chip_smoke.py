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
    adjoint kernel beside its plain version, peak memory.

Run from the repository root:  python3 chip_smoke.py
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

import json
import statistics
import subprocess
import sys
import time

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


def main() -> int:
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
             "blocks_per_sm", "kernels_per_launch")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
