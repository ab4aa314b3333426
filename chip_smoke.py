#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the line-sum kernel from `monortm_tpu_torch/csrc/linesum.cu`,
holds both of its instantiations (VOIGT true / false) against their plain
PyTorch versions on the card, drives `MonoRTM.forward` once at bench.py's
workload (8 profiles x 40 layers x 1024 wavenumbers over 0.3-55 cm^-1 x
3074 lines, hybrid engine split computed on the GPU), checks that the
forward went through both kernels and agrees with the CPU path on one
profile, and times the forward and each kernel beside its plain version.

Run from the repository root:  python3 chip_smoke.py
Exits non-zero (and prints no result line) without a CUDA device or when
any phase fails.  The last line of stdout is
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


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def compare(got, ref, what):
    """Max abs error of got vs ref; fails beyond rtol/atol."""
    err = (got - ref).abs()
    atol = ATOL_REL * float(ref.abs().max())
    bad = err > atol + RTOL * ref.abs()
    log(f"  {what}: max_abs_err={float(err.max()):.3e} "
        f"max|ref|={float(ref.abs().max()):.3e} violations={int(bad.sum())}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(not bool(bad.any()), f"{what}: kernel disagrees with plain "
          f"version beyond rtol={RTOL}, atol={ATOL_REL}*max|ref|")
    return float(err.max())


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    from monortm_tpu_torch.ops import linesum_kernel
    from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL, precompute
    from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
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

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    lib = linesum_kernel.build(verbose=True)
    log(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    def operands(model, state, engine, layers):
        """The kernel operands the forward gives `engine` for `layers`."""
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
        args = (pre, plan["cat"]["mol"], plan["wn_hi"], plan["wn_lo"],
                plan["cand_map"], plan["cand_valid"], plan["nt"], plan["wt"],
                od.nmol)
        return args

    def kernel_vs_plain(model, state, engine, layers, what):
        args = operands(model, state, engine, layers)
        got = kernels[engine](*args)
        ref = kernels[engine].plain(*args)
        torch.cuda.synchronize()
        return compare(got, ref, what), args

    # ---- phase 2: each kernel vs its plain version ---------------------
    log("phase 2 kernel vs plain (rtol=2e-5, atol=2e-6*max|ref|)")
    small_wn = np.linspace(0.4, 50.0, 64)
    small = MonoRTM(small_wn, float(small_wn[1] - small_wn[0]),
                    synthetic_catalog_mw(n_h2o=48, n_o2=16, tile=128),
                    nmol=22, device=dev)
    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512)
    n_lines = int(np.sum(np.asarray(cat.valid)))
    wn = np.linspace(0.3, 55.0, NWN)
    model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
    for name, m, nlay, batch in (("small", small, 4, None),
                                 ("bench", model, NLAY, BATCH)):
        st = synthetic_state(nlay=nlay, batch=batch, device=dev,
                             dtype=torch.float32)
        # the two pressure regimes of tests/test_pallas.py:88-100
        for p_hpa in (1013.0, 0.02):
            sp = LayerState(p=torch.full_like(st.p, p_hpa), t=st.t,
                            tz=st.tz, wkl=st.wkl, wbrodl=st.wbrodl,
                            clw=st.clw)
            for engine in ("full", "lorentz"):
                kernel_vs_plain(m, sp, engine, list(range(nlay)),
                                f"{name} {p_hpa} hPa {engine}")

    # ---- phase 3: the forward at the bench workload --------------------
    log("phase 3 forward at the bench workload")
    state = synthetic_state(nlay=NLAY, batch=BATCH, device=dev,
                            dtype=torch.float32)
    emis = torch.full((NWN,), 0.95, device=dev)
    refl = 1.0 - emis
    tsfc = torch.full((BATCH, 1), 288.0, device=dev)
    engine, lor = model.engine_split(state)
    voigt = [i for i in range(NLAY) if i not in set(lor)]
    log(f"  engine split on the GPU: {engine}, {len(lor)} of {NLAY} layers "
        f"all-Lorentz")
    check(engine == "hybrid", f"expected the hybrid split, got {engine}")

    def forward():
        return model.forward(state, tsfc, emis, refl, irt=3, engine=engine,
                             lor_layers=lor)

    for k in kernels.values():
        k.launches = 0
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
    cpu_model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device="cpu")
    st0 = LayerState(**{f: getattr(state, f)[0].cpu()
                        for f in ("p", "t", "tz", "wkl", "wbrodl", "clw")})
    ref = cpu_model.forward(st0, 288.0, emis.cpu(), refl.cpu(), irt=3,
                            engine=engine, lor_layers=lor)
    log(f"  CPU reference (profile 0) in {time.perf_counter() - t0:.1f} s")
    compare(out.od.od_total[0].cpu(), ref.od.od_total, "od_total vs CPU")
    tb_err = float((tb[0].cpu() - ref.rt.tb).abs().max())
    log(f"  tb vs CPU: max_abs_err={tb_err:.3e} K")
    check(tb_err <= TB_ATOL, f"tb differs from the CPU path by {tb_err} K")

    # ---- phase 4: timings ---------------------------------------------
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

    results = []
    for eng, layers, replaces in (
            ("full", voigt, "monortm_tpu/ops/linesum_pallas.py:94"),
            ("lorentz", list(lor), "monortm_tpu/ops/linesum_lorentz.py:63")):
        err, args = kernel_vs_plain(model, state, eng, layers,
                                    f"bench main-path operands {eng}")
        k = kernels[eng]
        ms = cuda_ms(lambda: k(*args), 20)
        plain_ms = cuda_ms(lambda: k.plain(*args), 3)
        L = args[0]["stild"].shape[0]
        log(f"  {eng} kernel: {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(L={L} layers)")
        results.append({
            "name": f"linesum_{'voigt' if eng == 'full' else 'lorentz'}",
            "route": "cuda", "source": "monortm_tpu_torch/csrc/linesum.cu",
            "replaces": replaces, "launches": launches[eng],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(json.dumps({"kernels": results}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
