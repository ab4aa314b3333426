"""The line-sum kernels of this checkout against another's, in one call.

Builds `csrc/linesum.cu` and `csrc/linesum_bwd.cu` of this checkout and
of another one (a directory holding `monortm_tpu_torch/csrc/` with the
same C entry points, for example `git archive` of an earlier commit),
one nvcc each with its `-Xptxas -v` report, all started together, and
times them on the same bench-workload operands as `chip_smoke.py`'s main
path (8 profiles x 40 layers x 1024 wavenumbers x 3074 lines, hybrid
split; the adjoints on the real cotangent of the retrieval loss): CUDA
events, 20 launches per sample, in the order other, this, copy, then the
same backwards, repeated `--rounds` times.  `copy` is a second build of
this checkout's source: the control that says how far two equal kernels
read apart.  Each `--variant DIR` (another checkout, for example this
tree with one constant changed) adds its forward kernels to the same
interleaving.

Forward outputs must be bitwise equal to the other checkout's; the
adjoints' cotangents need not be, and their largest difference is
printed for each, in units of the other checkout's largest value
(`--same-adjoint` requires 0 and two runs bitwise equal).  The other
checkout's adjoint may have the entry point without the deferral scratch
(the last pointer before the stream); a library that does not export
`monortm_linesum_backward_info` is called that way.  Where a forward
library exports `monortm_linesum_forward_info` its registers and blocks
per SM are printed; where it exports
`monortm_linesum_forward_block_times` (an instrumented copy of the kernel
that records each block's start and end by `%globaltimer`, its SM and its
blockIdx.x; none is committed), the spread of its block times on each
instantiation.

Prints the register report of each build, every sample, and one JSON
line of medians (ms) per instantiation.  Exits 1, after printing every
reading, when a forward is not bitwise equal (or, with `--same-adjoint`,
an adjoint).

Run from the repository root on a machine with a GPU:
    python3 -m monortm_tpu_torch.ab_forward --other build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.ops import linesum_kernel as lk
from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL, precompute
from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
from monortm_tpu_torch.testing import synthetic_catalog_mw, synthetic_state
from monortm_tpu_torch.types import LayerState

BATCH, NLAY, NWN = 8, 40, 1024
FIELDS = ("p", "t", "tz", "wkl", "wbrodl", "clw")


def _build_all(jobs):
    """nvcc each (tag, source) with the kernels' flags into build/, all
    started together; prints ptxas's register reports and returns
    {(tag, source stem): CDLL}."""
    lk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src in jobs:
        blob = src.read_bytes() + (src.parent / "linesum_math.cuh").read_bytes()
        key = hashlib.sha256(blob).hexdigest()[:16]
        lib = lk.BUILD_DIR / f"ab-{tag}-{src.stem}-{key}.so"
        procs[(tag, src.stem)] = (src, lib, subprocess.Popen(
            [lk._nvcc(), *lk.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, failed = {}, []
    for (tag, stem), (src, lib, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        print(f"{tag} ({src}):\n{out}", flush=True)
        if proc.returncode != 0:
            failed.append(f"nvcc {src} failed ({proc.returncode})")
        else:
            libs[(tag, stem)] = ctypes.CDLL(str(lib))
    if failed:
        raise RuntimeError("; ".join(failed))
    return libs


def _forward_fn(lib):
    """(entry point, info or None, block times or None)."""
    fns = lk.entry_points(lib)
    times = None
    if hasattr(lib, "monortm_linesum_forward_block_times"):
        times = lib.monortm_linesum_forward_block_times
        times.argtypes = [ctypes.c_void_p, ctypes.c_int]
        times.restype = ctypes.c_int
    return fns["forward"], fns.get("forward_info"), times


def _block_spread(times, launch):
    """The spread of block times of one launch through an instrumented
    library, which reports per block its start and end (ns, %globaltimer),
    its SM and its blockIdx.x: block durations, when 50/90/99% of blocks
    had ended, each SM's last end, and the median duration by blockIdx.x
    (the wavenumber tile and sub-tile)."""
    launch()
    torch.cuda.synchronize()
    buf = np.zeros((1 << 16, 4), np.uint64)
    n = times(buf.ctypes.data, buf.shape[0])
    if n <= 0:
        return None
    t = buf[:n, :2].astype(np.float64)
    t -= t[:, 0].min()
    t /= 1e3
    dur, end = t[:, 1] - t[:, 0], np.sort(t[:, 1])
    sm, bx = buf[:n, 2].astype(np.int64), buf[:n, 3].astype(np.int64)
    sm_end = np.array([t[sm == s, 1].max() for s in np.unique(sm)])
    pct = lambda v: {q: float(np.percentile(v, p)) for q, p in
                     (("min", 0), ("median", 50), ("p90", 90), ("max", 100))}
    return {"blocks": int(n), "span_us": float(end[-1]),
            "block_us": pct(dur),
            "ended_us": {f"{p}%": float(end[int(p / 100 * (n - 1))])
                         for p in (50, 90, 99)},
            "sms": int(len(sm_end)), "sm_end_us": pct(sm_end),
            "blocks_per_sm": pct(np.bincount(sm)[np.unique(sm)]),
            "median_us_by_blockIdx_x": [
                round(float(np.median(dur[bx == x])), 1)
                for x in np.unique(bx)]}


def _backward_fn(lib):
    """(entry point taking this checkout's arguments, info or None).  The
    branch for a library without the deferral scratch serves only the
    comparison with the single-kernel adjoint that preceded the sweep /
    deferred pair, and goes once that comparison is no longer made."""
    fns = lk.entry_points(lib)
    fn = fns["backward"]
    if "backward_info" in fns:
        return fn, fns["backward_info"]
    # the entry point without the deferral scratch
    fn.argtypes = lk.BWD_ARGTYPES[:-1]
    return (lambda *a: fn(*a[:-2], a[-1])), None


def _operands(model, state, engine, layers, dev):
    od = model.od_model
    ix = torch.as_tensor(layers, device=dev)
    sub = LayerState(p=state.p.index_select(-1, ix),
                     t=state.t.index_select(-1, ix), tz=state.tz,
                     wkl=state.wkl.index_select(-2, ix),
                     wbrodl=state.wbrodl.index_select(-1, ix), clw=state.clw)
    scor = od.tips.scor(sub.t)
    plan = od.dev_plans[engine]
    pre = precompute(plan["cat"], sub.p.reshape(-1), sub.t.reshape(-1),
                     sub.wkl.reshape(-1, 39), sub.wbrodl.reshape(-1),
                     scor.reshape(-1, 39 * 9), od.line_cfg,
                     const=plan["const"])
    return (pre, plan["cat"]["mol"], plan["wn_hi"], plan["wn_lo"],
            plan["cand_map"], plan["cand_valid"], plan["nt"], plan["wt"],
            od.nmol, plan["rev"])


def _cotangents(model, state, engine, lor, dev):
    """The cotangent each adjoint kernel gets in one value_and_grad of the
    retrieval loss mean((tb - tb_obs)^2), tb_obs from the state warmed by
    1 K (chip_smoke.py's main path)."""
    emis = torch.full((NWN,), 0.95, device=dev)
    tsfc = torch.full((BATCH, 1), 288.0, device=dev)
    run = dict(irt=3, engine=engine, lor_layers=lor)
    warm = LayerState(p=state.p, t=state.t + 1.0, tz=state.tz + 1.0,
                      wkl=state.wkl, wbrodl=state.wbrodl, clw=state.clw)
    with torch.no_grad():
        tb_obs = model.tb(warm, tsfc, emis, 1.0 - emis, **run)
    captured = {}
    kernels = {"voigt": VOIGT_KERNEL, "lorentz": LORENTZ_KERNEL}
    for name, k in kernels.items():
        def record(*a, _n=name, _k=k):
            captured[_n] = a[-1]
            return type(_k).launch_bwd(_k, *a)
        k.launch_bwd = record
    try:
        leaves = LayerState(**{f: getattr(state, f).detach().requires_grad_()
                               for f in FIELDS})
        tb = model.tb(leaves, tsfc, emis, 1.0 - emis, **run)
        torch.mean((tb - tb_obs) ** 2).backward()
    finally:
        for k in kernels.values():
            del k.launch_bwd
    return captured


def _ms(entry, fn, launch, reps=20):
    """Mean device ms of `launch()` through entry point `fn`."""
    lk._Library.fns[entry] = fn
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(entry, builds, launch, rounds, label):
    """Interleaved samples of every build: other, this, copy, then the
    same backwards.  Returns the medians and the comparisons of
    `this` with `other` (every sample faster) and with `copy`."""
    order = list(builds) + list(reversed(builds))
    samples = {tag: [] for tag in builds}
    for _ in range(rounds):
        for tag in order:
            samples[tag].append(_ms(entry, builds[tag][0], launch))
    med = {tag: statistics.median(v) for tag, v in samples.items()}
    print(f"{label}: samples {samples}", flush=True)
    out = {f"{tag}_ms": m for tag, m in med.items()}
    out["this_over_other"] = med["this"] / med["other"]
    out["every_sample_faster"] = max(samples["this"]) < min(samples["other"])
    out["control_apart"] = abs(med["this"] - med["copy"]) / med["this"]
    return out


def _info(kernel, info, args, direction="backward"):
    if info is None:
        return None
    lk._Library.fns[f"{direction}_info"] = info
    get = kernel.fwd_info if direction == "forward" else kernel.bwd_info
    return get(args[6], args[7], args[8])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="checkout whose csrc/ kernels are compared")
    ap.add_argument("--variant", action="append", default=[], type=Path,
                    help="another checkout whose forward kernels join the "
                         "interleaving (repeatable)")
    ap.add_argument("--same-adjoint", action="store_true",
                    help="fail unless the adjoints' cotangents are bitwise "
                         "the other checkout's")
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_forward: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    csrc = {"other": a.other / "monortm_tpu_torch" / "csrc",
            "this": lk.CSRC, "copy": lk.CSRC}
    csrc.update({f"variant:{v.name}": v / "monortm_tpu_torch" / "csrc"
                 for v in a.variant})
    libs = _build_all([(tag, d / "linesum.cu") for tag, d in csrc.items()]
                      + [(tag, csrc[tag] / "linesum_bwd.cu")
                         for tag in ("other", "this", "copy")])
    fwd = {tag: _forward_fn(libs[(tag, "linesum")]) for tag in csrc}
    bwd = {tag: _backward_fn(libs[(tag, "linesum_bwd")])
           for tag in ("other", "this", "copy")}
    # the wrappers launch through this checkout's build, swapped per tag
    lk._Library.fns = {**lk.entry_points(libs[("this", "linesum")]),
                       **lk.entry_points(libs[("this", "linesum_bwd")])}

    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512)
    wn = np.linspace(0.3, 55.0, NWN)
    model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
    state = synthetic_state(nlay=NLAY, batch=BATCH, device=dev,
                            dtype=torch.float32)
    engine, lor = model.engine_split(state)
    voigt = [i for i in range(NLAY) if i not in set(lor)]
    cot = _cotangents(model, state, engine, lor, dev)
    result, faults = {}, []
    for name, kernel, layers in (("voigt", VOIGT_KERNEL, voigt),
                                 ("lorentz", LORENTZ_KERNEL, list(lor))):
        args = _operands(model, state, "full" if kernel.voigt else "lorentz",
                         layers, dev)
        # forward: bitwise equal outputs, then times
        launch = lambda: kernel.launch(*args[:9])
        lk._Library.fns["forward"] = fwd["other"][0]
        ref = launch()
        same = {}
        for tag, (fn, _, _) in fwd.items():
            lk._Library.fns["forward"] = fn
            same[tag] = bool(torch.equal(launch(), ref))
            if not same[tag]:
                faults.append(f"{name} forward of {tag} is not bitwise "
                              f"the other checkout's")
        r = _compare("forward", fwd, launch, a.rounds, f"{name} forward")
        r["bitwise_equal"] = all(same.values())
        r["bitwise_equal_by_build"] = same
        r["built"] = {tag: _info(kernel, info, args, "forward")
                      for tag, (_, info, _) in fwd.items()}
        spread = {}
        for tag, (fn, _, times) in fwd.items():
            if times is not None:
                lk._Library.fns["forward"] = fn
                spread[tag] = _block_spread(times, launch)
        if spread:
            r["block_times"] = spread
        print(f"{name} forward: {json.dumps(r)}", flush=True)
        result[f"{name}_forward"] = r

        # adjoint: the cotangents' largest difference, then times
        pre, mol, wh, wl, _, _, nt, wt, n_mol, rev = args
        launch = lambda: kernel.launch_bwd(pre, mol, wh, wl, *rev, nt, wt,
                                           n_mol, cot[name])
        lk._Library.fns["backward"] = bwd["other"][0]
        ref = launch()
        apart = {}
        for tag in bwd:
            if tag == "other":
                continue
            lk._Library.fns["backward"] = bwd[tag][0]
            got, again = launch(), launch()
            apart[tag] = {
                k: float((x - y).abs().max() / y.abs().max())
                for k, x, y in zip(lk.PER_LN, got, ref) if y is not None}
            apart[tag]["same_run_to_run"] = all(
                torch.equal(x, y) for x, y in zip(got, again)
                if x is not None)
            if a.same_adjoint and not (
                    apart[tag]["same_run_to_run"]
                    and all(torch.equal(x, y) for x, y in zip(got, ref)
                            if y is not None)):
                faults.append(f"{name} adjoint of {tag} is not bitwise the "
                              f"other checkout's")
        r = _compare("backward", bwd, launch, a.rounds, f"{name} adjoint")
        r["apart_from_other_of_max"] = apart
        r["built"] = {tag: _info(kernel, info, args)
                      for tag, (_, info) in bwd.items()}
        print(f"{name} adjoint: {json.dumps(r)}", flush=True)
        result[f"{name}_adjoint"] = r
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(result))
    for f in faults:
        print(f"ab_forward: {f}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
