"""The line-sum kernels of this checkout against another's, in one call.

Builds `csrc/linesum.cu` and `csrc/linesum_bwd.cu` of this checkout and
of another one (a directory holding `monortm_tpu_torch/csrc/` with the
same C entry points, for example `git archive` of an earlier commit),
each with nvcc's `-Xptxas -v` report, and times them on the same
bench-workload operands as `chip_smoke.py`'s main path (8 profiles x 40
layers x 1024 wavenumbers x 3074 lines, hybrid split; the adjoints on the
real cotangent of the retrieval loss): CUDA events, 20 launches per
sample, in the order other, this, copy, copy, this, other, repeated
`--rounds` times.  `copy` is a second build of this checkout's source:
the control that says how far two equal kernels read apart.

Forward outputs must be bitwise equal between the two checkouts; the
adjoints' cotangents need not be, and their largest difference is
printed for each, in units of the other checkout's largest value.  The
other checkout's adjoint may have the entry point without the deferral
scratch (the last pointer before the stream); a library that does not
export `monortm_linesum_backward_info` is called that way.

Prints the register report of each build, every sample, and one JSON
line of medians (ms) per instantiation.

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


def _build(src: Path, tag: str) -> ctypes.CDLL:
    """nvcc `src` with the kernels' flags into build/; prints ptxas's
    register report."""
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = lk.BUILD_DIR / f"ab-{tag}-{src.stem}-{key}.so"
    lk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([lk._nvcc(), *lk.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    print(f"{tag} ({src}):\n{out.stdout}{out.stderr}", flush=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed ({out.returncode})")
    return ctypes.CDLL(str(lib))


def _forward_fn(lib):
    fn = lib.monortm_linesum_forward
    fn.argtypes = lk._Library.get("forward").argtypes
    fn.restype = ctypes.c_int
    return fn, None


def _backward_fn(lib):
    """(entry point taking this checkout's arguments, info or None).  The
    branch for a library without the deferral scratch serves only the
    comparison with the single-kernel adjoint that preceded the sweep /
    deferred pair, and goes once that comparison is no longer made."""
    fn = lib.monortm_linesum_backward
    fn.restype = ctypes.c_int
    if hasattr(lib, "monortm_linesum_backward_info"):
        fn.argtypes = lk.BWD_ARGTYPES
        info = lib.monortm_linesum_backward_info
        info.argtypes = lk._Library.get("backward_info").argtypes
        info.restype = ctypes.c_int
        return fn, info
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
                     scor.reshape(-1, 39 * 9), od.line_cfg)
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


def _info(kernel, info, args):
    if info is None:
        return None
    lk._Library.fns["backward_info"] = info
    return kernel.bwd_info(args[6], args[7], args[8])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="checkout whose csrc/ kernels are compared")
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_forward: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    other_csrc = a.other / "monortm_tpu_torch" / "csrc"
    fwd = {"other": _forward_fn(_build(other_csrc / "linesum.cu", "other")),
           "this": _forward_fn(_build(lk.SOURCES["forward"], "this")),
           "copy": _forward_fn(_build(lk.SOURCES["forward"], "copy"))}
    bwd = {"other": _backward_fn(_build(other_csrc / "linesum_bwd.cu",
                                        "other")),
           "this": _backward_fn(_build(lk.SOURCES["backward"], "this")),
           "copy": _backward_fn(_build(lk.SOURCES["backward"], "copy"))}
    own = dict(lk._Library.fns)     # this checkout's cached build

    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512)
    wn = np.linspace(0.3, 55.0, NWN)
    model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
    state = synthetic_state(nlay=NLAY, batch=BATCH, device=dev,
                            dtype=torch.float32)
    engine, lor = model.engine_split(state)
    voigt = [i for i in range(NLAY) if i not in set(lor)]
    cot = _cotangents(model, state, engine, lor, dev)
    result = {}
    for name, kernel, layers in (("voigt", VOIGT_KERNEL, voigt),
                                 ("lorentz", LORENTZ_KERNEL, list(lor))):
        args = _operands(model, state, "full" if kernel.voigt else "lorentz",
                         layers, dev)
        # forward: bitwise equal outputs, then times
        launch = lambda: kernel.launch(*args[:9])
        lk._Library.fns["forward"] = fwd["other"][0]
        ref = launch()
        lk._Library.fns["forward"] = fwd["this"][0]
        same = bool(torch.equal(launch(), ref))
        r = _compare("forward", fwd, launch, a.rounds, f"{name} forward")
        r["bitwise_equal"] = same
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
        r = _compare("backward", bwd, launch, a.rounds, f"{name} adjoint")
        r["apart_from_other_of_max"] = apart
        r["built"] = {tag: _info(kernel, info, args)
                      for tag, (_, info) in bwd.items()}
        print(f"{name} adjoint: {json.dumps(r)}", flush=True)
        result[f"{name}_adjoint"] = r
    lk._Library.fns.update(own)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
