"""The forward line-sum kernels of this checkout against another's.

Builds `csrc/linesum.cu` of this checkout and of another one (a directory
holding `monortm_tpu_torch/csrc/linesum.cu` with the same C entry point,
for example `git archive` of an earlier commit), each with nvcc's
`-Xptxas -v` report, and times both on the same bench-workload operands
as `chip_smoke.py`'s main path (8 profiles x 40 layers x 1024 wavenumbers
x 3074 lines, hybrid split): CUDA events, 20 launches per sample, in the
order other, this, this, other, repeated `--rounds` times.  Prints the
register report of each build, every sample, and one JSON line of
medians (ms) per instantiation.

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


def _build(src: Path, tag: str) -> Path:
    """nvcc `src` with the kernels' flags into build/; prints ptxas's
    register report."""
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = lk.BUILD_DIR / f"ab-{tag}-{key}.so"
    lk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([lk._nvcc(), *lk.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", str(lib), str(src)], capture_output=True,
                         text=True, timeout=600)
    print(f"{tag} ({src}):\n{out.stdout}{out.stderr}", flush=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed ({out.returncode})")
    fn = ctypes.CDLL(str(lib)).monortm_linesum_forward
    fn.argtypes = lk._Library.get("forward").argtypes
    fn.restype = ctypes.c_int
    return fn


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
            od.nmol)


def _ms(kernel, fn, args, reps=20):
    """Mean device ms of `kernel.launch` through entry point `fn`."""
    lk._Library.fns["forward"] = fn
    kernel.launch(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernel.launch(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="checkout whose csrc/linesum.cu is compared")
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_forward: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    this = _build(lk.SOURCES["forward"], "this")
    other = _build(a.other / "monortm_tpu_torch" / "csrc" / "linesum.cu",
                   "other")

    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512)
    wn = np.linspace(0.3, 55.0, NWN)
    model = MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22, device=dev)
    state = synthetic_state(nlay=NLAY, batch=BATCH, device=dev,
                            dtype=torch.float32)
    _, lor = model.engine_split(state)
    voigt = [i for i in range(NLAY) if i not in set(lor)]
    result = {}
    for name, kernel, layers in (("voigt", VOIGT_KERNEL, voigt),
                                 ("lorentz", LORENTZ_KERNEL, list(lor))):
        args = _operands(model, state, "full" if kernel.voigt else "lorentz",
                         layers, dev)
        lk._Library.fns["forward"] = other
        ref = kernel.launch(*args)
        lk._Library.fns["forward"] = this
        same = bool(torch.equal(kernel.launch(*args), ref))
        samples = {"other": [], "this": []}
        for _ in range(a.rounds):
            for tag, fn in (("other", other), ("this", this),
                            ("this", this), ("other", other)):
                samples[tag].append(_ms(kernel, fn, args))
        print(f"{name}: bitwise equal outputs {same}; samples {samples}",
              flush=True)
        result[name] = {"other_ms": statistics.median(samples["other"]),
                        "this_ms": statistics.median(samples["this"]),
                        "bitwise_equal": same}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
