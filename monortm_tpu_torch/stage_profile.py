"""Where the forward's time goes on the card, stage by stage.

Runs `MonoRTM.forward` at bench.py's workload (8 profiles x 40 layers x
1024 wavenumbers x 3074 lines, hybrid engine split) on one CUDA device
and prints one JSON object: the medians of the forward's and of the
retrieval's value_and_grad wall times (host clock around a synchronised
call, 12 of each, interleaved), the device's busy time and kernel count
per forward and per value_and_grad, and for each stage of the forward
(TIPS, LINES prologue, line-sum kernel, continuum, cloud, RT) its host
time, kernel count and device busy time, read from a `torch.profiler`
trace.  Kernels are given to the innermost stage whose device-side range
holds their start; the rest is "other".  The value_and_grad is
chip_smoke.py's: mean((tb - tb_obs)^2) against the state warmed by 1 K,
and its gradient by every float field of the state.

Run from the repository root on a machine with a GPU:
    python3 -m monortm_tpu_torch.stage_profile
It fails where there is no CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from monortm_tpu_torch.models import monortm as monortm_mod
from monortm_tpu_torch.models import od as od_mod
from monortm_tpu_torch.ops import linesum, linesum_kernel
from monortm_tpu_torch.testing import synthetic_catalog_mw, synthetic_state
from monortm_tpu_torch.types import FIELDS, LayerState

BATCH, NLAY, NWN = 8, 40, 1024
PREFIX = "stage:"        # short range names would be demangled by the trace


def _labelled(name, fn):
    def run(*a, **k):
        with record_function(PREFIX + name):
            return fn(*a, **k)
    return run


def _label_stages(model):
    """Wrap each stage of `model`'s forward in a profiler range."""
    od = model.od_model
    od.tips.scor = _labelled("tips", od.tips.scor)
    linesum.precompute = _labelled("prologue", linesum.precompute)
    kern = linesum_kernel.LineSumKernel
    kern.launch = _labelled("line_kernel", kern.launch)
    type(od.cont).__call__ = _labelled("continuum", type(od.cont).__call__)
    od_mod.od_clw = _labelled("cloud", od_mod.od_clw)
    monortm_mod.rtm = _labelled("rt", monortm_mod.rtm)


def _interleaved_median_ms(fns, n):
    """Median wall ms of each of `fns`, timed in turn n times."""
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, acc in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
    return [statistics.median(t) * 1e3 for t in times]


def _profile(fn, n):
    """The profiler's events of n calls of fn, and its device kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    return events, gpu, [e for e in gpu if not e.name.startswith(PREFIX)]


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=512)
    wn = np.linspace(0.3, 55.0, NWN)
    model = monortm_mod.MonoRTM(wn, float(wn[1] - wn[0]), cat, nmol=22,
                                device=dev)
    state = synthetic_state(nlay=NLAY, batch=BATCH, device=dev,
                            dtype=torch.float32)
    engine, lor = model.engine_split(state)
    emis = torch.full((NWN,), 0.95, device=dev)
    tsfc = torch.full((BATCH, 1), 288.0, device=dev)

    def forward():
        return model.forward(state, tsfc, emis, 1.0 - emis, irt=3,
                             engine=engine, lor_layers=lor)

    warm = LayerState(p=state.p, t=state.t + 1.0, tz=state.tz + 1.0,
                      wkl=state.wkl, wbrodl=state.wbrodl, clw=state.clw)
    with torch.no_grad():
        tb_obs = model.tb(warm, tsfc, emis, 1.0 - emis, irt=3,
                          engine=engine, lor_layers=lor)

    def value_and_grad():
        leaves = LayerState(**{f: getattr(state, f).detach()
                               .requires_grad_() for f in FIELDS})
        tb = model.tb(leaves, tsfc, emis, 1.0 - emis, irt=3, engine=engine,
                      lor_layers=lor)
        loss = torch.mean((tb - tb_obs) ** 2)
        return torch.autograd.grad(loss, [getattr(leaves, f)
                                          for f in FIELDS])

    for _ in range(3):
        forward()
        value_and_grad()
    fwd_ms, vag_ms = _interleaved_median_ms([forward, value_and_grad], 12)

    n_vag = 3
    _, _, vag_kernels = _profile(value_and_grad, n_vag)
    vag_busy_ms = sum(k.time_range.elapsed_us()
                      for k in vag_kernels) / 1e3 / n_vag

    _label_stages(model)
    n = 5
    events, gpu, kernels = _profile(forward, n)
    ranges = [e for e in gpu if e.name.startswith(PREFIX)]

    stages = {"other": {"host_ms": 0.0, "kernels": 0.0, "busy_ms": 0.0}}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX):
            st = stages.setdefault(e.name[len(PREFIX):], {
                "host_ms": 0.0, "kernels": 0.0, "busy_ms": 0.0})
            st["host_ms"] += e.time_range.elapsed_us() / 1e3 / n
    for k in kernels:
        t = k.time_range.start
        holding = [r for r in ranges
                   if r.time_range.start <= t < r.time_range.end]
        name = (min(holding, key=lambda r: r.time_range.elapsed_us())
                .name[len(PREFIX):] if holding else "other")
        stages[name]["kernels"] += 1 / n
        stages[name]["busy_ms"] += k.time_range.elapsed_us() / 1e3 / n

    busy_ms = sum(k.time_range.elapsed_us() for k in kernels) / 1e3 / n
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi.stdout.strip(),
        "workload": {"batch": BATCH, "nlay": NLAY, "nwn": NWN,
                     "lines": int(np.sum(cat.valid)), "engine": engine,
                     "lorentz_layers": len(lor)},
        "forward_ms_median": fwd_ms,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share": 1.0 - busy_ms / fwd_ms,
        "kernels_per_forward": len(kernels) / n,
        "value_and_grad_ms_median": vag_ms,
        "device_busy_ms_per_value_and_grad": vag_busy_ms,
        "kernels_per_value_and_grad": len(vag_kernels) / n_vag,
        "stages": stages,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
