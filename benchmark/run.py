"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or `python3 -m benchmark.run ...`), from the root of a checkout.  The
cell (BENCHMARK.json's `workloads`) names a configuration
(benchmark/configs/<config>.json: the deployment's sizes) and a traffic
mix (benchmark/traffic/<mix>.json: its parameters and the driver in
benchmark/drivers/ that runs it); its limits are in
benchmark/workloads/<cell>.json and each per-layer metric is read by
benchmark/metrics/<metric>.py.  All are found by name, so a new cell,
mix or metric is a new file.

A run: set-up (the inputs written from the seed under TMPDIR, one warm
step of the cell's shapes, the kernels served from build/ in the
checkout), then steps of the driver back to back for --seconds (the
window: the last step started in it runs to its end), then the peak
device memory, then the check of the window's outputs against the plain
reference (benchmark/reference/) on the card.  With --trace 1 the first
`trace_steps` steps run under torch.profiler and the result carries the
cell's per-layer metrics instead of its end-to-end ones.  The last line
of standard output is the JSON result; the numbers compared, each beside
its limit, end standard error.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one process with few threads: the CPU-side thread pools of the program's
# libraries take one thread each, so that the run's host work does not
# contend with itself for the machine's cores
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "monortm_tpu")


def load_cell(name: str) -> SimpleNamespace:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    limits and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return SimpleNamespace(name=name, cell=cell, cfg=cfg, traffic=traffic,
                           limits=limits["limits"], e2e=e2e, layer=layer,
                           run_seconds=bench["run_seconds"])


def reader(metric: str):
    """benchmark/metrics/<metric>.py's `read`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_of(c: SimpleNamespace, seed: int, device, work: Path):
    mod = importlib.import_module(f"benchmark.drivers.{c.traffic['driver']}")
    return mod, mod.Driver(c.cfg, c.traffic, seed, device, work)


def window(drv, seconds: float, tracer=None, trace_steps: int = 0):
    """Steps back to back until `seconds` have passed; the step running
    then completes.  Returns (start, end, [(t0, t1, units)])."""
    steps = []
    t0 = time.perf_counter()
    k = 0
    while True:
        s0 = time.perf_counter()
        if s0 - t0 >= seconds and k > 0:
            break
        units = drv.step(k)
        steps.append((s0, time.perf_counter(), units))
        k += 1
        if tracer is not None and k == trace_steps:
            tracer.stop()
    return t0, time.perf_counter(), steps


def e2e_metrics(steps, start, end, setup_s) -> dict:
    """Every end-to-end metric a driver's window can give (host clock),
    by the name of its kind: the rate over all the work and all the time
    of the window, and the 95th percentile over every step.  A metric's
    kind is its name up to the first dot (`profiles_per_s.capacity` is a
    `profiles_per_s`)."""
    dur = [b - a for a, b, _ in steps]
    units = sum(u for *_, u in steps)
    p95 = (statistics.quantiles(dur, n=20)[-1] if len(dur) > 1
           else dur[0])
    return {"setup_s": setup_s, "profiles_per_s": units / (end - start),
            "grad_profiles_per_s": units / (end - start),
            "grad_step_p95_ms": 1e3 * p95}


def judge(gaps: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number at or under its
    limit."""
    rows = [(k, float(gaps[k]), float(limits[k]["limit"])) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows


def run(c: SimpleNamespace, seed: int, seconds: float, trace: bool,
        device="cuda", drv=None) -> dict:
    """One run of cell c; returns the result dict.  device "cpu" (tests
    only) skips the card's readings; drv: a driver to run instead of the
    cell's own (tests plant faults in one)."""
    import torch

    from benchmark import devtrace
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if drv is None:
        work = Path(tempfile.gettempdir()) / "monortm-benchmark" / c.name
        shutil.rmtree(work, ignore_errors=True)
        _, drv = driver_of(c, seed, dev, work)
    try:
        marks = [("import", time.perf_counter())]
        if cuda:
            torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
        marks.append(("cuda-init", time.perf_counter()))
        drv.setup()
        gc.collect()
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - T_START
        marks += drv.marks + [("collect", time.perf_counter())]
        tracer = devtrace.Window(drv.work) if trace else None
        n_trace = int(c.traffic["trace_steps"])
        start, end, steps = window(drv, seconds, tracer, n_trace)
        if tracer is not None and len(steps) < n_trace:
            tracer.stop()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        drv.free()
        result = {"attempted": len(steps), "failed": 0}
        if trace:
            tr = tracer.summary()
            ctx = SimpleNamespace(trace=tr, driver=drv, steps=min(
                n_trace, len(steps)), ref_device=dev)
            metrics = {}
            for m in c.layer:
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["breakdown"] = tr.breakdown()
            busy, win = tr.busy_s, tr.window_s
        else:
            vals = e2e_metrics(steps, start, end, setup_s)
            metrics = {m["name"]: {"value": vals[m["name"].split(".")[0]],
                                   "unit": m["unit"]} for m in c.e2e}
        gaps = drv.check(dev)
        ok, rows = judge(gaps, c.limits)
        result.update(correct=ok, metrics=metrics)
        t = [T_START] + [m[1] for m in marks]
        result["setup_split"] = {m[0]: t[i + 1] - t[i]
                                 for i, m in enumerate(marks)}
        result["detail"] = getattr(drv, "detail", {})
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": c.cell["chips"], "memory_peak_bytes": int(peak)}
        if trace:
            result["device"].update(busy_s=busy, window_s=win)
        result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                                "limit": lim} for k, v, lim in rows}
        return result
    finally:
        drv.cleanup()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    c = load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.cell["chips"]:
        print(f"benchmark: the cell needs {c.cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    res = run(c, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    print("setup split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["setup_split"].items()),
        file=sys.stderr)
    if res["detail"]:
        print("check detail: " + json.dumps(res["detail"]), file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
