"""The port's spans (`utils/trace.py`) on the CPU.

- A retrieval step (value_and_grad through `MonoRTM.tb`, 2 profiles x 4
  layers x 32 wavenumbers, the hybrid engine split) under
  `torch.profiler` exports `engine-split`, `lines`, `continuum`, `od-sum`
  and `rt` once each, and each of the last four's backward twin
  `<stage>.bwd`; the backward nodes made inside a stage's forward range
  (matched by the profiler's sequence numbers) run inside its twin.
- The spans move no bit: the loss and every gradient are bitwise equal
  with the profiler on and off; with it off the autograd graph is the
  graph of the model without spans, and with it on the only extra nodes
  are the twins'.
- `pipeline.run(device="cpu", profile_dir=...)` writes a `queue-wait` row
  into STAGE TIMING, and its trace holds the model build's parts nested
  in `model-build` and the producer thread's stages.
"""

import collections
import functools
import json
import re

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from monortm_tpu_torch.models import monortm as monortm_mod
from monortm_tpu_torch.models import od as od_mod
from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.pipeline import run
from monortm_tpu_torch.testing import (make_minimal_rundir,
                                       synthetic_catalog_mw, synthetic_state)
from monortm_tpu_torch.types import FIELDS, LayerState
from monortm_tpu_torch.utils import span

torch.set_num_threads(1)

WN = np.linspace(0.3, 55.0, 32)
STAGES = ("lines", "continuum", "od-sum", "rt")
TWIN_NODES = {"_LeftBackward", "_EnteredBackward"}
BUILD_PARTS = ("model-build.tables", "model-build.catalog",
               "model-build.plan", "model-build.upload")
EPS_US = 1e-2       # the trace's microseconds round at the last digit


@functools.lru_cache(maxsize=None)
def _model():
    return MonoRTM(WN, 0.25, synthetic_catalog_mw(n_h2o=24, n_o2=12,
                                                  tile=64),
                   nmol=22, device="cpu", wn_tile=128, line_tile=128)


def _step():
    """A retrieval step's loss and leaves, through the model's own
    engine split."""
    pm = _model()
    st = synthetic_state(nlay=4, batch=2, device="cpu", dtype=torch.float32)
    leaves = {f: getattr(st, f).detach().requires_grad_() for f in FIELDS}
    state = LayerState(**leaves)
    eng, lor = pm.engine_split(state)
    assert eng == "hybrid"
    emis = torch.full((len(WN),), 0.95)
    tb = pm.tb(state, 288.0, emis, 1.0 - emis, irt=3, engine=eng,
               lor_layers=lor)
    return torch.mean((tb - 200.0) ** 2), [leaves[f] for f in FIELDS]


def _nodes(loss) -> collections.Counter:
    """The autograd graph's nodes under `loss`, by class name."""
    seen, todo = set(), [loss.grad_fn]
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        todo += [nxt for nxt, _ in n.next_functions]
    return collections.Counter(type(n).__name__ for n in seen)


def _events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _ranges(events) -> dict:
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(e)
    return out


def _inside(e, r) -> bool:
    return (r["ts"] - EPS_US <= e["ts"]
            and e["ts"] + e["dur"] <= r["ts"] + r["dur"] + EPS_US)


def test_retrieval_step_exports_each_span_and_backward_twin(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, leaves = _step()
        torch.autograd.grad(loss, leaves)
    events = _events(prof, tmp_path)
    ranges = _ranges(events)
    for name in ("engine-split",) + STAGES + tuple(s + ".bwd"
                                                   for s in STAGES):
        assert len(ranges.get(name, ())) == 1, name
        assert ranges[name][0]["dur"] > 0, name
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    evaluated = [e for e in ops if e["name"].startswith(
        "autograd::engine::evaluate_function: ")]
    for s in STAGES:
        fwd, bwd = ranges[s][0], ranges[s + ".bwd"][0]
        assert bwd["ts"] > fwd["ts"] + fwd["dur"]
        made = {e["args"]["Sequence number"] for e in ops
                if "Sequence number" in e.get("args", {})
                and not e["name"].startswith("autograd::")
                and _inside(e, fwd)}
        ran = [e for e in evaluated
               if e["args"].get("Sequence number") in made
               and e["name"].split(": ")[-1] not in TWIN_NODES]
        assert ran, s
        outside = [e["name"] for e in ran if not _inside(e, bwd)]
        assert not outside, (s, outside[:5])


def test_spans_move_no_bit_and_add_nodes_only_under_the_profiler(
        monkeypatch):
    assert not isinstance(span("x"), torch.profiler.record_function)
    loss, leaves = _step()
    nodes_off = _nodes(loss)
    grads_off = torch.autograd.grad(loss, leaves)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_on, leaves_on = _step()
        nodes_on = _nodes(loss_on)
        grads_on = torch.autograd.grad(loss_on, leaves_on)
    assert torch.equal(loss, loss_on)
    for f, a, b in zip(FIELDS, grads_off, grads_on):
        assert torch.equal(a, b), f
    extra = nodes_on - nodes_off
    assert not nodes_off - nodes_on
    assert set(extra) == TWIN_NODES
    assert extra["_EnteredBackward"] == len(STAGES)

    bare = lambda name, fn, *args: fn(*args)
    monkeypatch.setattr(od_mod, "traced", bare)
    monkeypatch.setattr(monortm_mod, "traced", bare)
    assert _nodes(_step()[0]) == nodes_off


def test_pipeline_writes_queue_wait_and_model_build_parts(tmp_path):
    make_minimal_rundir(tmp_path, nprof=3)
    run(filein=tmp_path / "MONORTM.IN", fileprof=tmp_path / "MONORTM_PROF.IN",
        hfile=tmp_path / "TAPE3", outdir=tmp_path / "out", device="cpu",
        profile_dir=tmp_path / "trace")
    log = (tmp_path / "out" / "MONORTM.LOG").read_text()
    rows = dict(re.findall(r"^\s+(\S+)\s+[0-9.]+\s+\(x(\d+)\)$",
                           log[log.index(" STAGE TIMING"):], re.M))
    # one chunk of 3 profiles, then the producer's end
    assert rows["queue-wait"] == "2"
    trace = json.loads((tmp_path / "trace" / "monortm_trace.json")
                       .read_text())["traceEvents"]
    ranges = _ranges([e for e in trace if e.get("ph") == "X"])
    build = ranges["model-build"]
    assert len(build) == 1
    for part in BUILD_PARTS:
        assert len(ranges.get(part, ())) == 1, part
        assert _inside(ranges[part][0], build[0]), part
    assert len(ranges["queue-wait"]) == 2
    # the producer thread's stages reach the program's own trace
    producer = {ranges[s][0]["tid"] for s in ("host-prep", "host-stack")}
    assert producer and build[0]["tid"] not in producer
