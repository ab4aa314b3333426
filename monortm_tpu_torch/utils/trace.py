"""Tracing / profiling hooks (port of `monortm_tpu.utils.trace`).

- `span(name)` — a `torch.profiler.record_function` range while a
  profiler runs, so that its timeline (the clock of the device trace)
  shows a stage by name; while none runs, one flag check and nothing
  else.
- `traced(name, fn, *args)` — `fn(*args)` inside `span(name)`; under
  autograd while a profiler runs, the backward pass of that call is the
  range `<name>.bwd` (its backward twin).
- `StageTimer` — host-side wall-clock accounting per pipeline stage;
  rendered into MONORTM.LOG so every run carries its own timing table
  (a copy of the JAX package's); each stage is also a `span`.
- `profile_trace(dir)` — a `torch.profiler.profile` of the CPU and, where
  there is one, the CUDA activity, written as a Chrome trace into `dir`
  when `dir` is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler runs; a no-op
    context (no range object, no autograd node) otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class _BackwardRange:
    """The `<stage>.bwd` range of one traced call, opened and closed by
    the backward pass (on the thread that runs it)."""

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def open(self):
        if self.rf is None and _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()

    def close(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _Entered(torch.autograd.Function):
    """Made before a stage from its inputs that require grad: returns an
    empty token and hands no gradient back, so the inputs' gradients
    flow and sum exactly as without it.  Created before the stage's
    nodes, it runs after all of them (the engine runs ready nodes latest
    created first), and closes the range."""

    @staticmethod
    def forward(ctx, rng, *inputs):
        ctx.rng, ctx.n = rng, len(inputs)
        ctx.set_materialize_grads(False)
        return inputs[0].new_empty(0)

    @staticmethod
    def backward(ctx, _):
        ctx.rng.close()
        return (None,) * (1 + ctx.n)


class _Left(torch.autograd.Function):
    """A view of one of a stage's outputs: its gradient passes unchanged,
    and the first output gradient to arrive opens the range.  The
    token's gradient (the token itself, empty) keeps `_Entered` on the
    stage's device.  One node per output, so that an output the loss
    does not use brings none of its nodes into the backward pass."""

    @staticmethod
    def forward(ctx, rng, token, output):
        ctx.rng = rng
        ctx.save_for_backward(token)
        ctx.set_materialize_grads(False)
        return output.view_as(output)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.open()
        return None, ctx.saved_tensors[0], grad


def _map(f, x):
    """`x` with `f` applied to each tensor of its nest of tuples (named
    ones too), lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(f, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(f, v) for v in x)
    if isinstance(x, dict):
        return {k: _map(f, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            fl.name: _map(f, getattr(x, fl.name))
            for fl in dataclasses.fields(x)})
    return x


def traced(name: str, fn, *args):
    """`fn(*args)` inside `span(name)`.

    While a profiler runs and some tensor of `args` requires grad, the
    stage gets a backward twin: the range `<name>.bwd` opens when its
    outputs receive their gradient and closes when the stage's backward
    has given its inputs theirs.  The twin adds no kernel and moves no
    bit: the outputs are views whose gradients pass unchanged, and no
    input gradient passes through it.  While no profiler runs this is
    `fn(*args)` after one flag check."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with torch.profiler.record_function(name):
        ins = []
        if torch.is_grad_enabled():
            _map(lambda t: t.requires_grad and ins.append(t), args)
        if not ins:
            return fn(*args)
        rng = _BackwardRange(name + ".bwd")
        token = _Entered.apply(rng, *ins)
        views = {}

        def left(t):
            if t.requires_grad and id(t) not in views:
                views[id(t)] = _Left.apply(rng, token, t)
            return views.get(id(t), t)

        return _map(left, fn(*args))


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Profiler trace (Chrome trace JSON in log_dir) when log_dir is set."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                profile)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    # every thread's ranges, the pipeline's producer thread's too (a
    # profiler otherwise records the ranges of the thread that started it)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "monortm_trace.json"))


class StageTimer:
    """Accumulates wall time per named stage; repeated stages sum.  Each
    stage is a `span` as well."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        if not self.totals:
            return ""
        width = max(len(k) for k in self.totals)
        lines = [" STAGE TIMING (wall seconds)"]
        for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"   {k:<{width}s} {v:10.3f}  (x{self.counts[k]})")
        return "\n".join(lines) + "\n"
