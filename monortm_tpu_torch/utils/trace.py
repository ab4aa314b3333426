"""Tracing / profiling hooks (port of `monortm_tpu.utils.trace`).

- `named_scope(name)` — `torch.profiler.record_function`, so profiler
  timelines show pipeline stages by name.
- `StageTimer` — host-side wall-clock accounting per pipeline stage;
  rendered into MONORTM.LOG so every run carries its own timing table
  (a copy of the JAX package's).
- `profile_trace(dir)` — a `torch.profiler.profile` of the CPU and, where
  there is one, the CUDA activity, written as a Chrome trace into `dir`
  when `dir` is set.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path


def named_scope(name: str):
    """A profiler range named `name` (free when no profiler runs)."""
    import torch
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Profiler trace (Chrome trace JSON in log_dir) when log_dir is set."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "monortm_trace.json"))


class StageTimer:
    """Accumulates wall time per named stage; repeated stages sum."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with named_scope(name):
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
