"""One torch.profiler window and what the benchmark reads from it.

`Window` wraps the profiler around the first traced steps of a run's
measured window (CPU and CUDA activity; the benchmark's own
`record_function` ranges and the program's stage ranges label the host
side).  `summary()` exports the Chrome trace into a scratch file, reads
it back and returns a `Trace`: every kernel, memcpy and memset interval
on the device, the host ranges, the traced window's bounds, and the
breakdown the result line carries.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "benchmark-window"
NAME_CHARS = 160          # a device operation's name in the breakdown


@dataclass
class Trace:
    window: tuple                      # (start, end) us
    device: list = field(default_factory=list)   # (start, end, name, cat)
    host: list = field(default_factory=list)     # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of device intervals inside the window, sorted."""
        iv = sorted((max(s, self.window[0]), min(e, self.window[1]))
                    for s, e, _, _ in self.device)
        out = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_s(self, match) -> float:
        """Seconds of the kernels whose name `match(name)` accepts."""
        return sum(e - s for s, e, n, c in self.device
                   if c == "kernel" and match(n)) * 1e-6

    def kernels(self) -> int:
        return sum(1 for *_, c in self.device if c == "kernel")

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps by
        the innermost host range open at each gap's middle."""
        ops = {}
        for s, e, n, c in self.device:
            n = n[:NAME_CHARS]
            ops[n] = ops.get(n, 0.0) + (e - s) * 1e-6
        gaps = {}
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + \
            [self.window[1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            inner = [(he - hs, n) for hs, he, n in self.host
                     if hs <= mid <= he and n != WINDOW_RANGE]
            name = min(inner)[1] if inner else "(no host range)"
            gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
        top_of = lambda d: sorted(([k, v] for k, v in d.items()),
                                  key=lambda kv: -kv[1])[:top]
        return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}


class Window:
    """torch.profiler over the traced steps; `stop()` ends it."""

    def __init__(self, scratch: Path):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.path = Path(scratch) / "trace.json"
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rng = torch.profiler.record_function(WINDOW_RANGE)
        self.rng.__enter__()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rng.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self) -> Trace:
        self.prof.export_chrome_trace(str(self.path))
        events = json.loads(self.path.read_text())["traceEvents"]
        os.unlink(self.path)
        dev, host, win = [], [], None
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((s, e, ev.get("name", ""), cat))
            elif cat == "user_annotation":
                if ev.get("name") == WINDOW_RANGE:
                    win = (s, e)
                host.append((s, e, ev.get("name", "")))
        if win is None:
            raise RuntimeError("the trace holds no benchmark window range")
        last = max([e for _, e, _, _ in dev] + [win[1]])
        return Trace(window=(win[0], last), device=dev, host=host)
