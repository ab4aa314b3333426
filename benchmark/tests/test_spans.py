"""The readers of the program's own spans and stages, fed hand-built
traces: each returns the time its spans cover per traced step, a span
nested in itself (or two of its names overlapping) counting once, and
None where the program has no such span or stage."""

from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark.devtrace import WINDOW_RANGE, Trace

GRAD = ("engine_split_ms.grad", "lines_ms.grad", "continuum_ms.grad",
        "od_sum_ms.grad", "rt_ms.grad")
SPANS = {"engine_split_ms.grad": ("engine-split", None),
         "lines_ms.grad": ("lines", "lines.bwd"),
         "continuum_ms.grad": ("continuum", "continuum.bwd"),
         "od_sum_ms.grad": ("od-sum", "od-sum.bwd"),
         "rt_ms.grad": ("rt", "rt.bwd")}


class Stages:
    def __init__(self, tables):
        self.tables = tables

    def stages(self, steps):
        return self.tables[:steps]


def ctx(host, steps=2, tables=()):
    """A traced window of 0-10 s (us) holding the host ranges `host`."""
    tr = Trace(window=(0.0, 1e7), device=[(0.0, 1.0, "k", "kernel")],
               host=[(0.0, 1e7, WINDOW_RANGE),
                     (0.0, 4e6, "forward"), (4e6, 1e7, "backward")]
               + list(host))
    return SimpleNamespace(trace=tr, steps=steps, driver=Stages(
        list(tables)), ref_device="cpu")


@pytest.mark.parametrize("metric", GRAD)
def test_a_retrieval_stage_reads_its_span_and_backward_twin(metric):
    fwd, bwd = SPANS[metric]
    # step 1: 1.0 ms forward, 3.0 ms backward of which 2.0 ms nested in
    # a second range of the same name; step 2: 0.5 ms forward
    host = [(100.0, 1100.0, fwd), (5000.0, 8000.0, bwd or fwd),
            (5500.0, 7500.0, bwd or fwd), (20000.0, 20500.0, fwd),
            (30000.0, 90000.0, "other-stage")]
    assert R.reader(metric)(ctx(host)) == pytest.approx(
        (1.0 + 3.0 + 0.5) / 2)
    assert R.reader(metric)(ctx(host[-1:])) is None


def test_forward_and_backward_ranges_that_overlap_count_once():
    host = [(0.0, 4000.0, "lines"), (3000.0, 6000.0, "lines.bwd")]
    assert R.reader("lines_ms.grad")(ctx(host, steps=1)) == \
        pytest.approx(6.0)


def test_plan_build_reads_seconds_per_traced_run():
    host = [(1e6, 1.5e6, "model-build"), (1.1e6, 1.4e6, "model-build.plan"),
            (6e6, 6.5e6, "model-build"), (6.1e6, 6.2e6, "model-build.plan"),
            (1.4e6, 1.45e6, "model-build.upload")]
    read = R.reader("plan_build_s.capacity")
    assert read(ctx(host)) == pytest.approx((0.3 + 0.1) / 2)
    assert read(ctx(host[:1] + host[2:3] + host[-1:])) is None


def test_queue_wait_reads_the_stage_timing_row():
    read = R.reader("queue_wait_s")
    tables = [{"host-prep": 0.2, "queue-wait": 0.12},
              {"host-prep": 0.2, "queue-wait": 0.08},
              {"queue-wait": 5.0}]
    assert read(ctx((), steps=2, tables=tables)) == pytest.approx(0.1)
    # the parent's LOG has no such row, and a run without a LOG no table
    assert read(ctx((), tables=[{"host-prep": 0.2}] * 2)) is None
    assert read(ctx(())) is None


def test_every_new_reader_is_declared_for_its_cells():
    import json
    bench = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    cells = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    for m in GRAD:
        assert cells[m] == ["mw_profiles.retrieval"]
    assert cells["queue_wait_s"] == ["mw_profiles.pipeline"]
    assert cells["plan_build_s.capacity"] == ["envelope.pipeline"]
