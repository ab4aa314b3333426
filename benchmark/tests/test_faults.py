"""A run with its timed path broken underneath comes out not correct.
Each test drives the rest of a run (benchmark.run.run on the CPU at a
size a test run holds, past the harness's look for a chip) with one fault
the cell can have: an answer altered where it is produced, a step that
returns its state unchanged, half of the batch left out."""

import torch

from benchmark import run as R
from benchmark.tests.tiny import tiny

SEED = 2_147_483_701
PIPELINE_CELLS = ("mw_profiles.pipeline", "envelope.pipeline")


def _driver(c, tmp):
    return R.driver_of(c, SEED, torch.device("cpu"), tmp / c.name)[1]


def _run(c, drv, seconds=0.5):
    return R.run(c, SEED, seconds, False, device="cpu", drv=drv)


def test_sound_runs_are_correct(tmp_path):
    for name in PIPELINE_CELLS + ("mw_profiles.retrieval",):
        c = tiny(name)
        assert _run(c, _driver(c, tmp_path))["correct"], name


def _pipeline_fault(name, wrap, tmp_path):
    c = tiny(name)
    drv = _driver(c, tmp_path)
    setup = drv.setup

    def broken_setup():
        setup()
        drv.run_fn = wrap(drv.run_fn, drv)

    drv.setup = broken_setup
    return _run(c, drv)


def test_pipeline_answer_altered_where_produced(tmp_path):
    from monortm_tpu_torch.models import od

    for name in PIPELINE_CELLS:
        def wrap(run_fn, drv):
            def run(*a, **k):
                call = od.ODModel.__call__

                def altered(self, *aa, **kk):
                    res = call(self, *aa, **kk)
                    res.od_total = res.od_total * 1.2
                    return res
                od.ODModel.__call__ = altered
                try:
                    return run_fn(*a, **k)
                finally:
                    od.ODModel.__call__ = call
            return run
        assert not _pipeline_fault(name, wrap, tmp_path)["correct"], name


def test_pipeline_step_returns_its_state_unchanged(tmp_path):
    def wrap(run_fn, drv):
        def run(*a, fileprof=None, **k):
            return run_fn(*a, fileprof=drv.pool["profs"][0], **k)
        return run
    # every run writes the pool's first directory, whatever it was given
    for name in PIPELINE_CELLS:
        c = tiny(name)
        c.traffic = dict(c.traffic, sample_runs=4)
        drv = _driver(c, tmp_path)
        setup = drv.setup

        def broken_setup(setup=setup, drv=drv):
            setup()
            drv.run_fn = wrap(drv.run_fn, drv)

        drv.setup = broken_setup
        res = _run(c, drv, seconds=3.0)
        assert res["attempted"] >= 3, name
        assert not res["correct"], name


def test_retrieval_step_returns_its_state_unchanged(tmp_path):
    c = tiny("mw_profiles.retrieval")
    drv = _driver(c, tmp_path)
    drv.delta = lambda k, f=drv.delta: f(-1)     # every step at one state
    drv_check = drv.check

    def check(dev, dtype=torch.float64):
        drv.delta = type(drv).delta.__get__(drv)
        return drv_check(dev, dtype)
    drv.check = check
    assert not _run(c, drv)["correct"]


def test_retrieval_half_of_the_batch_left_out(tmp_path):
    c = tiny("mw_profiles.retrieval")
    drv = _driver(c, tmp_path)
    h = c.traffic["profiles"] // 2
    drv.loss = lambda tb: torch.mean((tb[:h] - drv.tb_obs[:h]) ** 2)
    assert not _run(c, drv)["correct"]
