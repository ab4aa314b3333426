"""The capacity retrieval cell (`envelope.retrieval`, driver
`drivers/retrieval_sampled.py`) at a size a test run holds: a sound run
comes out correct; each fault, injected where its answer is produced,
comes out not correct: one leaf of the check call's gradient off by
twice its limit, the kept Tb shifted by 0.2 K, the check call made at
the next step's state, the check call's gradient zeroed on the
all-Lorentz engine's layers; and the control comes out not correct."""

import torch

from benchmark import control as C
from benchmark import run as R
from benchmark.reference.model import FIELDS
from benchmark.tests.tiny import tiny

CELL = "envelope.retrieval"
SEED = 2_147_483_701


def _run(tmp_path, fault=None, seconds=0.5):
    """A run of the tiny cell; fault(drv) breaks its driver first."""
    c = tiny(CELL)
    drv = R.driver_of(c, SEED, torch.device("cpu"), tmp_path / CELL)[1]
    if fault is not None:
        fault(drv)
    return R.run(c, SEED, seconds, False, device="cpu", drv=drv)


def _wrap_call(drv, alter):
    """The check call's (loss, grads, tb) passed through alter(drv, k,
    answer)."""
    call = drv.strata_call
    drv.strata_call = lambda k: alter(drv, k, call(k))


def test_a_sound_run_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res["correct"] and res["attempted"] >= 1, res["checks"]
    assert res["detail"]["tb_repeat_k"] == 0.0


def test_one_leaf_of_the_gradient_scaled(tmp_path):
    # off by twice the limit: the limit sits at the geometric mean of the
    # program's widest reading and the control's least, far above 1e-3
    scale = 1.0 + 2.0 * tiny(CELL).limits["grad_gap_rel"]["limit"]

    def alter(drv, k, ans):
        loss, grads, tb = ans
        i = FIELDS.index("t")
        return loss, [g * scale if j == i else g
                      for j, g in enumerate(grads)], tb
    res = _run(tmp_path, lambda drv: _wrap_call(drv, alter))
    assert not res["correct"], res["checks"]


def test_the_kept_tb_shifted(tmp_path):
    def fault(drv):
        keep = drv.keep

        def shifted(k, item):
            drv.tb_last = drv.tb_last + 0.2
            keep(k, item)
        drv.keep = shifted
    res = _run(tmp_path, fault)
    assert not res["correct"], res["checks"]
    assert res["detail"]["tb_repeat_k"] > 0.1


def test_the_check_call_at_the_next_step(tmp_path):
    call = lambda drv: _wrap_call(
        drv, lambda d, k, ans: type(d).strata_call(d, k + 1))
    res = _run(tmp_path, call)
    assert not res["correct"], res["checks"]


def test_the_gradient_zeroed_on_the_all_lorentz_layers(tmp_path):
    def alter(drv, k, ans):
        loss, grads, tb = ans
        T = lambda a: torch.as_tensor(a, dtype=torch.float32)
        st = drv.moved({f: getattr(drv.state0, f) for f in FIELDS},
                       drv.delta(k), T)
        eng, lor = drv.model.engine_split(drv.layer_state(**st))
        assert eng == "hybrid" and lor, eng
        out = []
        for f, g in zip(FIELDS, grads):
            g = g.clone()
            if f != "tz":
                g[:, list(lor)] = 0.0
            out.append(g)
        return loss, out, tb
    res = _run(tmp_path, lambda drv: _wrap_call(drv, alter))
    assert not res["correct"], res["checks"]


def test_the_control_fails(tmp_path):
    # here its Tb and loss fail; at the cell's size its gradient too
    c = tiny(CELL)
    dtype = getattr(torch, C.BELOW[c.cfg["precision"]])
    gaps, _ = C.control(c, SEED, dtype, "cpu", tmp_path)
    ok, rows = R.judge(gaps, c.limits)
    assert not ok, rows
    assert all(v > lim for k, v, lim in rows if k != "grad_gap_rel"), rows

