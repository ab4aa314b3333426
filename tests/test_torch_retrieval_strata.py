"""The capacity retrieval cell's sampled check
(`benchmark/drivers/retrieval_sampled.py`) against the quantity its
timed step computes, on the CPU at a size where the engine split puts
layers on both engines, with as many strata as wavenumbers:

- float32, as the cell runs: the check call's strata loss and gradient
  equal the timed step's loss and gradient to 1e-6 of each leaf's norm,
  its Tb equals the step's bit for bit, and both are within the cell's
  limits of the float64 plain reference (`benchmark/reference/`);
- float64 (the dense engine, the model and state built in float64): both
  agree with that reference at `benchmark/tests/test_reference.py`'s
  tolerances, the loss to 1e-9 and each field's gradient to 1e-6 of its
  norm.  The state moves are rounded to float32 on both sides there, as
  the timed step hands them to the model in float32.
"""

import functools

import numpy as np
import pytest
import torch

from benchmark.drivers import retrieval
from benchmark.drivers.retrieval_sampled import Driver
from benchmark.reference.model import FIELDS
from benchmark.tests.tiny import tiny

SEED = 2_147_483_701


def _driver(tmp_path):
    c = tiny("envelope.retrieval")
    c.traffic = dict(c.traffic, sample_wn=c.cfg["grid"]["nwn"])
    return c, Driver(c.cfg, c.traffic, SEED, "cpu", tmp_path / "cell")


def _step_and_call(drv, k=0):
    """The timed step k and the check call at its state: ((loss, grads,
    whole-grid Tb), (loss, grads, Tb at the strata))."""
    drv.step(k)
    (_, loss, grads), = drv.kept
    tb = drv.tb_last.double()
    return (float(loss), [g.double() for g in grads], tb), \
        drv.strata_call(k)


def _state(drv, k):
    T = lambda a: torch.as_tensor(a, dtype=drv.state0.p.dtype)
    return drv.layer_state(**drv.moved(
        {f: getattr(drv.state0, f) for f in FIELDS}, drv.delta(k), T))


def test_float32_strata_call_is_the_timed_step(tmp_path):
    c, drv = _driver(tmp_path)
    try:
        drv.setup()
        eng, lor = drv.model.engine_split(_state(drv, 0))
        assert eng == "hybrid" and 0 < len(lor) < c.cfg["profile"]["nlay"]
        assert np.array_equal(drv.idx, np.arange(drv.nwn))
        (loss, grads, tb), (sl, sg, stb) = _step_and_call(drv)
        assert torch.equal(tb, stb)
        assert abs(sl - loss) <= 1e-6 * abs(loss)
        for name, g in retrieval.leaves(grads).items():
            s = retrieval.leaves(sg)[name]
            assert float((s - g).norm()) <= 1e-6 * float(g.norm()), name
        ref, base, nmol = drv._reference("cpu", torch.float64)
        rl, rg, rtb = drv._ref_step(ref, base, nmol, 0, torch.float64)
        lim = {k: v["limit"] for k, v in c.limits.items()}
        assert float((stb - rtb).abs().max()) <= lim["tb_gap_k"]
        for got in (loss, sl):
            assert abs(got - rl) <= lim["loss_gap_rel"] * abs(rl)
        for got in (grads, sg):
            assert retrieval.grad_gap(got, rg)[0] <= lim["grad_gap_rel"]
    finally:
        drv.cleanup()


def test_float64_step_and_strata_call_match_the_reference(tmp_path,
                                                          monkeypatch):
    from monortm_tpu_torch import convert
    from monortm_tpu_torch.models import monortm

    f64 = torch.float64
    monkeypatch.setattr(monortm, "MonoRTM",
                        functools.partial(monortm.MonoRTM, dtype=f64))
    monkeypatch.setattr(convert, "state_from_numpy", functools.partial(
        lambda host, dev, dtype, f: f(host, dev, f64),
        f=convert.state_from_numpy))
    c, drv = _driver(tmp_path)
    delta = drv.delta
    drv.delta = lambda k: {n: v.astype(np.float32).astype(np.float64)
                           for n, v in delta(k).items()}
    try:
        drv.setup()
        assert drv.model.dtype == f64 and drv.state0.p.dtype == f64
        drv.tb_obs = torch.as_tensor(drv.tb_obs_np, dtype=f64)
        drv.emis = drv.emis.to(f64)
        (loss, grads, _), (sl, sg, stb) = _step_and_call(drv)
        ref, base, nmol = drv._reference("cpu", f64)
        rl, rg, rtb = drv._ref_step(ref, base, nmol, 0, f64)
        np.testing.assert_allclose(stb.numpy(), rtb.numpy(), rtol=0,
                                   atol=1.1e-5)
        for got, gs in ((loss, grads), (sl, sg)):
            assert abs(got - rl) <= 1e-9 * abs(rl)
            for f, g, r in zip(FIELDS, gs, rg):
                scale = max(float(r.norm()), 1e-300)
                assert float((g - r).norm()) <= 1e-6 * scale, f
    finally:
        drv.cleanup()


@pytest.mark.parametrize("n", [1, 7, 640])
def test_the_strata_draw_one_wavenumber_each(n):
    from benchmark.drivers.retrieval_sampled import strata

    nwn = 80000 if n == 640 else 24
    idx = strata(SEED, nwn, n)
    bounds = np.array_split(np.arange(nwn), n)
    assert len(idx) == n
    assert all(b[0] <= i <= b[-1] for i, b in zip(idx, bounds))
    assert np.array_equal(idx, strata(SEED, nwn, n))
