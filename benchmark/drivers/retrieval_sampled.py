"""Closed loop of retrieval steps checked at sampled wavenumbers: the
retrieval driver's timed step, state moves and loss, unchanged, at a
size where a float64 reference of the whole grid does not fit a run.

The timed step is `retrieval.Driver.step`: value_and_grad of
mean((Tb - Tb_obs)^2) over the whole grid.  The grid is cut into
`sample_wn` equal strata and one wavenumber is drawn from each by the
seed, as `drivers/pipeline.py` draws its check's; the step that the
reservoir keeps keeps its Tb too, and the check reads it at the strata.

The reference gradient of the whole-grid loss would take the float64
reference over every (layer, line, wavenumber) lane with autograd, ~3.7e12
of them at the capacity envelope, far past a run's time.  So after the
window, while the model still stands (`free`), the driver makes one more
call of the same model through the same path (the engine split, then
`MonoRTM.tb`) at the kept step's state: value_and_grad of the strata
loss, the mean of (Tb - Tb_obs)^2 over the sampled wavenumbers only (the
forward still runs the whole grid).  The check holds against the float64
reference, computed at the strata only in blocks of `ref_lanes` lanes:

- `tb_gap_k`: the timed step's Tb at the strata (K).  The check call's
  Tb there has to equal it bit for bit, since the line-sum, prologue and
  continuum kernels sum in a fixed order without atomics: any difference
  reads inf.
- `loss_gap_rel`: the strata loss (relative).
- `grad_gap_rel`: the worst leaf of the strata loss's gradient
  (`retrieval.grad_gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import retrieval
from benchmark.drivers.pipeline import _widest
from benchmark.reference import inputs as I
from benchmark.reference.model import FIELDS, Reference


def strata(seed: int, nwn: int, n: int) -> np.ndarray:
    """One wavenumber index drawn from each of n equal strata of a grid
    of nwn (all of them where n >= nwn)."""
    if n >= nwn:
        return np.arange(nwn)
    rng = np.random.default_rng([seed, 0x737472617461])
    return np.array([rng.integers(s[0], s[-1] + 1)
                     for s in np.array_split(np.arange(nwn), n)])


class Driver(retrieval.Driver):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.tb_kept = {}       # step -> its whole-grid Tb (then strata)
        self.strata_run = {}    # step -> the check call's (loss, grads, tb)
        self.call_s = 0.0       # seconds of the check calls

    def inputs(self):
        super().inputs()
        self.idx = strata(self.seed, self.nwn, self.tr["sample_wn"])

    def loss(self, tb):
        self.tb_last = tb.detach()
        return super().loss(tb)

    def keep(self, k: int, item):
        super().keep(k, item)
        self.tb_kept = {s: self.tb_last if s == k else self.tb_kept[s]
                        for s, *_ in self.kept}

    def strata_call(self, k: int):
        """value_and_grad of the strata loss at step k's state, through
        the timed step's path; (loss, grads, Tb at the strata) on the
        host."""
        T = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                      device=self.dev)
        base = {f: getattr(self.state0, f) for f in FIELDS}
        st = self.moved(base, self.delta(k), T)
        leaves = {f: v.detach().requires_grad_() for f, v in st.items()}
        idx = torch.as_tensor(self.idx, device=self.dev)
        tb = self.tb_fn(self.layer_state(**leaves))[:, idx]
        loss = torch.mean((tb - self.tb_obs[:, idx]) ** 2)
        grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS])
        return (float(loss.detach()), [g.double().cpu() for g in grads],
                tb.detach().double().cpu())

    def free(self):
        """The check call of each kept step, then the parent's free."""
        t0 = time.perf_counter()
        for k, *_ in self.kept:
            self.strata_run[k] = self.strata_call(k)
        self.tb_kept = {k: tb[:, torch.as_tensor(self.idx, device=tb.device)]
                        .double().cpu() for k, tb in self.tb_kept.items()}
        self.call_s = time.perf_counter() - t0
        super().free()

    def _reference(self, ref_device, dtype):
        wn = I.parse_tape5(self.pool["tape5"])["wn"]
        ref = Reference(self.pool["lines"], wn, self.idx, ref_device, dtype)
        profs = I.parse_profin(self.pool["profs"][0])
        return ref, ref.state(profs), profs[0]["nmol"]

    def _ref_step(self, ref, base, nmol, k, dtype):
        """(strata loss, its gradients, Tb at the strata) of step k by
        the reference, in blocks of the strata (the loss is a sum over
        them)."""
        tr = self.tr
        T = lambda a: torch.as_tensor(a, dtype=dtype, device=ref.dev)
        st = self.moved(base, self.delta(k), T)
        leaves = {f: v.detach().requires_grad_() for f, v in st.items()}
        obs = T(self.tb_obs_np[:, self.idx])
        n = len(self.idx)
        emis = np.full(n, tr["emis"])
        B, L = base["p"].shape
        blk = max(1, tr["ref_lanes"] // (B * L * ref.lines.n))
        loss, tbs = 0.0, []
        grads = [torch.zeros_like(leaves[f]) for f in FIELDS]
        for s in range(0, n, blk):
            sel = slice(s, min(s + blk, n))
            tb, _ = ref.tb(leaves, nmol, tr["irt"], tr["tsfc"], emis,
                           1.0 - emis, sel=sel)
            part = ((tb - obs[:, sel]) ** 2).sum() / (B * n)
            gs = torch.autograd.grad(part, [leaves[f] for f in FIELDS])
            loss += float(part.detach())
            grads = [a + b for a, b in zip(grads, gs)]
            tbs.append(tb.detach().double().cpu())
        return loss, [g.double().cpu() for g in grads], torch.cat(tbs, 1)

    def check(self, ref_device, dtype=torch.float64) -> dict:
        """Widest gaps over the kept steps; each leaf's gradient gap, the
        check call's largest Tb difference from the timed step's and the
        seconds of the check call and of the reference in self.detail."""
        t0 = time.perf_counter()
        ref, base, nmol = self._reference(ref_device, dtype)
        gaps = dict(tb_gap_k=0.0, loss_gap_rel=0.0, grad_gap_rel=0.0)
        self.detail = {"tb_repeat_k": 0.0}
        for k in sorted(self.strata_run):
            loss, grads, tb = self.strata_run[k]
            rl, rg, rtb = self._ref_step(ref, base, nmol, k, dtype)
            kept = self.tb_kept[k]
            same = torch.equal(kept, tb)
            self.detail["tb_repeat_k"] = max(
                self.detail["tb_repeat_k"], _widest(kept - tb))
            gaps["tb_gap_k"] = max(gaps["tb_gap_k"], _widest(kept - rtb)
                                   if same else float("inf"))
            gaps["loss_gap_rel"] = max(gaps["loss_gap_rel"],
                                       retrieval._nan_wide(abs(loss - rl)
                                                           / abs(rl)))
            worst, by_leaf = retrieval.grad_gap(grads, rg)
            gaps["grad_gap_rel"] = max(gaps["grad_gap_rel"], worst)
            for name, v in by_leaf.items():
                self.detail[name] = max(self.detail.get(name, 0.0), v)
        self.detail.update(check_call_s=self.call_s,
                           reference_s=time.perf_counter() - t0)
        return gaps

    def control(self, ref_device, dtype) -> dict:
        """The reference in `dtype` in the program's place, on step 0."""
        ref, base, nmol = self._reference(ref_device, torch.float64)
        rl, rg, rtb = self._ref_step(ref, base, nmol, 0, torch.float64)
        refc, basec, _ = self._reference(ref_device, dtype)
        cl, cg, ctb = self._ref_step(refc, basec, nmol, 0, dtype)
        worst, self.detail = retrieval.grad_gap(cg, rg)
        return dict(tb_gap_k=_widest(ctb - rtb),
                    loss_gap_rel=retrieval._nan_wide(abs(cl - rl) / abs(rl)),
                    grad_gap_rel=worst)
