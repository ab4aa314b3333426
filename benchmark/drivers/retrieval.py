"""Closed loop of retrieval steps: value_and_grad of mean((Tb - Tb_obs)^2)
through `MonoRTM.tb` by every float field of the layered state, with
`torch.autograd`, as a variational retrieval iterates.

Set-up writes the configuration's files from the seed and builds the
model and the state of the first `profiles` profiles through the
program's own readers (`io.tape5`, `lines.load_catalog`, `io.profin`,
`convert.state_from_numpy`), as `monortm_tpu_torch.envelope.build_model`
does.  Step k moves the state by a seeded amount (each layer's
temperature by N(0, dt_step_k) K at both levels, its H2O column by a
factor 1 + N(0, h2o_step)), takes the program's engine split of that
state and runs value_and_grad.  Tb_obs is seeded data (uniform over
tb_obs_k), handed to both sides.  The boundary: surface tsfc K,
emissivity emis, irt.

The check compares `sample_steps` steps drawn from the seed among all
the window's steps, kept as the window runs by reservoir sampling (so
that the window holds no more answers than it checks).
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.gen.rundir import write_pool
from benchmark.reference import inputs as I
from benchmark.reference.model import FIELDS, Reference


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 work: Path):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)
        self.work = Path(work)
        self.kept = []          # (step, loss, grads) of the sampled steps
        self.pick = np.random.default_rng([seed, 0x636865636B])
        self.tb_fn = None       # the program's Tb of a state
        self.marks = []         # (set-up phase, perf_counter at its end)

    def inputs(self):
        """Write the configuration's files and draw Tb_obs from the seed."""
        tr = self.tr
        self.pool = write_pool(self.cfg, self.seed, 1, tr["profiles"],
                               self.work)
        self.nwn = len(I.parse_tape5(self.pool["tape5"])["wn"])
        nlay = self.cfg["profile"]["nlay"]
        self.shape = (tr["profiles"], nlay)
        rng = np.random.default_rng([self.seed, 0x6F6273])
        self.tb_obs_np = rng.uniform(*tr["tb_obs_k"], (tr["profiles"],
                                                       self.nwn))

    def setup(self):
        from monortm_tpu_torch import pipeline
        from monortm_tpu_torch.convert import state_from_numpy
        from monortm_tpu_torch.io.profin import read_profiles
        from monortm_tpu_torch.io.tape5 import Tape5Reader
        from monortm_tpu_torch.lines import load_catalog
        from monortm_tpu_torch.models.monortm import MonoRTM
        from monortm_tpu_torch.ops.lineshape import LineConfig
        from monortm_tpu_torch.types import HostState, LayerState

        tr = self.tr
        self.inputs()
        self.marks.append(("inputs", time.perf_counter()))
        cfg5 = Tape5Reader(self.pool["tape5"]).read_block()
        profs = read_profiles(self.pool["profs"][0])
        self.model = MonoRTM(
            cfg5.wn, cfg5.dvset,
            load_catalog(self.pool["tape3"], float(cfg5.wn[0]),
                         float(cfg5.wn[-1]), tile=pipeline.LINE_TILE),
            nmol=profs[0].meta.nmol, line_cfg=LineConfig(ibrd=cfg5.ibrd),
            device=self.dev, wn_tile=pipeline.WN_TILE,
            line_tile=pipeline.LINE_TILE)
        host = HostState(**{f: np.stack([getattr(p.state, f)
                                         for p in profs]) for f in FIELDS})
        self.state0 = state_from_numpy(host, self.dev, torch.float32)
        self.layer_state = LayerState
        self.tb_obs = torch.as_tensor(self.tb_obs_np, dtype=torch.float32,
                                      device=self.dev)
        self.emis = torch.full((self.nwn,), tr["emis"], device=self.dev)
        model = self.model

        def tb_fn(st):
            eng, lor = model.engine_split(st)
            return model.tb(st, tr["tsfc"], self.emis, 1.0 - self.emis,
                            irt=tr["irt"], engine=eng, lor_layers=lor)

        self.tb_fn = tb_fn
        self.marks.append(("model", time.perf_counter()))
        self.step(-1)
        self.marks.append(("warm", time.perf_counter()))

    def delta(self, k: int) -> dict:
        """The seeded move of step k: dt [B, L], dtz [B, L + 1], the H2O
        factor [B, L] (float64, host)."""
        rng = np.random.default_rng([self.seed, 0x73746570, k + 1])
        B, L = self.shape
        s = self.tr["dt_step_k"]
        return dict(dt=rng.normal(0.0, s, (B, L)),
                    dtz=rng.normal(0.0, s, (B, L + 1)),
                    h2o=1.0 + rng.normal(0.0, self.tr["h2o_step"], (B, L)))

    def moved(self, base: dict, d: dict, T) -> dict:
        """The state of a step: base fields moved by d (T: to a tensor)."""
        wkl = base["wkl"].clone()
        wkl[..., 0] = wkl[..., 0] * T(d["h2o"])
        return dict(p=base["p"], t=base["t"] + T(d["dt"]),
                    tz=base["tz"] + T(d["dtz"]), wkl=wkl,
                    wbrodl=base["wbrodl"], clw=base["clw"])

    def step(self, k: int) -> int:
        """One value_and_grad; returns the profiles it took."""
        T = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                      device=self.dev)
        base = {f: getattr(self.state0, f) for f in FIELDS}
        with torch.profiler.record_function("step-state"):
            st = self.moved(base, self.delta(k), T)
            leaves = {f: v.detach().requires_grad_() for f, v in st.items()}
        with torch.profiler.record_function("forward"):
            loss = self.loss(self.tb_fn(self.layer_state(**leaves)))
        with torch.profiler.record_function("backward"):
            grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if k >= 0:
            self.keep(k, (k, loss.detach(), [g.detach() for g in grads]))
        return self.shape[0]

    def keep(self, k: int, item):
        """Reservoir sampling of sample_steps of the steps 0..k."""
        n = self.tr["sample_steps"]
        if len(self.kept) < n:
            self.kept.append(item)
        else:
            j = int(self.pick.integers(0, k + 1))
            if j < n:
                self.kept[j] = item

    def loss(self, tb):
        return torch.mean((tb - self.tb_obs) ** 2)

    def free(self):
        """Move the window's answers to the host, drop the model."""
        self.kept = [(k, float(l), [g.double().cpu() for g in gs])
                     for k, l, gs in self.kept]
        self.model = self.tb_fn = self.state0 = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, ref_device, dtype):
        wn = I.parse_tape5(self.pool["tape5"])["wn"]
        ref = Reference(self.pool["lines"], wn, np.arange(len(wn)),
                        ref_device, dtype)
        profs = I.parse_profin(self.pool["profs"][0])
        return ref, ref.state(profs), profs[0]["nmol"]

    def _ref_step(self, ref, base, nmol, k, dtype):
        """Loss and gradients of step k by the reference, in wavenumber
        blocks (the loss is a sum over them)."""
        tr = self.tr
        T = lambda a: torch.as_tensor(a, dtype=dtype, device=ref.dev)
        st = self.moved(base, self.delta(k), T)
        leaves = {f: v.detach().requires_grad_() for f, v in st.items()}
        obs = T(self.tb_obs_np)
        emis = np.full(self.nwn, tr["emis"])
        B, L = base["p"].shape
        blk = max(1, tr["ref_lanes"] // (B * L * ref.lines.n))
        loss = 0.0
        grads = [torch.zeros_like(leaves[f]) for f in FIELDS]
        for s in range(0, self.nwn, blk):
            sel = slice(s, min(s + blk, self.nwn))
            tb, _ = ref.tb(leaves, nmol, tr["irt"], tr["tsfc"], emis,
                           1.0 - emis, sel=sel)
            part = ((tb - obs[:, sel]) ** 2).sum() / (B * self.nwn)
            gs = torch.autograd.grad(part, [leaves[f] for f in FIELDS])
            loss += float(part.detach())
            grads = [a + b for a, b in zip(grads, gs)]
        return loss, [g.double().cpu() for g in grads]

    def check(self, ref_device, dtype=torch.float64) -> dict:
        """Widest gaps over the sampled steps: the loss (relative), and
        the gradient of the worst leaf (`grad_gap`).  The gaps of every
        leaf are left in self.detail."""
        ref, base, nmol = self._reference(ref_device, dtype)
        gaps = dict(loss_gap_rel=0.0, grad_gap_rel=0.0)
        self.detail = {}
        for k, loss, grads in sorted(self.kept, key=lambda x: x[0]):
            rl, rg = self._ref_step(ref, base, nmol, k, dtype)
            gaps["loss_gap_rel"] = max(gaps["loss_gap_rel"],
                                       _nan_wide(abs(loss - rl) / abs(rl)))
            worst, by_leaf = grad_gap(grads, rg)
            gaps["grad_gap_rel"] = max(gaps["grad_gap_rel"], worst)
            for name, v in by_leaf.items():
                self.detail[name] = max(self.detail.get(name, 0.0), v)
        return gaps

    def control(self, ref_device, dtype) -> dict:
        """The reference in `dtype` in the program's place, on one step."""
        ref, base, nmol = self._reference(ref_device, torch.float64)
        rl, rg = self._ref_step(ref, base, nmol, 0, torch.float64)
        refc, basec, _ = self._reference(ref_device, dtype)
        cl, cg = self._ref_step(refc, basec, nmol, 0, dtype)
        worst, self.detail = grad_gap(cg, rg)
        return dict(loss_gap_rel=_nan_wide(abs(cl - rl) / abs(rl)),
                    grad_gap_rel=worst)

    def roofline_inputs(self, steps: int):
        """(TAPE3 records, grid, per-step profiles as dicts) of the traced
        steps, for the roofline readers."""
        wn = I.parse_tape5(self.pool["tape5"])["wn"]
        profs = I.parse_profin(self.pool["profs"][0])
        base = {f: np.stack([p[f] for p in profs]) for f in FIELDS}
        out = []
        for k in range(steps):
            st = self.moved({f: torch.as_tensor(v) for f, v in base.items()},
                            self.delta(k), torch.as_tensor)
            out.append((self.pool["lines"], wn,
                        [dict({f: st[f][b].numpy() for f in FIELDS},
                              nmol=profs[b]["nmol"])
                         for b in range(len(profs))]))
        return out

    def cleanup(self):
        shutil.rmtree(self.work, ignore_errors=True)


def leaves(grads) -> dict:
    """The gradient by leaf: each field of FIELDS, wkl split into one
    leaf per molecule (wkl[m], m from 1)."""
    out = {}
    for f, g in zip(FIELDS, grads):
        if f == "wkl":
            out.update({f"wkl[{m + 1}]": g[..., m]
                        for m in range(g.shape[-1])})
        else:
            out[f] = g
    return out


def grad_gap(got, want) -> tuple:
    """(the worst leaf's gap, {leaf: gap}): a leaf's gap is the norm of
    its difference from the reference's over the reference's norm of
    that leaf.  A leaf whose reference gradient is nought to rounding,
    its norm under a thousandth of the median leaf's, is left out."""
    got, want = leaves(got), leaves(want)
    norms = {k: float(w.norm()) for k, w in want.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    gaps = {k: _nan_wide(float((got[k] - w).norm()) / norms[k])
            for k, w in want.items() if norms[k] > floor}
    return max(gaps.values()), gaps


def _nan_wide(x: float) -> float:
    return float("inf") if x != x else float(x)
