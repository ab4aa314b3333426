"""The plain reference: MonoRTM's forward model composed from the
reference's parts (lines, continuum, cloud, RT) in plain PyTorch.

It takes what both sides are given, the generated TAPE3 records and the
run's MONORTM.IN grid, and a layered state as tensors, and computes the
total layer OD and Tb at any subset of the grid, differentiable in every
float field of the state.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.continuum import Continuum
from benchmark.reference.lines import LineOD, catalog
from benchmark.reference.rt import cloud_od, rtm

FIELDS = ("p", "t", "tz", "wkl", "wbrodl", "clw")


class Reference:
    """MonoRTM at wavenumbers wn[idx] of a run whose grid is wn.
    raw: the TAPE3 records (gen.lines' dict); device, dtype: where and in
    what precision it computes (float64 for the reference, bfloat16 for
    its control)."""

    def __init__(self, raw: dict, wn, idx, device, dtype=torch.float64):
        wn = np.asarray(wn, np.float64)
        self.idx = np.asarray(idx)
        self.dev, self.dt = torch.device(device), dtype
        self.lines = LineOD(catalog(raw, float(wn[0]), float(wn[-1])),
                            device, dtype)
        self.cont = Continuum(wn[self.idx], float(wn[0]), float(wn[-1]),
                              device, dtype)
        self.wn = torch.as_tensor(wn[self.idx], dtype=dtype, device=device)

    def state(self, profiles: list[dict]) -> dict:
        """The state tensors [B, ...] of parsed profiles (inputs.py)."""
        return {f: torch.as_tensor(np.stack([p[f] for p in profiles]),
                                   dtype=self.dt, device=self.dev)
                for f in FIELDS}

    def od(self, st: dict, nmol: int, sel=slice(None),
           lane_budget: int = 1 << 24):
        """Total layer OD [B, W, L] at the wavenumbers sel of wn[idx]."""
        B, L = st["p"].shape
        rows = {f: st[f].reshape(B * L, *st[f].shape[2:])
                for f in ("p", "t", "wkl", "wbrodl", "clw")}
        wn = self.wn[sel]
        pr = self.lines.params(rows["p"], rows["t"], rows["wkl"],
                               rows["wbrodl"])
        o = self.lines.od(pr, wn, lane_budget)
        o = o + self.cont.od(rows["p"], rows["t"], rows["wkl"],
                             rows["wbrodl"], nmol)[:, sel]
        o = o + cloud_od(wn, rows["t"], rows["clw"])
        return o.reshape(B, L, -1).transpose(1, 2)

    def tb(self, st: dict, nmol: int, irt: int, tsfc, emis, refl,
           sel=slice(None), lane_budget: int = 1 << 24):
        """(Tb [B, W], total OD [B, W]) at the wavenumbers sel; emis and
        refl [W] of wn[idx]."""
        o = self.od(st, nmol, sel, lane_budget)
        emis = torch.as_tensor(emis, dtype=self.dt, device=self.dev)[sel]
        refl = torch.as_tensor(refl, dtype=self.dt, device=self.dev)[sel]
        _, tb = rtm(o, st["t"], st["tz"], self.wn[sel], tsfc, emis, refl,
                    irt)
        return tb, o.sum(-1)
