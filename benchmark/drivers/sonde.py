"""Closed loop of `pipeline.run` over stacked radiosonde runs (IATM=1), as
`monortm_tpu_torch.cli.main` calls it: one caller runs the CLI's
pipeline back to back over a pool of MONORTM.IN files drawn from the
seed (benchmark/gen/sonde.py; one shared TAPE3), into one output
directory.  The program layers each '$' block itself (LBLATM), in its
worker pool where the run is large enough.

Traffic parameters as the pipeline driver's (benchmark/drivers/
pipeline.py): profiles_per_run ('$' blocks a file), pool (files), and
for the check sample_runs, sample_profiles and sample_wn.  The check
layers the sampled blocks with the reference's LBLATM
(benchmark/reference/layering.py) and runs the plain reference on those
layers; a run whose MONORTM.OUT holds another number of profiles than
its file has blocks reads as infinitely wide.
"""

from __future__ import annotations

import contextlib
import io
import re

import numpy as np
import torch

from benchmark.drivers import pipeline
from benchmark.gen.sonde import write_sondes
from benchmark.reference import inputs as I
from benchmark.reference import layering as LA
from benchmark.reference.model import Reference

LAYERING = re.compile(r" LAYERING: (\d+) profile\(s\) over (\d+) worker "
                      r"process\(es\), (\d+) chunk\(s\)")


class Driver(pipeline.Driver):
    def inputs(self):
        """Write the pool from the seed."""
        self.pool = write_sondes(self.cfg, self.seed, self.tr["pool"],
                                 self.tr["profiles_per_run"], self.work)

    def step(self, k: int) -> int:
        """One pipeline.run of pool file k mod pool; returns the profiles
        it wrote."""
        i = k % self.tr["pool"]
        with contextlib.redirect_stdout(io.StringIO()):
            res = self.run_fn(
                filein=self.pool["tape5s"][i], hfile=self.pool["tape3"],
                fileout="MONORTM.OUT", outdir=self.out, device=self.dev,
                dtype=getattr(torch, self.cfg["precision"]),
                engine=self.cfg["engine"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if k >= 0:
            o = self.out / f"run{k}.OUT"
            g = self.out / f"run{k}.LOG"
            (self.out / "MONORTM.OUT").rename(o)
            (self.out / "MONORTM.LOG").rename(g)
            self.kept.append((k, i, o, g))
        return len(res.tb)

    def layering(self, steps: int) -> list[tuple]:
        """(profiles, worker processes, chunks) of the LAYERING line of
        each of the first `steps` runs' MONORTM.LOG that has one."""
        out = []
        for *_, g in self.kept[:steps]:
            m = LAYERING.search(g.read_text())
            if m:
                out.append(tuple(int(x) for x in m.groups()))
        return out

    @staticmethod
    def _layers(run: dict, sel) -> list[dict]:
        """The reference's layers of blocks `sel` of a parsed run."""
        return [LA.layer(LA.parse_block(run["blocks"][q])) for q in sel]

    def roofline_inputs(self, steps: int):
        """(TAPE3 records, grid, the reference's layers of every block)
        of each traced run, for the roofline readers."""
        out = []
        for _, i, *_ in self.kept[:steps]:
            run = LA.parse_run(self.pool["tape5s"][i])
            out.append((self.pool["lines"], run["wn"], self._layers(
                run, range(len(run["blocks"])))))
        return out

    def _sample(self):
        rng = np.random.default_rng([self.seed, 0x636865636B])
        run = LA.parse_run(self.pool["tape5s"][0])
        nwn, n = len(run["wn"]), self.tr["sample_wn"]
        if n >= nwn:
            return rng, run, [np.arange(nwn)]
        idx = np.array([rng.integers(s[0], s[-1] + 1) for s in
                        np.array_split(np.arange(nwn), n)])
        k = self.tr["sample_runs"]
        return rng, run, [idx[j::k] for j in range(k)]

    def _tb(self, run, idx, layers, ref_device, dtype):
        """The reference's (Tb, total OD) [B, W] of layered profiles (each
        its own layer count) at the wavenumbers idx, in `dtype`."""
        wn = run["wn"]
        ref = Reference(self.pool["lines"], wn, idx, ref_device, dtype)
        emis = I.boundary(wn[idx], run["bndemi"])
        refl = I.boundary(wn[idx], run["bndrfl"])
        tb, od = [], []
        with torch.no_grad():
            for lay in layers:
                a, b = ref.tb(ref.state([lay]), lay["nmol"], lay["irt"],
                              run["tbound"], emis, refl)
                tb.append(a[0].double().cpu().numpy())
                od.append(b[0].double().cpu().numpy())
        return np.stack(tb), np.stack(od)

    def check(self, ref_device, dtype=torch.float64) -> dict:
        """The widest gaps of the sampled MONORTM.OUT rows from the
        reference: Tb (K) and total OD (relative)."""
        rng, run, share = self._sample()
        runs = rng.choice(len(self.kept), min(self.tr["sample_runs"],
                                              len(self.kept)),
                          replace=False)
        gaps = dict(tb_gap_k=0.0, od_gap_rel=0.0)
        for j, r in enumerate(sorted(runs)):
            _, i, o, _ = self.kept[r]
            idx = share[j % len(share)]
            got = I.read_out(o, len(run["wn"]))
            this = LA.parse_run(self.pool["tape5s"][i])
            n = len(this["blocks"])
            if len(got["tb"]) != n:
                return dict(tb_gap_k=float("inf"), od_gap_rel=float("inf"))
            sel = np.sort(rng.choice(n, min(self.tr["sample_profiles"], n),
                                     replace=False))
            tb, od = self._tb(run, idx, self._layers(this, sel),
                              ref_device, dtype)
            gaps["tb_gap_k"] = max(gaps["tb_gap_k"], pipeline._widest(
                got["tb"][sel][:, idx] - tb))
            gaps["od_gap_rel"] = max(gaps["od_gap_rel"], pipeline._widest(
                (got["total_od"][sel][:, idx] - od) / od))
        return gaps

    def control(self, ref_device, dtype) -> dict:
        """The check with the reference's model, in `dtype`, in the
        program's place (the layering stays float64, as the program's
        does): its Tb and OD against the float64 reference's, at the first
        sampled run's wavenumbers."""
        _, run, share = self._sample()
        layers = self._layers(run, range(min(self.tr["sample_profiles"],
                                             len(run["blocks"]))))
        (tb, od), (tbc, odc) = (self._tb(run, share[0], layers, ref_device,
                                         dt)
                                for dt in (torch.float64, dtype))
        return dict(tb_gap_k=pipeline._widest(tbc - tb),
                    od_gap_rel=pipeline._widest((odc - od) / od))
