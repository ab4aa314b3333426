"""Closed loop of `pipeline.run`, as `monortm_tpu_torch.cli.main` calls
it: one caller runs the CLI's pipeline back to back over a pool of run
directories drawn from the seed (the shared MONORTM.IN and TAPE3, one
MONORTM_PROF.IN each), into one output directory.

Traffic parameters (benchmark/traffic/<mix>.json): profiles_per_run,
pool (run directories), and for the check sample_runs, sample_profiles
and sample_wn, drawn from the seed among what the window wrote.  The
grid is cut into sample_wn equal strata and one wavenumber is drawn from
each; the sampled runs share the strata out in turn, and where there are
as many strata as wavenumbers every sampled run checks them all.
"""

from __future__ import annotations

import contextlib
import io
import re
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.gen.lines import n_lines
from benchmark.gen.rundir import write_pool
from benchmark.reference import inputs as I
from benchmark.reference.model import Reference

HOST_STAGES = ("tape5-parse", "line-catalog", "profiles+layering",
               "host-prep", "host-stack")
DEVICE_STAGES = ("model-build", "host->device", "engine-predicate",
                 "device-dispatch", "device->host")


def stage_table(log: str) -> dict:
    """MONORTM.LOG's STAGE TIMING: {stage: seconds}."""
    out = {}
    if " STAGE TIMING" in log:
        for ln in log[log.index(" STAGE TIMING"):].splitlines()[1:]:
            m = re.match(r"\s+(\S+)\s+([0-9.]+)\s+\(x\d+\)", ln)
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 work: Path):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)
        self.work = Path(work)
        self.out = self.work / "out"
        self.kept = []          # (step, pool index, OUT path, LOG path)
        self.marks = []         # (set-up phase, perf_counter at its end)

    def inputs(self):
        """Write the pool from the seed."""
        self.pool = write_pool(self.cfg, self.seed, self.tr["pool"],
                               self.tr["profiles_per_run"], self.work)

    def setup(self):
        """Write the pool and run its first directory once (the kernels'
        build, the native helper's and every shape of the window); check
        that the program read every generated line."""
        from monortm_tpu_torch import pipeline
        self.run_fn = pipeline.run
        self.inputs()
        self.marks.append(("inputs", time.perf_counter()))
        self.step(-1)
        self.marks.append(("warm", time.perf_counter()))
        log = (self.out / "MONORTM.LOG").read_text()
        got = int(log.split("TOTAL NUMBER OF LINES =")[1].split()[0])
        want = n_lines(self.pool["lines"])
        if got != want:
            raise RuntimeError(f"the program read {got} lines of the "
                               f"{want} generated")

    def step(self, k: int) -> int:
        """One pipeline.run of pool directory k mod pool; returns the
        profiles it wrote."""
        i = k % self.tr["pool"]
        with contextlib.redirect_stdout(io.StringIO()):
            res = self.run_fn(
                filein=self.pool["tape5"], fileprof=self.pool["profs"][i],
                hfile=self.pool["tape3"], fileout="MONORTM.OUT",
                outdir=self.out, device=self.dev,
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

    def stages(self, steps: int) -> list[dict]:
        """STAGE TIMING of the first `steps` runs of the window."""
        return [stage_table(g.read_text()) for *_, g in self.kept[:steps]]

    def free(self):
        """Release what the program holds on the device."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def roofline_inputs(self, steps: int):
        """(TAPE3 records, grid, parsed profiles) of each traced run, for
        the roofline readers."""
        wn = I.parse_tape5(self.pool["tape5"])["wn"]
        return [(self.pool["lines"], wn,
                 I.parse_profin(self.pool["profs"][i]))
                for _, i, *_ in self.kept[:steps]]

    def _sample(self):
        """The seed's draw for the check: (rng, MONORTM.IN's records, the
        wavenumber indices of each sampled run in turn)."""
        rng = np.random.default_rng([self.seed, 0x636865636B])
        t5 = I.parse_tape5(self.pool["tape5"])
        nwn, n = len(t5["wn"]), self.tr["sample_wn"]
        if n >= nwn:
            return rng, t5, [np.arange(nwn)]
        idx = np.array([rng.integers(s[0], s[-1] + 1) for s in
                        np.array_split(np.arange(nwn), n)])
        k = self.tr["sample_runs"]
        return rng, t5, [idx[j::k] for j in range(k)]

    def _tb(self, t5, idx, profs, ref_device, dtype):
        """The reference's (Tb, total OD) [B, W] of parsed profiles at
        the wavenumbers idx, in `dtype`."""
        wn = t5["wn"]
        ref = Reference(self.pool["lines"], wn, idx, ref_device, dtype)
        with torch.no_grad():
            tb, od = ref.tb(ref.state(profs), profs[0]["nmol"],
                            profs[0]["irt"], t5["tbound"],
                            I.boundary(wn[idx], t5["bndemi"]),
                            I.boundary(wn[idx], t5["bndrfl"]))
        return tb.double().cpu().numpy(), od.double().cpu().numpy()

    def check(self, ref_device, dtype=torch.float64) -> dict:
        """The widest gaps of the sampled MONORTM.OUT rows from the
        reference: Tb (K) and total OD (relative)."""
        rng, t5, share = self._sample()
        runs = rng.choice(len(self.kept), min(self.tr["sample_runs"],
                                              len(self.kept)),
                          replace=False)
        gaps = dict(tb_gap_k=0.0, od_gap_rel=0.0)
        for j, r in enumerate(sorted(runs)):
            _, i, o, _ = self.kept[r]
            idx = share[j % len(share)]
            got = I.read_out(o, len(t5["wn"]))
            profs = I.parse_profin(self.pool["profs"][i])
            sel = np.sort(rng.choice(len(profs), min(
                self.tr["sample_profiles"], len(profs)), replace=False))
            tb, od = self._tb(t5, idx, [profs[q] for q in sel], ref_device,
                              dtype)
            gaps["tb_gap_k"] = max(gaps["tb_gap_k"], _widest(
                got["tb"][sel][:, idx] - tb))
            gaps["od_gap_rel"] = max(gaps["od_gap_rel"], _widest(
                (got["total_od"][sel][:, idx] - od) / od))
        return gaps

    def control(self, ref_device, dtype) -> dict:
        """The check with the reference, in `dtype`, in the program's
        place: its Tb and OD against the float64 reference's, at the
        first sampled run's wavenumbers."""
        _, t5, share = self._sample()
        profs = I.parse_profin(self.pool["profs"][0])
        profs = profs[:self.tr["sample_profiles"]]
        (tb, od), (tbc, odc) = (self._tb(t5, share[0], profs, ref_device, dt)
                                for dt in (torch.float64, dtype))
        return dict(tb_gap_k=_widest(tbc - tb),
                    od_gap_rel=_widest((odc - od) / od))

    def cleanup(self):
        shutil.rmtree(self.work, ignore_errors=True)


def _widest(d) -> float:
    """max |d|, a NaN counting as infinitely wide."""
    d = np.abs(np.asarray(d, np.float64))
    return float("inf") if np.isnan(d).any() else float(d.max())
