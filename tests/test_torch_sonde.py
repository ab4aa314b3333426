"""Stacked radiosonde runs (IATM=1, MODEL=0, upstream example case 3's
layout) through the port on the CPU.

- The benchmark's reference LBLATM (`benchmark/reference/layering.py`,
  plain PyTorch float64, written from lblatm.f90's equations) layers the
  generator's sondes (`benchmark/gen/sonde.py`) as the port's `atmpth`
  does: mean P and T, the 7 amounts and WBRODL of every layer.
- `pipeline.run(device="cpu")` on a 4-sonde stacked file with several
  layer counts writes the Tb and total OD of the reference chain (its
  layering, then `benchmark/reference/model.py`).
- A pooled IATM=1 run logs its LAYERING line (profiles, worker
  processes, chunks) and times the pool's start as `layering.pool`
  inside `profiles+layering`; a serial one logs the line without the
  stage; an IATM=0 run's STAGE TIMING keeps its names and has no
  LAYERING line.
"""

import json
import re

import numpy as np
import pytest
import torch

from benchmark.gen.sonde import write_sondes
from benchmark.reference import inputs as I
from benchmark.reference import layering as LA
from benchmark.reference.model import Reference
from benchmark.run import ROOT
from monortm_tpu_torch.atmos.tape5_atm import atmpth
from monortm_tpu_torch.io.tape5 import Tape5Reader
from monortm_tpu_torch.pipeline import run
from monortm_tpu_torch.testing import make_minimal_rundir

CFG = json.loads((ROOT / "benchmark" / "configs" / "mw_sonde.json")
                 .read_text())
SEED = 2_147_483_659
IATM0_STAGES = {"tape5-parse", "line-catalog", "profiles+layering",
                "host-prep", "host-stack", "queue-wait", "model-build",
                "host->device", "engine-predicate", "device-dispatch",
                "device->host", "output"}


def _cfg(nwn=None, nlay=None):
    """The configuration, its grid cut to nwn wavenumbers over the same
    band and its boundary grid to nlay layers."""
    cfg = json.loads(json.dumps(CFG))
    if nwn:
        g = cfg["grid"]
        cfg["grid"] = dict(g, nwn=nwn, dvset=round(
            g["dvset"] * (g["nwn"] - 1) / (nwn - 1), 4))
    if nlay:
        cfg["profile"]["nlay"] = nlay
    return cfg


def _stages(log: str) -> dict:
    out = {}
    for ln in log[log.index(" STAGE TIMING"):].splitlines()[1:]:
        m = re.match(r"\s+(\S+)\s+([0-9.]+)\s+\(x(\d+)\)", ln)
        out[m.group(1)] = int(m.group(3))
    return out


@pytest.mark.parametrize("seed", [SEED, 3_000_000_019])
def test_reference_layering_matches_the_ports_atmpth(seed, tmp_path):
    pool = write_sondes(_cfg(), seed, 1, 3, tmp_path)
    blocks = LA.parse_run(pool["tape5s"][0])["blocks"]
    rd = Tape5Reader(pool["tape5s"][0])
    nlays = set()
    for blk in blocks:
        b5 = rd.read_block()
        port = atmpth(b5.rest, b5.v1, b5.v2)
        ref = LA.layer(LA.parse_block(blk))
        st = port.state
        nlays.add(len(st.p))
        assert len(ref["p"]) == len(st.p)
        # both float64; the port's path length is a difference of radii
        # near 6371 km (ALAYER's x = -r cos), which keeps ~11 digits of a
        # 0.1 km step: 6e-12 of every amount seen
        for got, want in ((ref["p"], st.p), (ref["t"], st.t),
                          (ref["tz"], st.tz), (ref["wbrodl"], st.wbrodl),
                          (ref["wkl"][:, :7], st.wkl[:, :7]),
                          (ref["pz"], port.meta.pz),
                          (ref["altz"], port.meta.altz)):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
        assert not st.wkl[:, 7:].any() and not ref["wkl"][:, 7:].any()
    assert len(nlays) >= 2          # two burst heights at least


def test_stacked_run_matches_the_reference_chain(tmp_path):
    pool = write_sondes(_cfg(nwn=24), SEED, 1, 4, tmp_path)
    res = run(filein=pool["tape5s"][0], hfile=pool["tape3"],
              outdir=tmp_path / "out", device="cpu", dtype=torch.float64,
              workers=1)
    r5 = LA.parse_run(pool["tape5s"][0])
    wn = r5["wn"]
    layers = [LA.layer(LA.parse_block(b)) for b in r5["blocks"]]
    assert len({len(x["p"]) for x in layers}) >= 2
    assert len(res.engines) == len({len(x["p"]) for x in layers})
    got = I.read_out(tmp_path / "out" / "MONORTM.OUT", len(wn))
    ref = Reference(pool["lines"], wn, np.arange(len(wn)), "cpu")
    for q, lay in enumerate(layers):
        tb, od = ref.tb(ref.state([lay]), 7, 3, r5["tbound"],
                        I.boundary(wn, r5["bndemi"]),
                        I.boundary(wn, r5["bndrfl"]))
        # the printed digits: Tb to 1e-5 K (F11.5), OD to 5 digits (E12.4)
        np.testing.assert_allclose(got["tb"][q], tb[0].numpy(), rtol=0,
                                   atol=1.1e-5)
        np.testing.assert_allclose(got["total_od"][q], od[0].numpy(),
                                   rtol=6e-5)


@pytest.mark.parametrize("workers", [2, 1])
def test_layering_line_and_pool_stage(workers, tmp_path):
    pool = write_sondes(_cfg(nwn=8, nlay=6), SEED, 1, 5, tmp_path)
    res = run(filein=pool["tape5s"][0], hfile=pool["tape3"],
              outdir=tmp_path / "out", device="cpu", workers=workers)
    log = (tmp_path / "out" / "MONORTM.LOG").read_text()
    chunks = len({len(s["zbnd"]) for s in pool["sondes"][0]})
    assert chunks >= 2 and len(res.engines) == chunks
    assert f" LAYERING: 5 profile(s) over {workers} worker process(es), " \
           f"{chunks} chunk(s)\n" in log
    stages = _stages(log)
    assert stages["profiles+layering"] == 6     # 5 profiles and the end
    assert stages.get("layering.pool") == (1 if workers > 1 else None)


def test_iatm0_stage_names_are_kept(tmp_path):
    make_minimal_rundir(tmp_path, nprof=2)
    run(filein=tmp_path / "MONORTM.IN", fileprof=tmp_path / "MONORTM_PROF.IN",
        hfile=tmp_path / "TAPE3", outdir=tmp_path / "out", device="cpu")
    log = (tmp_path / "out" / "MONORTM.LOG").read_text()
    assert set(_stages(log)) == IATM0_STAGES
    assert "LAYERING" not in log
