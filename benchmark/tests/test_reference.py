"""The plain reference against the program's CPU path at float64 on tiny
run directories of both configurations: MONORTM.OUT's Tb and total OD
columns, and the retrieval's loss and gradient by every field."""

import numpy as np
import pytest
import torch

from benchmark.reference import inputs as I
from benchmark.reference.model import FIELDS, Reference
from benchmark.tests.tiny import tiny

SEED = 2_147_483_659


@pytest.mark.parametrize("cell", ["mw_profiles.pipeline",
                                  "envelope.pipeline"])
def test_out_columns_match_the_program(cell, tmp_path):
    from monortm_tpu_torch import pipeline
    from benchmark.gen.rundir import write_pool

    c = tiny(cell)
    pool = write_pool(c.cfg, SEED, 1, 2, tmp_path)
    pipeline.run(filein=pool["tape5"], fileprof=pool["profs"][0],
                 hfile=pool["tape3"], outdir=tmp_path / "out",
                 device="cpu", dtype=torch.float64)
    t5 = I.parse_tape5(pool["tape5"])
    wn = t5["wn"]
    got = I.read_out(tmp_path / "out" / "MONORTM.OUT", len(wn))
    profs = I.parse_profin(pool["profs"][0])
    idx = np.arange(len(wn))
    ref = Reference(pool["lines"], wn, idx, "cpu")
    tb, od = ref.tb(ref.state(profs), profs[0]["nmol"], profs[0]["irt"],
                    t5["tbound"], I.boundary(wn, t5["bndemi"]),
                    I.boundary(wn, t5["bndrfl"]))
    # the printed digits: Tb to 1e-5 K (F11.5), OD to 5 digits (E12.4)
    np.testing.assert_allclose(got["tb"], tb.numpy(), rtol=0, atol=1.1e-5)
    np.testing.assert_allclose(got["total_od"], od.numpy(), rtol=6e-5)
    np.testing.assert_allclose(got["freq"][0], wn * 29.9792458, atol=1e-3)


def test_gradient_matches_the_program(tmp_path):
    from monortm_tpu_torch.convert import state_from_numpy
    from monortm_tpu_torch.io.profin import read_profiles
    from monortm_tpu_torch.io.tape5 import Tape5Reader
    from monortm_tpu_torch.lines import load_catalog
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.types import HostState, LayerState
    from benchmark.gen.rundir import write_pool

    c = tiny("mw_profiles.retrieval")
    pool = write_pool(c.cfg, SEED, 1, 2, tmp_path)
    cfg5 = Tape5Reader(pool["tape5"]).read_block()
    profs = read_profiles(pool["profs"][0])
    model = MonoRTM(cfg5.wn, cfg5.dvset,
                    load_catalog(pool["tape3"], float(cfg5.wn[0]),
                                 float(cfg5.wn[-1]), tile=256),
                    nmol=22, device="cpu", dtype=torch.float64)
    host = HostState(**{f: np.stack([getattr(p.state, f) for p in profs])
                        for f in FIELDS})
    st = state_from_numpy(host, "cpu", torch.float64)
    nwn = len(cfg5.wn)
    obs = torch.linspace(20.0, 280.0, nwn, dtype=torch.float64)
    emis = torch.full((nwn,), 0.95, dtype=torch.float64)
    leaves = {f: getattr(st, f).detach().requires_grad_() for f in FIELDS}
    loss = torch.mean((model.tb(LayerState(**leaves), 288.0, emis,
                                1.0 - emis, irt=3) - obs) ** 2)
    grads = torch.autograd.grad(loss, [leaves[f] for f in FIELDS])

    wn = I.parse_tape5(pool["tape5"])["wn"]
    ref = Reference(pool["lines"], wn, np.arange(nwn), "cpu")
    rp = I.parse_profin(pool["profs"][0])
    rl = {f: v.requires_grad_() for f, v in ref.state(rp).items()}
    tb, _ = ref.tb(rl, 22, 3, 288.0, emis.numpy(), 1.0 - emis.numpy())
    rloss = torch.mean((tb - obs) ** 2)
    rgrads = torch.autograd.grad(rloss, [rl[f] for f in FIELDS])
    loss, rloss = float(loss.detach()), float(rloss.detach())
    assert abs(loss - rloss) <= 1e-9 * rloss
    for f, g, r in zip(FIELDS, grads, rgrads):
        scale = max(float(r.norm()), 1e-300)
        assert float((g - r).norm()) <= 1e-6 * scale, f
