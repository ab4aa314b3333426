"""The roofline's lanes are counted from the inputs: at a tiny size they
equal a brute-force enumeration of the (layer, line, wavenumber) lanes
the reference's rules evaluate, by class; at chip_smoke.py's phase 4
bench inputs the operations sit at or below the count chip_smoke.py
makes on the program's own plan."""

import numpy as np
import pytest
import torch

from benchmark.gen.lines import synthetic_lines
from benchmark.gen.profiles import profiles
from benchmark.reference.lines import LineOD, catalog
from benchmark.roofline import ops as O
from benchmark.roofline.lanes import N_CLASSES, count, line_class


def _rows(lines, profs):
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    p = T([q["p"] for q in profs]).reshape(-1)
    t = T([q["t"] for q in profs]).reshape(-1)
    wk = torch.zeros(len(p), 39, dtype=torch.float64)
    w = T([q["wkl"] for q in profs])
    wk[:, :w.shape[-1]] = w.reshape(len(p), -1)
    return lines.params(p, t, wk, T([q["wbrodl"] for q in profs])
                        .reshape(-1))


def brute(lines, pr, wn):
    comp, sd, mirror, inside = lines.rules(pr, wn)
    cls = line_class(lines.mol, lines.xg).expand_as(comp)
    out_o2 = (lines.mol == 7) & (lines.xg == 0.0) & ~inside
    cls = torch.where(out_o2, N_CLASSES - 1, cls)
    R = comp.shape[0]
    lor = torch.zeros((R, N_CLASSES, 2), dtype=torch.int64)
    sdc = torch.zeros((R, 2), dtype=torch.int64)
    for r in range(R):
        lm = comp[r] & ~sd[r]
        for k2 in (0, 1):
            m = lm & (mirror[r] == bool(k2))
            lor[r, :, k2] = torch.bincount(cls[r][m], minlength=N_CLASSES)
            sdc[r, k2] = int((sd[r] & (mirror[r] == bool(k2))).sum())
    return lor, sdc


def mw_lines(n_h2o: int, n_o2: int, uncoupled: int = 0) -> list:
    """Line classes of the program's synthetic microwave catalog: H2O
    over 0.5-60 cm^-1, coupled O2 over 1.5-10 cm^-1, and `uncoupled` of
    the O2 lines without coupling (the class of an uncoupled O2 line
    outside the window then occurs)."""
    return [dict(kind="h2o", n=n_h2o, cm=[0.5, 60.0]),
            dict(kind="o2_coupled", n=n_o2 - uncoupled, cm=[1.5, 10.0]),
            dict(kind="o2", n=uncoupled, cm=[1.5, 10.0])]


@pytest.mark.parametrize("shape,nlay,n_o2", [("standard", 5, 40),
                                            ("envelope", 9, 30)])
def test_lane_counts_equal_brute_force(shape, nlay, n_o2):
    raw = synthetic_lines(mw_lines(60, n_o2, n_o2 // 2), 5)
    # dense where the lines are (the SD-Voigt lanes lie within 100
    # Doppler widths of a centre), sparse up to 55 cm^-1
    wn = np.concatenate([np.linspace(0.3, 12.0, 3000),
                         np.linspace(12.5, 55.0, 60)])
    lines = LineOD(catalog(raw, wn[0], wn[-1]), "cpu", torch.float64)
    profs = profiles(dict(shape=shape, nlay=nlay, dt_k=3.0, jitter_k=0.3,
                          h2o_scale=[0.5, 1.5]), 2,
                     np.random.default_rng(1))
    pr = _rows(lines, profs)
    wt = torch.as_tensor(wn)
    got = count(lines, pr, wt, row_chunk=3)
    lor, sd = brute(lines, pr, wt)
    assert int(sd.sum()) > 0 and int(lor[:, -1].sum()) > 0
    assert torch.equal(got["lor"], lor)
    assert torch.equal(got["sd"], sd)


def test_ops_at_or_below_the_plan_count_at_the_bench_cell():
    """chip_smoke.py phase 4's inputs: bench.py's 3074 lines, 1024 wn over
    0.3-55 cm^-1, synthetic_state(40 layers, 8 profiles); the plan count
    is chip_smoke.lane_counts on the program's operands of every layer
    through the VOIGT=true instantiation."""
    import chip_smoke as cs
    from monortm_tpu_torch.models.monortm import MonoRTM
    from monortm_tpu_torch.testing import synthetic_catalog_mw, \
        synthetic_state

    cat = synthetic_catalog_mw(n_h2o=2048, n_o2=1024, tile=256)
    wn = np.linspace(0.3, 55.0, 1024)
    st = synthetic_state(nlay=40, batch=8, device="cpu",
                         dtype=torch.float32)
    model = MonoRTM(wn, 0.0, cat, nmol=22, device="cpu")
    args = cs.operands(model, st, "full", list(range(40)))
    plan_counts, _, plan_cls = cs.lane_counts(*args[:9], True)
    plan_ops = sum(n * (o + (1 if k < N_CLASSES - 1 else 0))
                   for ns, os_, k in zip(plan_cls, O.FWD_LORENTZ,
                                         range(N_CLASSES))
                   for n, o in zip(ns, os_)) + \
        sum(c * o for c, o in zip(plan_counts[2:], O.FWD_SD))

    raw = synthetic_lines(mw_lines(2048, 1024), 0)
    lines = LineOD(catalog(raw, wn[0], wn[-1]), "cpu", torch.float64)
    B, L = st.p.shape
    d = lambda x: x.detach().double()
    wk = d(st.wkl).reshape(B * L, 39)
    pr = lines.params(d(st.p).reshape(-1), d(st.t).reshape(-1), wk,
                      d(st.wbrodl).reshape(-1))
    n = count(lines, pr, torch.as_tensor(wn))
    ops = float((n["lor"].double() * (torch.tensor(O.FWD_LORENTZ)
                 + torch.tensor([[1]] * (N_CLASSES - 1) + [[0]]))).sum()
                + (n["sd"].double() * torch.tensor(O.FWD_SD)).sum())
    assert 0.9 * plan_ops <= ops <= plan_ops
