"""chip_smoke.py's count of the kernels' work, on the CPU at a small size.

The bounds of the forward and adjoint kernels count each kept Lorentz
lane at the operations of its line's class of the branch trees
(`FWD_LORENTZ_OPS`, `BWD_LORENTZ_OPS`, in the order of `TreeClass` in
csrc/linesum_math.cuh).  These tests hold the per-class counts against
the four lane counts and against the catalog's flags.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from monortm_tpu_torch.models.monortm import MonoRTM  # noqa: E402
from monortm_tpu_torch.ops.linesum import precompute  # noqa: E402
from monortm_tpu_torch.testing import (synthetic_catalog_mw,  # noqa: E402
                                       synthetic_state)


def _operands(engine, p_hpa):
    wn = np.linspace(0.4, 50.0, 64)
    model = MonoRTM(wn, float(wn[1] - wn[0]),
                    synthetic_catalog_mw(n_h2o=48, n_o2=16, tile=128),
                    nmol=22, device="cpu")
    st = synthetic_state(nlay=4, device="cpu", dtype=torch.float32)
    od = model.od_model
    plan = od.dev_plans[engine]
    p = torch.full_like(st.p, p_hpa)
    pre = precompute(plan["cat"], p.reshape(-1), st.t.reshape(-1),
                     st.wkl.reshape(-1, 39), st.wbrodl.reshape(-1),
                     od.tips.scor(st.t).reshape(-1, 39 * 9), od.line_cfg)
    return (pre, plan["cat"]["mol"], plan["wn_hi"], plan["wn_lo"],
            plan["cand_map"], plan["cand_valid"], plan["nt"], plan["wt"],
            od.nmol)


@pytest.mark.parametrize("engine,p_hpa", [("full", 1013.0), ("full", 0.02),
                                          ("lorentz", 1013.0)])
def test_lorentz_lanes_by_class_add_up(engine, p_hpa):
    args = _operands(engine, p_hpa)
    voigt = engine == "full"
    counts, sd_lanes, by_class = cs.lane_counts(*args, voigt=voigt)
    assert len(by_class) == len(cs.BWD_LORENTZ_OPS)
    assert sum(r[0] for r in by_class) == counts[0]
    assert sum(r[1] for r in by_class) == counts[1]
    assert int(sd_lanes.sum()) == counts[2] + counts[3]
    # the synthetic catalog: O2 lines coupled with XF1 (always k2), the
    # rest plain; no CO2
    fl = {k: v > 0.5 for k, v in args[0]["flags"].items()}
    assert bool((fl["o2"] == (fl["cpl"] & fl["xf1"]))[fl["valid"]].all())
    assert not bool(fl["co2"].any())
    used = [i for i, r in enumerate(by_class) if any(r)]
    assert set(used) <= {0, 6}
    assert by_class[0][0] == 0
    # the bound follows the table
    ops = (by_class[0][1] * (63 + voigt) + by_class[6][0] * (31 + voigt)
           + by_class[6][1] * (43 + voigt) + counts[2] * 465
           + counts[3] * 875)
    ms, by = cs.bound_by_class("bwd", voigt, counts, by_class, 0)
    assert by == "operations"
    assert ms == pytest.approx(ops / cs.PEAK_FLOPS * 1e3, rel=1e-12)


@pytest.mark.parametrize("engine,p_hpa", [("full", 1013.0), ("full", 0.02),
                                          ("lorentz", 1013.0)])
def test_forward_class_counts_add_up_to_the_lorentz_lanes(engine, p_hpa):
    args = _operands(engine, p_hpa)
    voigt = engine == "full"
    counts, _, by_class = cs.lane_counts(*args, voigt=voigt)
    assert len(cs.FWD_LORENTZ_OPS) == len(by_class)
    # every Lorentz lane falls in one class row, with or without k2
    assert [sum(r[k] for r in by_class) for k in (0, 1)] == counts[:2]
    assert counts[0] + counts[1] > 0
    if not voigt:
        assert counts[2:] == [0, 0]
    # coupled O2 with XF1 always forms k2, plain lines only with the mirror
    # term; the forward's bound follows FWD_LORENTZ_OPS, the lane switch
    # adding one per Lorentz lane with VOIGT
    assert by_class[0][0] == 0 and by_class[6][1] < by_class[6][0]
    ops = (by_class[0][1] * (22 + voigt) + by_class[6][0] * (14 + voigt)
           + by_class[6][1] * (18 + voigt) + counts[2] * 82
           + counts[3] * 151)
    ms, by = cs.bound_by_class("fwd", voigt, counts, by_class, 0)
    assert by == "operations"
    assert ms == pytest.approx(ops / cs.PEAK_FLOPS * 1e3, rel=1e-12)
    # below the flat count of PRs 1-3, which costs every lane as unhoisted
    flat, _ = cs.bound("fwd", voigt, counts, 0)
    assert ms < flat
