"""The adjoint kernel's SD-Voigt partials, compiled on the host.

`csrc/linesum_math.cuh` uses no CUDA runtime API, so g++ compiles it as
host C++.  `sd_shape<Dual>` gives an SD-Voigt lane of the adjoint kernel
its partials by the detuning, hw and aD, evaluated in double
(`Dual64`).  They are held against torch autograd of
`ops.voigt.sdvoigt` in float64 on the same float32 inputs, with the
float32 fallback to the plain Voigt at delta > 1e6 (`f32_fallback`),
which the kernel's branch follows.

Inputs span the SD-Voigt lanes from the surface to near vacuum: aD
6e-7..1e-4 cm^-1, hw 1e-3..80 aD (beyond 99 aD a lane is Lorentz),
detuning within 100 aD and 3 aD of the centre, sdep 1e-3..0.12.  Where
delta >> 1 the float32 partials lose most of their digits (in the
plain float32 adjoint too), so the check is also that the double
evaluation is used.

Tolerance: each partial, in units of the line's widths (d/d dnu and
d/d aD times aD, d/d hw times hw), within 1e-6 of the largest of the
three at that point: the two evaluations use the same float64 formula
and constants, and differ in rounding order and in the float rounding
of the result.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from monortm_tpu_torch.ops.voigt import sdvoigt

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++")

CSRC = Path(__file__).resolve().parents[1] / "monortm_tpu_torch" / "csrc"
DRIVER = r"""
#include <math.h>
#include <stdio.h>
#define __device__
#define __forceinline__ inline
#include "linesum_math.cuh"
using namespace linesum;
int main() {
    float dn, hw, ad, sdep;
    while (scanf("%f %f %f %f", &dn, &hw, &ad, &sdep) == 4) {
        Line ln{0.0f, 0.0f, sdep, 0.0f, 0.0f, hw, ad, 0.0f, 0.0f, 0.0f, 0};
        const Dual d = sd_shape<Dual>(dn, ln);
        printf("%.9e %.9e %.9e %.9e\n", d.v, d.dn, d.dh, d.da);
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def sd_shape_exe(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd_shape")
    (d / "driver.cpp").write_text(DRIVER)
    exe = d / "driver"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    f"-I{CSRC}", "-o", str(exe), str(d / "driver.cpp"),
                    "-lm"], check=True, capture_output=True, timeout=120)
    return exe


def _points(seed, n=400):
    rng = np.random.default_rng(seed)
    ad = 10.0 ** rng.uniform(np.log10(6e-7), -4.0, n)
    hw = ad * 10.0 ** rng.uniform(-3.0, np.log10(80.0), n)
    dn = ad * np.where(rng.random(n) < 0.5, rng.uniform(-3.0, 3.0, n),
                       rng.uniform(-100.0, 100.0, n))
    sdep = rng.uniform(1e-3, 0.12, n)
    return [a.astype(np.float32) for a in (dn, hw, ad, sdep)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sd_shape_partials_match_float64_autograd(sd_shape_exe, seed):
    dn, hw, ad, sdep = _points(seed)
    stdin = "".join(f"{a:.9e} {b:.9e} {c:.9e} {e:.9e}\n"
                    for a, b, c, e in zip(dn, hw, ad, sdep))
    out = subprocess.run([str(sd_shape_exe)], input=stdin, text=True,
                         capture_output=True, check=True, timeout=60).stdout
    got = np.loadtxt(out.splitlines(), ndmin=2)[:, 1:]

    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in (dn, hw, ad)]
    v = sdvoigt(*leaves, torch.tensor(sdep, dtype=torch.float64),
                f32_fallback=True)
    ref = np.stack([g.numpy() for g in
                    torch.autograd.grad(v.sum(), leaves)], axis=1)

    units = np.stack([ad, hw, ad], axis=1).astype(np.float64)
    got_u, ref_u = got * units, ref * units
    scale = np.abs(ref_u).max(axis=1, keepdims=True)
    err = np.abs(got_u - ref_u) / scale
    delta = 0.25 / np.log(2.0) * (ad.astype(np.float64)
                                  / (hw * sdep.astype(np.float64))) ** 2
    # the set reaches both the two-point construction and its fallback
    assert (delta < 1e6).sum() > 50 and (delta > 1e6).sum() > 20
    assert np.isfinite(got).all()
    assert err.max() <= 1e-6, (
        f"worst partial {err.max():.2e} of its point's largest at "
        f"delta={delta[err.max(axis=1).argmax()]:.3e}")
