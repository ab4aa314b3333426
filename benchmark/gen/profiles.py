"""Layered atmospheric profiles drawn from a seed.

Two shapes, each a frozen copy of a fixture of the program, varied per
profile from the seed:
- "standard": `monortm_tpu_torch.testing.synthetic_state` (a US-standard
  like column from 1000 to 50 hPa, nmol 22, a liquid cloud in layer 3) with
  the levels of `chip_smoke.write_rundir` (1013 to 45 hPa, looking up);
- "envelope": `monortm_tpu_torch.envelope.make_profile` (1013 to 0.05
  hPa, nmol 7, looking up).
Each profile gets a temperature offset and a tilt (`dt_k` K), a small
per-layer jitter, and an H2O factor in `h2o_scale`.  Every profile of a
shape has the same sizes, so every seed asks for the same work.
"""

from __future__ import annotations

import numpy as np


def _standard(nlay: int) -> dict:
    p = np.geomspace(1000.0, 50.0, nlay)
    t = 288.0 - 60.0 * (1.0 - p / 1000.0)
    tz = np.concatenate([[t[0] + 2.0], t - 1.0])
    col = p / p.sum()
    wkl = np.zeros((nlay, 22))
    wkl[:, 0] = 4.5e22 * col * np.exp(-np.arange(nlay) / 6.0) * 6
    wkl[:, 1] = 7.5e21 * col
    wkl[:, 2] = 9.0e18 * col
    wkl[:, 6] = 4.5e24 * col
    wkl[:, 21] = 1.7e25 * col
    clw = np.zeros(nlay)
    clw[2] = 0.03
    pz = np.geomspace(1013.0, 45.0, nlay + 1)
    altz = -7.0 * np.log(pz / 1013.0)
    return dict(p=p, t=t, tz=tz, wkl=wkl, wbrodl=2.0e22 * col, clw=clw,
                nmol=22, angle=0.0, h1=0.0, h2=float(altz[-1]), altz=altz,
                pz=pz, hmod="SYNTHETIC")


def _envelope(nlay: int) -> dict:
    p = np.geomspace(1013.0, 0.05, nlay)
    t = np.clip(288.0 - 65.0 * (1.0 - (p / 1013.0) ** 0.22), 190.0, 300.0)
    tz = np.concatenate([[t[0] + 1.0], t - 0.5])
    col = p / p.sum()
    wkl = np.zeros((nlay, 7))
    wkl[:, 0] = 4.5e22 * col * np.exp(-np.arange(nlay) / (nlay / 4))
    wkl[:, 1] = 7.5e21 * col
    wkl[:, 2] = 9.0e18 * col
    wkl[:, 6] = 4.5e24 * col
    alt = np.concatenate([[0.0], np.cumsum(np.full(nlay, 70.0 / nlay))])
    pz = np.concatenate([[1013.25], p - (p - np.roll(p, -1)) / 2])
    pz[-1] = p[-1] * 0.9
    return dict(p=p, t=t, tz=tz, wkl=wkl, wbrodl=1.7e25 * col,
                clw=np.zeros(nlay), nmol=7, angle=0.0, h1=0.0, h2=70.0,
                altz=alt, pz=pz, hmod="ENVELOPE")


SHAPES = {"standard": _standard, "envelope": _envelope}


def profiles(spec: dict, n: int, rng: np.random.Generator) -> list[dict]:
    """n profiles of spec["shape"] at spec["nlay"] layers, varied from rng
    by spec's dt_k (offset and tilt, K), jitter_k and h2o_scale [lo, hi]."""
    base = SHAPES[spec["shape"]](spec["nlay"])
    nlay = spec["nlay"]
    out = []
    for _ in range(n):
        off, tilt = rng.uniform(-spec["dt_k"], spec["dt_k"], 2)
        ramp = np.linspace(-1.0, 1.0, nlay + 1)
        dz = off + tilt * ramp + rng.normal(0.0, spec["jitter_k"], nlay + 1)
        pr = dict(base)
        pr["tz"] = base["tz"] + dz
        pr["t"] = base["t"] + 0.5 * (dz[:-1] + dz[1:])
        pr["wkl"] = base["wkl"].copy()
        pr["wkl"][:, 0] *= rng.uniform(*spec["h2o_scale"])
        out.append(pr)
    return out
