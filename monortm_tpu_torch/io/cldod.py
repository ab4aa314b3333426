"""TES cloud effective optical depth file ('in_lblrtm_cld').

Replicates the cld_od reader/interpolator (contnm.f90:10355-10463):
a free-form file with n_freq, the frequency list, n_layer, then per layer
an (index, pressure) line and n_freq cloud ODs.  Values are linearly
interpolated in wavenumber with constant extrapolation.

In the reference this hook fires on iaersl=5 inside CONTNM; MonoRTM never
sets iaersl (FSCDID(4) is not populated by RDLBLINP), so the path is dead
there — and if it did fire, the per-species continuum isolation
(modm.f90:210-247) would accumulate the cloud OD once per species.  Here
the cloud OD is added exactly once to the total (models/od.py), which is
the physically correct reading of the feature.

A copy of `monortm_tpu.io.cldod`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_cloud_od(path: str | Path):
    """Returns (v_cloud[n_freq], od[n_layer, n_freq], pres[n_layer])."""
    toks = Path(path).read_text().split()
    i = 0
    n_freq = int(toks[i]); i += 1
    v = np.asarray([float(x) for x in toks[i:i + n_freq]]); i += n_freq
    n_layer = int(toks[i]); i += 1
    od = np.zeros((n_layer, n_freq))
    pres = np.zeros(n_layer)
    for l in range(n_layer):
        _idx = int(toks[i]); i += 1
        pres[l] = float(toks[i]); i += 1
        od[l] = [float(x) for x in toks[i:i + n_freq]]
        i += n_freq
    return v, od, pres


def cloud_od_on_grid(path: str | Path, wn, nlay: int) -> np.ndarray:
    """Cloud OD interpolated to the wavenumber grid -> [nlay, nwn]."""
    v, od, _ = read_cloud_od(path)
    wn = np.asarray(wn, np.float64)
    if od.shape[0] < nlay:
        raise ValueError(f"cloud file has {od.shape[0]} layers < {nlay}")
    out = np.zeros((nlay, len(wn)))
    for l in range(nlay):
        out[l] = np.interp(wn, v, od[l])     # constant beyond the ends
    return out
