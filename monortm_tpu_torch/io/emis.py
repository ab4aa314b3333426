"""Boundary emissivity / reflectivity spectra.

Replicates EMISFN/REFLFN (monortm_sub.F90:426-516): quadratic polynomial in
wavenumber, or linear interpolation of the 'EMISSION'/'REFLECTION' files
when the leading coefficient is negative (READEM/READRF,
monortm_sub.F90:1-29).

A copy of `monortm_tpu.io.emis`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

NMAXCO = 4040


def read_spectral_file(path: str | Path):
    """'EMISSION'/'REFLECTION' file: header (3E10.3,5X,I5) + E15.7 rows."""
    lines = Path(path).read_text().splitlines()
    h = lines[0].ljust(45)
    v1 = float(h[0:10])
    v2 = float(h[10:20])
    dv = float(h[20:30])
    nlim = int(h[35:40])
    if nlim > NMAXCO:
        raise ValueError(f"too many points {nlim} > {NMAXCO}")
    z = np.asarray([float(s[:15]) for s in lines[1:1 + nlim]])
    return v1, v2, dv, z


def boundary_spectrum(wn: np.ndarray, coeffs, file_path=None) -> np.ndarray:
    """Per-wavenumber boundary value (EMISFN semantics).

    coeffs = (a, b, c): a >= 0 -> a + b*v + c*v^2 (constant if b=c=0);
    a < 0 -> linear interpolation of the spectral file.
    """
    a, b, c = coeffs
    wn = np.asarray(wn, np.float64)
    if a >= 0:
        if b == 0.0 and c == 0.0:
            return np.full_like(wn, a)
        return a + b * wn + c * wn * wn
    if file_path is None:
        raise ValueError("negative leading coefficient requires a spectral file")
    v1e, v2e, dve, z = read_spectral_file(file_path)
    out = np.empty_like(wn)
    for k, v in enumerate(wn):
        nelmnt = int((v - v1e) / dve)
        if nelmnt <= 0 or nelmnt >= len(z):
            raise ValueError(
                f"wavenumber {v} outside spectral file range [{v1e},{v2e}]")
        va = v1e + dve * nelmnt
        vb = v1e + dve * (nelmnt + 1)
        # LINTCO linear interpolation (monortm_sub.F90:495-503);
        # note the reference indexes ZEMIS(NELMNT) with NELMNT computed
        # 0-based — faithfully replicated (z[nelmnt-1] in 0-based terms)
        za = z[nelmnt - 1]
        zb = z[nelmnt]
        out[k] = za + (zb - za) / (vb - va) * (v - va)
    return out
