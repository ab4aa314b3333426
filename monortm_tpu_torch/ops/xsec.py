"""Cross-section molecule optical depths (host NumPy; tiny workload).

Replicates MONORTM_XSEC_SUB + convolve (monortm_sub.F90:1540-1834):
temperature interpolation between stored spectra (with the radiation term
removed at the storage temperature), pressure convolution with a Lorentzian
of width hwb = hw(Pave) - hw(Pdata) with adaptive truncation, scaling by
layer amounts XAMNT, and re-application of the radiation term at the layer
temperature.  The result feeds the device model as a precomputed
[nlay, nwn] array — the per-run cost is negligible next to the line sum,
and the adaptive truncation is inherently data-dependent (host-friendly).

A copy of `monortm_tpu.ops.xsec`, its code byte for byte but for the
imports, which name the port's `constants` and `io.fscdxs`
(tests/test_torch_copies.py).
"""

from __future__ import annotations

import math

import numpy as np

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.io.fscdxs import XsIndex, XsSpectrum


def _radfn(v, xkt):
    if xkt > 0.0:
        x = v / xkt
        if x <= 0.01:
            return 0.5 * x * v
        if x <= 10.0:
            e = math.exp(-x)
            return v * (1.0 - e) / (1.0 + e)
    return v


def convolve(xspd, v1x, v2x, delvx, pd, hwdop, tave, pave, wn):
    """Pressure convolution (monortm_sub.F90:1751-1834).

    xspd: stored spectrum on (v1x, delvx) grid (radiation term removed).
    Returns values at each wn.
    """
    p0 = 1013.0
    hwpave = 0.1 * (pave / p0) * (273.15 / tave)
    hwd = 0.1 * (pd / p0) * (273.15 / tave)
    hwd = max(hwd, hwdop)
    if hwd > hwpave:
        hwpave = 1.001 * hwd
    hwb = hwpave - hwd

    ratio = 0.25
    step = ratio * hwb
    if step > delvx:
        step = delvx
    npts = int((v2x - v1x) / step)
    step = (v2x - v1x) / float(npts)
    ratio = step / hwb if hwb != 0.0 else 1.0

    # linear interpolation of incoming values onto the step grid
    i = np.arange(npts + 1)
    vv = v1x + i * step
    ind = ((vv - v1x) / delvx).astype(np.int64)
    coef = ((vv - v1x) - ind * delvx) / delvx
    ind2 = np.minimum(ind + 1, len(xspd) - 1)
    xspd_int = (1.0 - coef) * xspd[np.minimum(ind, len(xspd) - 1)] \
        + coef * xspd[ind2]

    hwb2 = hwb * hwb
    out = np.zeros(len(wn))
    for iw, w in enumerate(wn):
        if w < v1x or w > v2x:
            continue
        if hwd != 0.0 and hwb / hwd > 0.1:
            wn_v1x = w - v1x
            ind0 = int(wn_v1x / step)
            dvlo = w - (v1x + ind0 * step)
            dvhi = w - (v1x + (ind0 + 1) * step)
            answer = (hwb / (hwb2 + dvlo**2)) * xspd_int[ind0] \
                + (hwb / (hwb2 + dvhi**2)) * xspd_int[min(ind0 + 1, npts)]
            j = 1
            while True:
                vlo = v1x + (ind0 - j) * step
                if vlo > v1x:
                    dvlo = w - vlo
                    contlo = (hwb / (hwb2 + dvlo**2)) * xspd_int[ind0 - j]
                else:
                    contlo = 0.0
                vhi = v1x + (ind0 + j + 1) * step
                if vhi < v2x:
                    dvhi = w - vhi
                    conthi = (hwb / (hwb2 + dvhi**2)) * \
                        xspd_int[min(ind0 + j + 1, npts)]
                else:
                    conthi = 0.0
                xincr = contlo + conthi
                if answer != 0.0 and (xincr / answer) < ratio * 1e-6:
                    break
                answer += xincr
                if contlo == 0.0 and conthi == 0.0:
                    break
                j += 1
            out[iw] = answer * step / 3.14159
        else:
            # linearly interpolated stored values (monortm_sub.F90:1824-1828)
            # note the reference's 1-based xspd(ind) here — an off-by-one
            # it inherits from LBLRTM; replicated with a clamp at the edge
            wn_v1x = w - v1x
            ind0 = int(wn_v1x / delvx)
            coef0 = (wn_v1x - ind0 * delvx) / delvx
            lo = xspd[max(ind0 - 1, 0)]
            hi = xspd[min(ind0, len(xspd) - 1)]
            out[iw] = (1.0 - coef0) * lo + coef0 * hi
    return out


def xsec_od(index: XsIndex, spectra: dict, wn, p, t, xamnt) -> np.ndarray:
    """Total cross-section OD [nlay, nwn] (MONORTM_XSEC_SUB).

    spectra: {filename: XsSpectrum}; xamnt: [n_sel, nlay] layer amounts.
    """
    wn = np.asarray(wn, np.float64)
    p = np.atleast_1d(np.asarray(p, np.float64))
    t = np.atleast_1d(np.asarray(t, np.float64))
    nlay = len(p)
    nwn = len(wn)
    xstot = np.zeros((nlay, nwn))
    dvbuf = 1.0

    for isel in range(len(index.names)):
        xsmoltot = np.zeros((nlay, nwn))
        for reg in index.regions[isel]:
            if not np.any((wn >= reg.v1x - dvbuf) & (wn <= reg.v2x + dvbuf)):
                continue
            specs = [spectra[f] for f in reg.files]
            temps = [s.temp for s in specs]
            for il in range(nlay):
                tave, pave = t[il], p[il]
                # bracket temperature (files ascending in T)
                coef1, coef2 = 1.0, 0.0
                ind1 = ind2 = 0
                if len(specs) == 1 or tave <= temps[0]:
                    ind1 = ind2 = 0
                else:
                    it = 0
                    while True:
                        it += 1
                        if it > len(specs) - 1:
                            ind1 = ind2 = len(specs) - 1
                            break
                        if tave <= temps[it]:
                            ind1, ind2 = it - 1, it
                            coef1 = (tave - temps[it]) / \
                                (temps[it - 1] - temps[it])
                            coef2 = 1.0 - coef1
                            break
                s1, s2 = specs[ind1], specs[ind2]
                pd = coef1 * s1.pres + coef2 * s2.pres
                xkt1 = s1.temp / cst.RADCN2
                xkt2 = s2.temp / cst.RADCN2
                npts = s1.npts
                delvx = (s1.v2 - s1.v1) / float(npts - 1)
                vvs = s1.v1 + np.arange(npts) * delvx
                r1 = np.array([_radfn(v, xkt1) for v in vvs])
                r2 = np.array([_radfn(v, xkt2) for v in vvs])
                xspd = coef1 * s1.data / r1 + coef2 * s2.data[:npts] / r2
                hwdop = reg.xdoplr * math.sqrt(tave / 296.0)
                xspave = convolve(xspd, s1.v1, s1.v2, delvx, pd, hwdop,
                                  tave, pave, wn)
                xsmoltot[il] += xspave
        xstot += xamnt[isel][:, None] * xsmoltot

    # put the radiation field back in (monortm_sub.F90:1739-1744)
    for il in range(nlay):
        xkt = t[il] / cst.RADCN2
        xstot[il] *= np.array([_radfn(w, xkt) for w in wn])
    return xstot
