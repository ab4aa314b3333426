"""The reference's MT_CKD continuum (contnm.f90 + modm.f90:200-247) below
350 cm^-1: H2O self and foreign, CO2 and the N2 rototranslational band,
the sub-continua active there.

A rewrite of tests/reference_continuum.py over tensors: each
sub-continuum's table window (`window`) and both XINT interpolations
(the table onto the 1 cm^-1 ABSRB grid, ABSRB onto the user's
wavenumbers) are the loop oracles' own arithmetic, run once on the host
to give their weights, which then apply as matrices to the per-layer
values computed in PyTorch (differentiable in p, t and the amounts).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import data as D

ONEPL = 1.001
BAND_TOP = 350.0


def xint_weights(v1a, dva, n_a, vft, dvr3, n_r3, n1r3, n2r3):
    """XINT (lblrtm_sub.f90:1-34) as a matrix [n_r3, n_a] over the padded
    1-based array a (a[0] unused): r3 += W @ a."""
    w = np.zeros((n_r3, n_a))
    recdva = 1.0 / dva
    v2a = v1a + dva * (n_a - 2)
    ilo = max(int(np.trunc((v1a + dva - vft) / dvr3 + 1.0 + 0.999)), n1r3)
    ihi = min(int(np.trunc((v2a - dva - vft) / dvr3 + 0.999)), n2r3)
    for i in range(ilo, ihi + 1):
        vi = vft + dvr3 * (i - 1)
        j = int(np.trunc((vi - v1a) * recdva + ONEPL))
        p = recdva * (vi - (v1a + dva * (j - 1)))
        c = (3.0 - 2.0 * p) * p * p
        b = 0.5 * p * (1.0 - p)
        b1, b2 = b * (1.0 - p), b * p
        for k, v in ((j - 1, -b1), (j, 1.0 - c + b2), (j + 1, c + b1),
                     (j + 2, -b2)):
            w[i - 1, k] += v
    return w


def pre_xint(v1ss, v2ss, v1abs, dvabs, nptabs):
    ist = max(1, int(np.trunc(2 + (v1ss - v1abs) / dvabs + 1e-5)))
    last = min(nptabs, int(np.trunc(1 + (v2ss - v1abs) / dvabs + 1e-5)))
    return ist, last


def window(v1abs, v2abs, v1s, dvs, npts, tab, eps=0.01):
    """The table's window around [v1abs, v2abs]: the padded 1-based values
    c[0..nptc+2], v1c, nptc."""
    v1c = v1abs - dvs
    v2c = v2abs + dvs
    i1 = -1 if v1c < v1s else int(np.trunc((v1c - v1s) / dvs + eps))
    v1c = v1s + dvs * (i1 - 1)
    i2 = int(np.trunc((v2c - v1s) / dvs + eps))
    nptc = i2 - i1 + 3
    if nptc > npts:
        nptc = npts + 4
    c = np.zeros(nptc + 3)
    for j in range(1, nptc + 1):
        i = i1 + (j - 1)
        if 1 <= i <= npts:
            c[j] = tab[i - 1]
    return c, v1c, nptc


class Continuum:
    """Continuum OD at wavenumbers `wn` (a subset of the run's grid whose
    first and last points are v1 and v2)."""

    def __init__(self, wn, v1: float, v2: float, device, dtype):
        if v2 >= BAND_TOP:
            raise NotImplementedError("the reference's continuum stops at "
                                      f"{BAND_TOP} cm^-1")
        t = D.table("mt_ckd")
        self.dev, self.dt = torch.device(device), dtype
        wn = np.asarray(wn, np.float64)
        dvabs = 1.0
        v1abs = float(int(v1) - 3.0)
        v2abs = float(int(v2 + 3.5))
        nptabs = int((v2abs - v1abs) / dvabs + 1.5)
        T = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=self.dev)
        # ABSRB -> the wavenumbers (the list form, one point at a time)
        self.user = T(np.concatenate([xint_weights(
            v1abs, dvabs, nptabs + 3, w, 1.0, 1, 1, 1) for w in wn]))
        self.wn = T(wn)
        self.subs = {}

        def sub(name, key, keys):
            """Windows of tables `keys` of one grid, and its weights."""
            v1s, dvs = float(t[f"{key}_v1"]), float(t[f"{key}_dv"])
            npts = int(t[f"{key}_npt"])
            tabs = []
            for k in keys:
                c, v1c, nptc = window(v1abs, v2abs, v1s, dvs, npts, t[k])
                tabs.append(c)
            ist, last = pre_xint(v1s, float(t[f"{key}_v2"]), v1abs, dvabs,
                                 nptabs)
            wgt = xint_weights(v1c, dvs, nptc + 3, v1abs, dvabs, nptabs, ist,
                               last)
            vj = v1c + dvs * (np.arange(nptc + 3) - 1)
            self.subs[name] = dict(tabs=[T(c) for c in tabs], vj=vj,
                                   w=T(wgt))

        sub("h2o_self", "h2o_self_296", ("h2o_self_296", "h2o_self_260"))
        sub("h2o_frgn", "h2o_frgn_296", ("h2o_frgn_296",))
        sub("co2", "co2_frgn", ("co2_frgn",))
        sub("n2", "n2_rt_296", ("n2_rt_296_0", "n2_rt_296_1", "n2_rt_220_0",
                                "n2_rt_220_1"))
        # H2O foreign's scaling by wavenumber (XFAC_RHU), constant
        s = self.subs["h2o_frgn"]
        fscal = np.ones_like(s["vj"])
        xfac = t["xfac_rhu"]
        for j, vj in enumerate(s["vj"]):
            if vj <= 600.0:
                fscal[j] = xfac[int(np.trunc((vj + 10.0) / 10.0 + 1e-5)) + 1]
        s["fscal"] = T(fscal)
        # CO2: XFACCO2 and the band head's temperature exponents
        s = self.subs["co2"]
        v1s, dvs = float(t["co2_frgn_v1"]), float(t["co2_frgn_dv"])
        i_tab = np.rint((s["vj"] - v1s) / dvs).astype(np.int64) + 1
        cfac = np.ones_like(s["vj"])
        tdep = np.zeros_like(s["vj"])
        for j, (vj, i) in enumerate(zip(s["vj"], i_tab)):
            if 2000.0 <= vj <= 2998.0:
                cfac[j] = t["xfac_co2"][int(np.trunc((vj - 1998.0) / 2.0
                                                     + 1e-5)) - 1]
            if 1196 <= i <= 1220:
                tdep[j] = t["co2_tdep_bandhead"][i - 1196]
        s["cfac"], s["tdep"] = T(cfac), T(tdep)
        self.t_eff = float(t["co2_t_eff"])

    def od(self, p, t, wk, wbroad, nmol: int):
        """Continuum OD [R, W] of rows of layers (p, t, wbroad [R], wk [R,
        39]), all species summed."""
        c = lambda v: v[:, None]
        wk = wk.clone()
        if nmol < 22:
            wk[:, 21] = wbroad
        wtot = wbroad + wk[:, :nmol].sum(-1)
        x_h2o, x_o2 = wk[:, 0] / wtot, wk[:, 6] / wtot
        x_n2 = 1.0 - x_h2o - x_o2
        rhoave = (p / 1013.0) * (296.0 / t)
        amagat = (p / 1013.0) * (273.0 / t)
        s = self.subs
        out = {}

        def ratio(a, b, tfac):
            ok = a != 0.0
            safe = torch.where(ok, a, torch.ones_like(a))
            return torch.where(ok, a * (b / safe) ** tfac, torch.zeros_like(a))

        # H2O self and foreign into one ABSRB
        s296, s260 = s["h2o_self"]["tabs"]
        tfac = c((t - 296.0) / (260.0 - 296.0))
        cself = c(wk[:, 0] * x_h2o * rhoave * 1e-20) * ratio(s296, s260, tfac)
        (fh,) = s["h2o_frgn"]["tabs"]
        cfrgn = c(wk[:, 0] * (1.0 - x_h2o) * rhoave * 1e-20) * (
            fh * s["h2o_frgn"]["fscal"])
        out["h2o"] = (cself @ s["h2o_self"]["w"].T
                      + cfrgn @ s["h2o_frgn"]["w"].T)
        # CO2
        q = s["co2"]
        tcor = c(t / self.t_eff) ** q["tdep"]
        cco2 = c(wk[:, 1] * rhoave * 1e-20) * (q["cfac"] * q["tabs"][0]
                                               * tcor)
        out["co2"] = cco2 @ q["w"].T
        # N2 rototranslational
        c296, sf296, c220, sf220 = s["n2"]["tabs"]
        tfac = c((t - 296.0) / (220.0 - 296.0))
        cj = ratio(c296, c220, tfac)
        sf_t = ratio(sf296, sf220, tfac)
        fo2 = (sf_t - 1.0) * (0.79 / 0.21)
        cn2 = c((x_n2 * wtot / 2.68675e19) * amagat) * cj * (
            c(x_n2) + fo2 * c(x_o2) + c(x_h2o))
        out["n2"] = torch.where(c296 != 0.0, cn2, torch.zeros_like(cn2)) \
            @ s["n2"]["w"].T
        # ABSRB onto the wavenumbers, times RADFN
        xkt = c(t / D.RADCN2)
        v = self.wn[None, :]
        x = v / xkt
        e = torch.exp(-torch.clamp(x, max=10.0))
        radfn = torch.where(x <= 0.01, 0.5 * x * v, torch.where(
            x <= 10.0, v * (1.0 - e) / (1.0 + e), v.expand_as(x)))
        absrb = torch.nn.functional.pad(sum(out.values()), (1, 2))
        return (absrb @ self.user.T) * radfn
