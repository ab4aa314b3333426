"""MT_CKD v3.5 continuum — static host plan, gather-based device evaluation.

Port of `monortm_tpu.ops.continuum`.  The host half (`ContinuumFactors`,
`_window`, `_slice_table`, `_pre_xint` and the builders' numpy code) is
copied verbatim, so both packages slice the same table windows and build
the same XINT plans.  The device half evaluates each sub-continuum on
tensors and merges it with `DeviceXintPlan`s.

Ported sub-continua: h2o_self, h2o_frgn, co2_frgn and n2_rt — the ones a
microwave grid activates.  A grid that activates any other one (or
Rayleigh, above 820 cm^-1) raises NotImplementedError naming it when the
plan is built; the port never returns zeros in its place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.data import loader
from monortm_tpu_torch.ops.arith import rdiv
from monortm_tpu_torch.ops.planck import radfn
from monortm_tpu_torch.ops.xint import (DeviceXintPlan, XintPlan,
                                        build_xint_plan,
                                        build_xint_plan_points, _trunc)

SPECIES = ("h2o", "co2", "o3", "o2", "n2", "rayleigh")

# sub-continua of the JAX package not ported yet: (name, scale factor,
# activation test on the grid's (v1, v2)) — the same tests as its builders
_UNPORTED = (
    ("o3_chap", "xo3cn", lambda v1, v2: v2 > 8920.0 and v1 <= 24665.0),
    ("o3_hh", "xo3cn", lambda v1, v2: v2 > 27370.0 and v1 < 40800.0),
    ("o3_uv", "xo3cn", lambda v1, v2: v2 > 40800.0 and v1 < 54000.0),
    ("o2_fund", "xo2cn", lambda v1, v2: v2 > 1340.0 and v1 < 1850.0),
    ("o2_inf1", "xo2cn", lambda v1, v2: v2 > 7536.0 and v1 < 8500.0),
    ("o2_inf2", "xo2cn", lambda v1, v2: v2 > 9100.0 and v1 < 11000.0),
    ("o2_aband", "xo2cn", lambda v1, v2: v2 > 12961.5 and v1 < 13221.5),
    ("o2_vis", "xo2cn", lambda v1, v2: v2 > 15000.0 and v1 < 29870.0),
    ("o2_herz", "xo2cn", lambda v1, v2: v2 > 36000.0),
    ("o2_fuv", "xo2cn", lambda v1, v2: v2 > 56740.0),
    ("n2_fund", "xn2cn", lambda v1, v2: v2 > 2001.77 and v1 < 2897.59),
    ("n2_overtone", "xn2cn", lambda v1, v2: v2 > 4340.0 and v1 < 4910.0),
    ("rayleigh", "xrayl", lambda v1, v2: v2 >= 820.0),
)


@dataclass(frozen=True)
class ContinuumFactors:
    """Continuum scale factors (CntnmFactors.f90:17-19), static per run."""
    xself: float = 1.0
    xfrgn: float = 1.0
    xco2c: float = 1.0
    xo3cn: float = 1.0
    xo2cn: float = 1.0
    xn2cn: float = 1.0
    xrayl: float = 1.0

    @staticmethod
    def from_icntnm(icntnm: int, values: tuple[float, ...] | None = None
                    ) -> "ContinuumFactors":
        """ICNTNM 0-6 combos (CntnmFactors.f90:143-186; 6 = explicit)."""
        if icntnm == 0:
            return ContinuumFactors(0, 0, 0, 0, 0, 0, 0)
        if icntnm == 1:
            return ContinuumFactors()
        if icntnm == 2:
            return ContinuumFactors(xself=0.0)
        if icntnm == 3:
            return ContinuumFactors(xfrgn=0.0)
        if icntnm == 4:
            return ContinuumFactors(xself=0.0, xfrgn=0.0)
        if icntnm == 5:
            return ContinuumFactors(xrayl=0.0)
        if icntnm == 6:
            return ContinuumFactors(*values)
        raise ValueError(f"invalid ICNTNM {icntnm}")


def _window(v1abs: float, v2abs: float, v1s: float, v2s: float, dvs: float,
            npts: int, eps: float = 0.01):
    """Replicate the table-windowing arithmetic shared by all contnm
    table subroutines (e.g. SL296, contnm.f90:1440-1456).

    Returns (i1, nptc, v1c): i1 is the 1-based table index of window
    point J=1; entries outside [1, npts] are zero.
    """
    v1c = v1abs - dvs
    v2c = v2abs + dvs
    if v1c < v1s:
        i1 = -1
    else:
        i1 = int(_trunc((v1c - v1s) / dvs + eps))
    v1c = v1s + dvs * (i1 - 1)
    i2 = int(_trunc((v2c - v1s) / dvs + eps))
    nptc = i2 - i1 + 3
    if nptc > npts:
        nptc = npts + 4
    return i1, nptc, v1c


def _slice_table(tab: np.ndarray, i1: int, nptc: int) -> np.ndarray:
    """C(J) = S(I1+J-1) with zeros outside the table (1-based I1)."""
    out = np.zeros(nptc, dtype=np.float64)
    for j in range(nptc):
        i = i1 + j  # 1-based table index of point j (J=j+1 -> I=I1+J-1)
        if 1 <= i <= tab.size:
            out[j] = tab[i - 1]
    return out


def _pre_xint(v1ss: float, v2ss: float, v1abs: float, dvabs: float,
              nptabs: int) -> tuple[int, int]:
    """ist/last bounds for the ABSRB merge (contnm.f90:1146-1164)."""
    nbnd_v1c = int(_trunc(2.0 + (v1ss - v1abs) / dvabs + 1e-5))
    ist = max(1, nbnd_v1c)
    nbnd_v2c = int(_trunc(1.0 + (v2ss - v1abs) / dvabs + 1e-5))
    last = min(nptabs, nbnd_v2c)
    return ist, last


@dataclass
class _SubContinuum:
    """One sub-continuum: static window data + device-side evaluator."""
    name: str
    species: str
    plan: XintPlan                       # window -> ABSRB accumulate (host)
    static: dict                         # numpy window arrays (host)
    fn: Callable                         # fn(static, layer) -> [..., nptc]
    dplan: DeviceXintPlan
    dstatic: dict                        # `static` as float64 tensors


class _Layer:
    """Per-layer derived scalars, all batched over leading axes."""

    def __init__(self, pave, tave, wk, wbroad, nmol: int):
        self.pave = pave
        self.tave = tave
        # n2 takes the broadening amount when not an active molecule
        # (modm.f90:209)
        if nmol < 22:
            wk = wk.clone()
            wk[..., 21] = wbroad
        self.wk = wk
        self.wbroad = wbroad
        self.rhoave = (self.pave / 1013.0) * rdiv(296.0, self.tave)
        self.amagat = (self.pave / 1013.0) * rdiv(273.0, self.tave)
        self.xkt = self.tave / cst.RADCN2
        self.wtot = self.wbroad + torch.sum(wk[..., :nmol], dim=-1)
        self.x_h2o = wk[..., 0] / self.wtot
        self.x_o2 = wk[..., 6] / self.wtot
        self.x_n2 = 1.0 - self.x_h2o - self.x_o2
        self.wn2 = self.x_n2 * self.wtot

    def b(self, x):
        """Broadcast a per-layer scalar against a window axis."""
        return x[..., None]


class ContinuumPlan:
    """Static continuum evaluation plan for one wavenumber grid."""

    def __init__(self, wn: np.ndarray, dvset: float = 0.0,
                 factors: ContinuumFactors = ContinuumFactors(),
                 nmol: int = 39, *, device):
        wn = np.asarray(wn, dtype=np.float64)
        self.wn = wn
        self.device = device
        self.factors = factors
        self.nmol = int(nmol)
        v1, v2 = float(wn[0]), float(wn[-1])
        self.v1, self.v2 = v1, v2
        for name, fac, active in _UNPORTED:
            if getattr(factors, fac) > 0 and active(v1, v2):
                raise NotImplementedError(
                    f"MT_CKD sub-continuum {name!r} (active on a "
                    f"{v1}-{v2} cm^-1 grid) is not ported to "
                    "monortm_tpu_torch yet")

        # ABSRB grid (modm.f90:182-185)
        self.dvabs = 1.0
        self.v1abs = float(int(v1) - 3.0 * self.dvabs)
        self.v2abs = float(int(v2 + 3.0 * self.dvabs + 0.5))
        self.nptabs = int((self.v2abs - self.v1abs) / self.dvabs + 1.5)

        # stage 2: ABSRB -> user grid (modm.f90:218-226)
        if dvset != 0.0:
            self.stage2 = build_xint_plan(
                self.v1abs, self.dvabs, self.nptabs, v1, dvset, 1, len(wn),
                len(wn))
        else:
            self.stage2 = build_xint_plan_points(
                self.v1abs, self.dvabs, self.nptabs, wn)
        self.dstage2 = DeviceXintPlan(self.stage2, device)
        self.wn_t = torch.as_tensor(wn, dtype=torch.float64, device=device)

        self.subs: list[_SubContinuum] = []
        self._build_h2o()
        self._build_co2()
        self._build_n2()

    # ----- plan helpers ---------------------------------------------------

    def _vj(self, v1c: float, dvc: float, nptc: int) -> np.ndarray:
        return v1c + dvc * np.arange(nptc, dtype=np.float64)

    def _add(self, name, species, tab_key_or_arrays, fn, static_extra=None,
             eps=0.01):
        """Register one table-backed sub-continuum."""
        t = loader.mt_ckd()
        if isinstance(tab_key_or_arrays, str):
            key = tab_key_or_arrays
            v1s, v2s = float(t[f"{key}_v1"]), float(t[f"{key}_v2"])
            dvs, npts = float(t[f"{key}_dv"]), int(t[f"{key}_npt"])
            arrays = {"tab": t[key]}
        else:
            key, arrays, (v1s, v2s, dvs, npts) = tab_key_or_arrays
        i1, nptc, v1c = _window(self.v1abs, self.v2abs, v1s, v2s, dvs,
                                npts, eps)
        static = {k: _slice_table(v, i1, nptc) for k, v in arrays.items()}
        static["vj"] = self._vj(v1c, dvs, nptc)
        if static_extra:
            static.update(static_extra(static, i1, nptc, v1c, dvs))
        ist, last = _pre_xint(v1s, v2s, self.v1abs, self.dvabs, self.nptabs)
        plan = build_xint_plan(v1c, dvs, nptc, self.v1abs, self.dvabs,
                               ist, last, self.nptabs)
        dstatic = {k: torch.as_tensor(v, dtype=torch.float64,
                                      device=self.device)
                   for k, v in static.items()}
        self.subs.append(_SubContinuum(name, species, plan, static, fn,
                                       DeviceXintPlan(plan, self.device),
                                       dstatic))

    # ----- species builders ----------------------------------------------

    def _build_h2o(self):
        f = self.factors
        t = loader.mt_ckd()
        if self.v2 > -20.0 and self.v1 < 20000.0 and f.xself > 0:
            def self_extra(static, i1, nptc, v1c, dvs):
                return {"s260": _slice_table(t["h2o_self_260"], i1, nptc)}

            def self_fn(s, L):
                tfac = L.b((L.tave - 296.0) / (260.0 - 296.0))
                s296 = s["tab"]
                s260 = s["s260"]
                pos = s296 > 0.0
                sh2o = torch.where(
                    pos, s296 * (torch.where(pos, s260, 1.0)
                                 / torch.where(pos, s296, 1.0)) ** tfac, 0.0)
                rself = L.b(L.x_h2o * L.rhoave) * 1.0e-20 * f.xself
                return L.b(L.wk[..., 0]) * sh2o * rself

            self._add("h2o_self", "h2o", "h2o_self_296", self_fn,
                      static_extra=self_extra)

        if self.v2 > -20.0 and self.v1 < 20000.0 and f.xfrgn > 0:
            xfac_rhu = t["xfac_rhu"]                    # indices -1..61

            def frgn_extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                fscal = np.ones_like(vj)
                low = vj <= 600.0
                jfac = _trunc((vj + 10.0) / 10.0 + 1e-5)  # contnm.f90:420
                jidx = np.clip(jfac + 1, 0, xfac_rhu.size - 1)
                fscal[low] = xfac_rhu[jidx[low]]
                # analytic correction above 600 cm^-1 (contnm.f90:424-433)
                hi = ~low
                v = vj[hi]
                f0, v0f1, hwsq1, beta1 = 0.06, 255.67, 240.0**2, 57.83
                c_1, n_1, c_2, beta2, n_2 = -0.42, 8, 0.3, 630.0, 8
                vf1 = ((v - v0f1) / beta1) ** n_1
                vmf1 = ((v + v0f1) / beta1) ** n_1
                vf2 = (v / beta2) ** n_2
                fscal[hi] = 1.0 + (f0 + c_1 * (
                    hwsq1 / ((v - v0f1) ** 2 + hwsq1 + vf1)
                    + hwsq1 / ((v + v0f1) ** 2 + hwsq1 + vmf1))) / (1.0 + c_2 * vf2)
                return {"fscal": fscal}

            def frgn_fn(s, L):
                fh2o = s["tab"] * s["fscal"]
                rfrgn = L.b((1.0 - L.x_h2o) * L.rhoave) * 1.0e-20 * f.xfrgn
                return L.b(L.wk[..., 0]) * fh2o * rfrgn

            self._add("h2o_frgn", "h2o", "h2o_frgn_296", frgn_fn,
                      static_extra=frgn_extra)

    def _build_co2(self):
        f = self.factors
        t = loader.mt_ckd()
        if not (self.v2 > -20.0 and self.v1 < 10000.0 and f.xco2c > 0):
            return

        tdep = t["co2_tdep_bandhead"]         # table indices 1196..1220
        t_eff = float(t["co2_t_eff"])
        xfacco2 = t["xfac_co2"]

        def extra(static, i1, nptc, v1c, dvs):
            vj = static["vj"]
            # bandhead T-dependence exponent per window point
            # (contnm.f90:3004-3008): table index i in [1196, 1220]
            idx = i1 + np.arange(nptc)        # 1-based table index
            e = np.zeros(nptc)
            sel = (idx >= 1196) & (idx <= 1220)
            e[sel] = tdep[idx[sel] - 1196]
            # XFACCO2 window correction (contnm.f90:508-513)
            cfac = np.ones(nptc)
            selx = (vj >= 2000.0) & (vj <= 2998.0)
            jfac = _trunc((vj[selx] - 1998.0) / 2.0 + 1e-5)
            cfac[selx] = xfacco2[np.clip(jfac - 1, 0, xfacco2.size - 1)]
            return {"e": e, "cfac": cfac}

        def fn(s, L):
            trat = L.b(L.tave / t_eff)
            tcor = trat ** s["e"]
            wco2 = L.b(L.wk[..., 1] * L.rhoave) * 1.0e-20 * f.xco2c
            return s["tab"] * s["cfac"] * tcor * wco2

        self._add("co2_frgn", "co2", "co2_frgn", fn, static_extra=extra)

    def _build_n2(self):
        f = self.factors
        t = loader.mt_ckd()
        if not f.xn2cn > 0:
            return

        if self.v2 > -10.0 and self.v1 < 350.0:
            def extra(static, i1, nptc, v1c, dvs):
                return {"c220": _slice_table(t["n2_rt_220_0"], i1, nptc),
                        "sf296": _slice_table(t["n2_rt_296_1"], i1, nptc),
                        "sf220": _slice_table(t["n2_rt_220_1"], i1, nptc)}

            def fn(s, L):
                tfac = L.b((L.tave - 296.0) / (220.0 - 296.0))
                c296 = s["tab"]
                c220 = s["c220"]
                sf296 = s["sf296"]
                sf220 = s["sf220"]
                pos = c296 > 0.0
                c = torch.where(pos, c296 * (torch.where(pos, c220, 1.0)
                                             / torch.where(pos, c296, 1.0))
                                ** tfac, 0.0)
                posf = sf296 > 0.0
                sf_t = torch.where(posf, sf296 * (torch.where(posf, sf220, 1.0)
                                                  / torch.where(posf, sf296,
                                                                1.0))
                                   ** tfac, 0.0)
                fo2 = torch.where(pos, (sf_t - 1.0) * (0.79 / 0.21), 0.0)
                tau = f.xn2cn * (L.b(L.wn2) / cst.XLOSMT) * L.b(L.amagat)
                return tau * c * (L.b(L.x_n2) + fo2 * L.b(L.x_o2)
                                  + 1.0 * L.b(L.x_h2o))

            key = ("n2_rt", {"tab": t["n2_rt_296_0"]},
                   (float(t["n2_rt_296_v1"]), float(t["n2_rt_296_v2"]),
                    float(t["n2_rt_296_dv"]), int(t["n2_rt_296_npt"])))
            self._add("n2_rt", "n2", key, fn, static_extra=extra)

    # ----- device evaluation ---------------------------------------------

    def __call__(self, pave, tave, wk, wbroad, dtype: torch.dtype):
        """Continuum ODs on the user grid.

        pave,tave,wbroad: [...]; wk: [..., >=nmol] molecular columns, all
        on the plan's device.  Returns dict species -> [..., nwn].
        """
        L = _Layer(pave, tave, wk, wbroad, self.nmol)
        batch = L.tave.shape

        absrb = {sp: torch.zeros(batch + (self.nptabs,), dtype=dtype,
                                 device=self.device)
                 for sp in SPECIES[:-1]}
        for sub in self.subs:
            s = {k: v.to(L.tave.dtype) for k, v in sub.dstatic.items()}
            vals = sub.fn(s, L).to(dtype)
            absrb[sub.species] = sub.dplan.apply(vals, absrb[sub.species])

        rf = radfn(self.wn_t.to(dtype), L.xkt[..., None]).to(dtype)
        out = {sp: self.dstage2.apply(absrb[sp]) * rf
               for sp in SPECIES[:-1]}
        # Rayleigh is active only above 820 cm^-1, where the plan refuses
        out["rayleigh"] = torch.zeros(batch + (len(self.wn),), dtype=dtype,
                                      device=self.device)
        return out
