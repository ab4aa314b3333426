"""MT_CKD v3.5 continuum — static host plan, gather-based device evaluation.

Port of `monortm_tpu.ops.continuum`.  The host half (`ContinuumFactors`,
`_window`, `_slice_table`, `_pre_xint` and the builders' numpy code) is
copied verbatim, so both packages slice the same table windows and build
the same XINT plans.  The device half evaluates each sub-continuum on
tensors and merges it with `DeviceXintPlan`s.

Every sub-continuum of the JAX package is ported: H2O self and foreign,
CO2 foreign, O3 (Chappuis/Wulf, Hartley-Huggins, UV), O2 (fundamental,
1.27 um, 1.06 um, A-band, visible, Herzberg, far UV), N2 (rotational,
fundamental, overtone) and Rayleigh.

`ContinuumPlan.__call__` is the eager version, which CPU and float64
states take.  A plan on a CUDA device also packs itself for the kernels
at build time (`kernel_pack`, `ops.continuum_kernel.pack`), and
`CONTINUUM_KERNEL` evaluates the continuum and the cloud of CUDA float32
states from it in one call each way (csrc/continuum.cu), bit for bit the
eager CUDA version's forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.data import loader
from monortm_tpu_torch.ops.arith import rdiv
from monortm_tpu_torch.ops.continuum_kernel import ContinuumKernel, pack
from monortm_tpu_torch.ops.planck import radfn
from monortm_tpu_torch.ops.xint import (DeviceXintPlan, XintPlan,
                                        build_xint_plan,
                                        build_xint_plan_points, _trunc)

SPECIES = ("h2o", "co2", "o3", "o2", "n2", "rayleigh")
CONTINUUM_KERNEL = ContinuumKernel()

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
        self._build_o3()
        self._build_o2()
        self._build_n2()
        self._build_rayleigh()
        self.kernel_pack = (pack(self) if torch.device(device).type == "cuda"
                            else None)

    # ----- plan helpers ---------------------------------------------------

    def _vj(self, v1c: float, dvc: float, nptc: int) -> np.ndarray:
        return v1c + dvc * np.arange(nptc, dtype=np.float64)

    def _append(self, name, species, plan: XintPlan, static: dict, fn):
        """Register one sub-continuum from its host plan and window."""
        dstatic = {k: torch.as_tensor(v, dtype=torch.float64,
                                      device=self.device)
                   for k, v in static.items()}
        self.subs.append(_SubContinuum(name, species, plan, static, fn,
                                       DeviceXintPlan(plan, self.device),
                                       dstatic))

    def _add(self, name, species, tab_key_or_arrays, fn, static_extra=None,
             eps=0.01, v1ss_override=None, v2ss_override=None,
             mask_absrb=None):
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
        ist, last = _pre_xint(v1ss_override if v1ss_override is not None
                              else v1s,
                              v2ss_override if v2ss_override is not None
                              else v2s,
                              self.v1abs, self.dvabs, self.nptabs)
        plan = build_xint_plan(v1c, dvs, nptc, self.v1abs, self.dvabs,
                               ist, last, self.nptabs)
        if mask_absrb is not None:
            keep = mask_absrb(plan.target_idx)
            plan = XintPlan(plan.target_idx[keep], plan.src_idx[keep],
                            plan.weights[keep], plan.n_src, plan.n_target)
        self._append(name, species, plan, static, fn)

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

    def _build_o3(self):
        f = self.factors
        t = loader.mt_ckd()
        if self.v2 > 8920.0 and self.v1 <= 24665.0 and f.xo3cn > 0:
            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"x": _slice_table(t["o3_chap_0"], i1, nptc) / safe,
                        "y": _slice_table(t["o3_chap_1"], i1, nptc) / safe,
                        "z": _slice_table(t["o3_chap_2"], i1, nptc) / safe}

            def fn(s, L):
                dt = L.b(L.tave - 273.15)
                wo3 = L.b(L.wk[..., 2]) * 1.0e-20 * f.xo3cn
                return (s["x"] + (s["y"] + s["z"] * dt) * dt) * wo3

            key = ("o3_chap", {}, (float(t["o3_chap_v1"]),
                                   float(t["o3_chap_v2"]),
                                   float(t["o3_chap_dv"]),
                                   int(t["o3_chap_npt"])))
            self._add("o3_chap", "o3", key, fn, static_extra=extra)

        i_fix = int(_trunc((40800.0 - self.v1abs) / self.dvabs + 1.001))

        if self.v2 > 27370.0 and self.v1 < 40800.0 and f.xo3cn > 0:
            def extra(static, i1, nptc, v1c, dvs):
                return {"ct1": _slice_table(t["o3_hh1"], i1, nptc),
                        "ct2": _slice_table(t["o3_hh2"], i1, nptc)}

            def fn(s, L):
                tc = L.b(L.tave - 273.15)
                wo3 = L.b(L.wk[..., 2]) * 1.0e-20 * f.xo3cn
                c = s["tab"] * wo3
                return c * (1.0 + s["ct1"] * tc + s["ct2"] * tc * tc)

            # replicate the ABSBSV save/restore (contnm.f90:579-599): the
            # Hartley-Huggins merge must not touch ABSRB at/above 40800
            mask = None
            if self.v2 > 40800.0:
                # determine the window's last vj to honour VJ>40815 gate
                v1s, v2s = float(t["o3_hh0_v1"]), float(t["o3_hh0_v2"])
                dvs, npts = float(t["o3_hh0_dv"]), int(t["o3_hh0_npt"])
                i1_, nptc_, v1c_ = _window(self.v1abs, self.v2abs, v1s, v2s,
                                           dvs, npts)
                vj_last = v1c_ + dvs * (nptc_ - 1)
                if vj_last > 40815.0:
                    mask = lambda ti: ti < (i_fix - 1)
            self._add("o3_hh", "o3", "o3_hh0", fn, static_extra=extra,
                      mask_absrb=mask)

        if self.v2 > 40800.0 and self.v1 < 54000.0 and f.xo3cn > 0:
            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"c0": static["tab"] / safe}

            def fn(s, L):
                wo3 = L.b(L.wk[..., 2]) * f.xo3cn    # no 1e-20 (contnm.f90:607)
                return s["c0"] * wo3

            mask = None
            if self.v1 < 40800.0:
                mask = lambda ti: ti >= (i_fix - 1)      # contnm.f90:620-640
            self._add("o3_uv", "o3", "o3_huv", fn, static_extra=extra,
                      mask_absrb=mask)

    def _build_o2(self):
        f = self.factors
        t = loader.mt_ckd()
        if not f.xo2cn > 0:
            return

        if self.v2 > 1340.0 and self.v1 < 1850.0:
            def extra(static, i1, nptc, v1c, dvs):
                return {"xo2t": _slice_table(t["o2_fund_1"], i1, nptc)}

            def fn(s, L):
                xktfac = L.b(1.0 / 296.0 - rdiv(1.0, L.tave))
                factor = 1.0e20 / cst.XLOSMT
                vj = torch.where(s["vj"] != 0.0, s["vj"], 1.0)
                tau_fac = L.b(L.wk[..., 6] * L.amagat) * 1.0e-20 * f.xo2cn
                return tau_fac * factor * s["tab"] * \
                    torch.exp(s["xo2t"] * xktfac) / vj

            key = ("o2_fund", {"tab": t["o2_fund_0"]},
                   (float(t["o2_fund_v1"]), float(t["o2_fund_v2"]),
                    float(t["o2_fund_dv"]), int(t["o2_fund_npt"])))
            self._add("o2_fund", "o2", key, fn, static_extra=extra)

        if self.v2 > 7536.0 and self.v1 < 8500.0:
            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"c0": static["tab"] / safe}

            def fn(s, L):
                a_o2, a_n2, a_h2o = 1.0 / 0.446, 0.3 / 0.446, 1.0
                tau = (L.b(L.wk[..., 6]) / cst.XLOSMT) * L.b(L.amagat) * \
                    f.xo2cn * L.b(a_o2 * L.x_o2 + a_n2 * L.x_n2
                                  + a_h2o * L.x_h2o)
                return tau * s["c0"]

            self._add("o2_inf1", "o2", "o2_inf1", fn, static_extra=extra)

        if self.v2 > 9100.0 and self.v1 < 11000.0:
            # O2INF2: fully analytic window (contnm.f90:9227-9279)
            v1s, v2s, dvs = 9100.0, 11000.0, 2.0
            v1c = self.v1abs - dvs
            v2c = self.v2abs + dvs
            if v1c < v1s:
                v1c = v1s - 2.0 * dvs
            if v2c > v2s:
                v2c = v2s + 2.0 * dvs
            nptc = int(_trunc((v2c - v1c) / dvs + 3.01))
            vj = v1c + dvs * np.arange(nptc, dtype=np.float64)
            c0 = np.zeros(nptc)
            inside = (vj > v1s) & (vj < v2s)
            v = vj[inside]
            dv1 = v - 9375.0
            dv2 = v - 9439.0
            damp1 = np.where(dv1 < 0, np.exp(dv1 / 176.1), 1.0)
            damp2 = np.where(dv2 < 0, np.exp(dv2 / 176.1), 1.0)
            o2inf = 0.31831 * (((1.166e-04 * damp1 / 58.96) / (1. + (dv1 / 58.96) ** 2))
                               + ((3.086e-05 * damp2 / 45.04) / (1. + (dv2 / 45.04) ** 2))) * 1.054
            c0[inside] = o2inf / v

            def fn(s, L):
                wo2 = L.b(L.wk[..., 6] * L.rhoave) * 1.0e-20 * f.xo2cn
                adj = L.b(L.x_o2) * (1.0 / 0.209) * wo2
                return s["c0"] * adj

            ist, last = _pre_xint(v1s, v2s, self.v1abs, self.dvabs,
                                  self.nptabs)
            plan = build_xint_plan(v1c, dvs, nptc, self.v1abs, self.dvabs,
                                   ist, last, self.nptabs)
            self._append("o2_inf2", "o2", plan, {"c0": c0, "vj": vj}, fn)

        if self.v2 > 12961.5 and self.v1 < 13221.5:
            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"c0": static["tab"] / safe}

            def fn(s, L):
                tau = (L.b(L.wk[..., 6]) / cst.XLOSMT) * L.b(L.amagat) \
                    * f.xo2cn
                return tau * s["c0"]

            self._add("o2_aband", "o2", "o2_inf3", fn, static_extra=extra)

        if self.v2 > 15000.0 and self.v1 < 29870.0:
            factor = 1.0 / ((cst.XLOSMT * 1.0e-20
                             * (55.0 * 273.0 / 296.0) ** 2) * 89.5)

            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"c0": factor * static["tab"] / safe}

            def fn(s, L):
                wo2 = L.b(L.wk[..., 6]) * 1.0e-20 * \
                    L.b((L.pave / 1013.0) * rdiv(273.0, L.tave)) * f.xo2cn
                adj = L.b(L.x_o2) * wo2
                return s["c0"] * adj

            self._add("o2_vis", "o2", "o2_vis", fn, static_extra=extra)

        if self.v2 > 36000.0:
            # Herzberg: analytic HERTDA cross-section, pressure-corrected
            # per layer by HERPRS (contnm.f90:9808-9950)
            v1s, dvs = 36000.0, 10.0
            v1c = self.v1abs - dvs
            v2c = self.v2abs + dvs
            i1 = -1 if v1c < v1s else int(_trunc((v1c - v1s) / dvs + 0.01))
            v1c = v1s + dvs * (i1 - 1)
            i2 = int(_trunc((v2c - v1s) / dvs + 0.01))
            nptc = i2 - i1 + 3
            vj = v1c + dvs * np.arange(nptc, dtype=np.float64)
            herz = np.zeros(nptc)
            valid = (np.arange(nptc) + i1 >= 1) & (vj > 36000.0)
            v = vj[valid]
            corr = np.where(v <= 40000.0,
                            ((40000.0 - v) / 4000.0) * 7.917e-07, 0.0)
            yratio = v / 48811.0
            herz[valid] = (6.884e-04 * yratio
                           * np.exp(-69.738 * np.log(yratio) ** 2)
                           - corr) / v

            def fn(s, L):
                po = 1013.0
                to = 273.16
                prs = 1.0 + 0.83 * L.b(L.pave) / po * rdiv(to, L.b(L.tave))
                wo2 = L.b(L.wk[..., 6]) * 1.0e-20 * f.xo2cn
                return s["c0"] * prs * wo2

            ist, last = _pre_xint(v1s, 99999.0, self.v1abs, self.dvabs,
                                  self.nptabs)
            plan = build_xint_plan(v1c, dvs, nptc, self.v1abs, self.dvabs,
                                   ist, last, self.nptabs)
            self._append("o2_herz", "o2", plan, {"c0": herz, "vj": vj}, fn)

        if self.v2 > 56740.0:
            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"c0": static["tab"] / safe}

            def fn(s, L):
                wo2 = L.b(L.wk[..., 6]) * 1.0e-20 * f.xo2cn
                return s["c0"] * wo2

            self._add("o2_fuv", "o2", "o2_fuv", fn, static_extra=extra,
                      eps=1e-5)

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

        if self.v2 > 2001.77 and self.v1 < 2897.59:
            def extra(static, i1, nptc, v1c, dvs):
                return {"x228": _slice_table(t["n2_fund_1"], i1, nptc),
                        "a_h2o": _slice_table(t["n2_fund_2"], i1, nptc)}

            def fn(s, L):
                x272 = s["tab"]
                x228 = s["x228"]
                vj = torch.where(s["vj"] != 0.0, s["vj"], 1.0)
                xtfac = L.b((rdiv(1.0, L.tave) - (1.0 / 272.0))
                            / ((1.0 / 228.0) - (1.0 / 272.0)))
                xt_lin = L.b((L.tave - 272.0) / (228.0 - 272.0))
                both = (x272 > 0.0) & (x228 > 0.0)
                c_log = torch.where(
                    both, x272 * (torch.where(both, x228, 1.0)
                                  / torch.where(both, x272, 1.0)) ** xtfac,
                    0.0)
                c_lin = x272 + (x228 - x272) * xt_lin
                cbase = torch.where(both, c_log, c_lin) / vj
                a_o2 = L.b(1.294 - 0.4545 * L.tave / 296.0)
                c1 = a_o2 * cbase
                c2 = (9.0 / 7.0) * s["a_h2o"] * cbase
                tau = f.xn2cn * (L.b(L.wn2) / cst.XLOSMT) * L.b(L.amagat)
                return tau * (L.b(L.x_n2) * cbase + L.b(L.x_o2) * c1
                              + L.b(L.x_h2o) * c2)

            key = ("n2_fund", {"tab": t["n2_fund_0"]},
                   (float(t["n2_fund_v1"]), float(t["n2_fund_v2"]),
                    float(t["n2_fund_dv"]), int(t["n2_fund_npt"])))
            self._add("n2_fund", "n2", key, fn, static_extra=extra)

        if self.v2 > 4340.0 and self.v1 < 4910.0:
            def extra(static, i1, nptc, v1c, dvs):
                vj = static["vj"]
                safe = np.where(vj != 0.0, vj, 1.0)
                return {"c0": static["tab"] / safe}

            def fn(s, L):
                tau = f.xn2cn * (L.b(L.wn2) / cst.XLOSMT) * L.b(L.amagat) * \
                    L.b(L.x_n2 + L.x_o2 + L.x_h2o)
                return tau * s["c0"]

            self._add("n2_overtone", "n2", "n2_overtone", fn,
                      static_extra=extra)

    def _build_rayleigh(self):
        f = self.factors
        self.rayleigh_base = None
        if self.v2 >= 820.0 and f.xrayl > 0:
            # direct ABSRB-grid formulation (contnm.f90:1107-1129), jrad=0:
            # stored value = base * xv / radfn, then modm multiplies the
            # interpolated result by wn/1e4 (modm.f90:243-245 — replicated
            # verbatim, including that radiation-term asymmetry)
            v = self.v1abs + self.dvabs * np.arange(self.nptabs)
            xv = v / 1.0e4
            conv = f.xrayl * 1.0e-20 / (2.68675e-1 * 1.0e5)
            base = (xv**3 / (9.38076e2 - 10.8426 * xv**2)) * conv * xv
            self.rayleigh_base = tuple(
                torch.as_tensor(a, dtype=torch.float64, device=self.device)
                for a in (v, base))

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
        if self.rayleigh_base is not None:
            v, base = self.rayleigh_base
            ray_absrb = (base.to(dtype) * L.wtot[..., None]
                         / radfn(v.to(dtype), L.xkt[..., None]))
            ray = self.dstage2.apply(ray_absrb.to(dtype))
            out["rayleigh"] = ray * (self.wn_t / 1.0e4).to(dtype)
        else:
            out["rayleigh"] = torch.zeros(batch + (len(self.wn),),
                                          dtype=dtype, device=self.device)
        return out
