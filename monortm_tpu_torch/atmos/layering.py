"""Atmospheric path engine — the LBLATM equivalent (host side, NumPy f64).

Builds layered path states (density-weighted PBAR/TBAR, per-molecule column
amounts, level values) from either the six built-in model atmospheres or a
user-supplied profile, including refracted-ray geometry and automatic
layering.  This stage is small, sequential and precision-sensitive, so it
runs on the host; its output is the host layered state (`host_types.HostState`)
that the pipeline stacks and uploads to the device forward model.

A copy of `monortm_tpu.atmos.layering`.  Where the JAX package calls its
native C++ helper, this copy calls the port's (`monortm_tpu_torch.native`,
built from a copy of the same source): the AMERGE walk (`amerge_walk`)
and the whole-path RFPATH/ALAYER integration (`rfpath_integrate`).  With
MONORTM_TPU_TORCH_NATIVE=0 it takes the Python walks, the helper's
oracle.  The JAX package's per-interval `alayer_integrate` branch serves
only a library without `rfpath_integrate`; the port's always has it, so
that branch is not copied.

Reference parity (lblatm.f90):
  ATMPTH     :212    driver: slant/horizontal branches, totals, packing
  MDLATM     :2918   model atmospheres -> densities
  RDUNIT etc :3222   generic units (JCHAR), CONVRT/WATVAP conversions
  DEFALT     :3489   fill from model atmospheres (4-pt Lagrange in z)
  DEFALT_P   :3688   same driven by pressure
  CMPALT     :7896   hydrostatic altitude (Ciddor compressibility)
  FSCGEO     :4140   geometry normalisation (cases 2A-2D, 3A, 3B)
  FNDHMN     :4678   tangent height by Newton iteration
  NEWH2      :7468   H2 from H1/ANGLE/RANGE (RTBIS + FNDPTH)
  FDBETA     :4499   iterate angle to match earth-centred angle BETA
  RFPATH     :4917   refracted ray trace (AMERGE + ALAYER)
  ALAYER     :5289   sub-step Snell integration with Curtis-Godson sums
  AUTLAY     :5582   automatic layer boundaries (Voigt-ratio/deltaT tests)
  FPACK      :5891   pack ray segments into output layers, 0.1% zeroing
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch import native
from monortm_tpu_torch.data import loader

MXMOL = 39
KMXNOM = 7
DELTAS = 5.0          # nominal slant-path increment, km (lblatm.f90:1766)
PZERO = 1013.25
TZERO = 273.15
ALZERO = 0.04         # mean Lorentz halfwidth at STP (lblatm.f90:1773)
AVMWT = 36.0
DEG = 180.0 / cst.PI
GCAIR = 1.0e-3 * cst.GASCON / cst.AVOGAD     # lblatm.f90:525
ADCON = math.sqrt(2.0 * math.log(2.0) * cst.GASCON / cst.CLIGHT**2)

# molecular weights (lblatm.f90:1797-1807)
AMWT = np.array([
    18.015, 44.010, 47.998, 44.01, 28.011, 16.043, 31.999, 30.01,
    64.06, 46.01, 17.03, 63.01, 17.00, 20.01, 36.46, 80.92,
    127.91, 51.45, 60.08, 30.03, 52.46, 28.014, 27.03, 50.49,
    34.01, 26.03, 30.07, 34.00, 66.01, 146.05, 34.08, 46.03,
    33.00, 15.99, 98.0, 30.00, 97.0, 28.05, 32.04])

ATMNAM = ["TROPICAL", "MIDLATITUDE SUMMER", "MIDLATITUDE WINTER",
          "SUBARCTIC SUMMER", "SUBARCTIC WINTER", "U. S. STANDARD, 1976"]


def expint(x1, x2, a):
    """Exponential interpolation (monortm_sub.F90:1213-1223)."""
    if x1 == 0.0 or x2 == 0.0:
        return x1 + (x2 - x1) * a
    return x1 * (x2 / x1) ** a


def expint_vec(x1, x2, a):
    """expint over arrays (linear where either endpoint is 0)."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    lin = (x1 == 0.0) | (x2 == 0.0)
    safe1 = np.where(lin, 1.0, x1)
    safe2 = np.where(lin, 1.0, x2)
    return np.where(lin, x1 + (x2 - x1) * a, safe1 * (safe2 / safe1) ** a)


# ----------------------------------------------------------------------
# profile construction
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ModelProfile:
    """The ZMDL-grid profile (COMMON /CMN/ + /DEAMT/ equivalents)."""
    zmdl: np.ndarray          # [IM]
    pm: np.ndarray
    tm: np.ndarray
    denm: np.ndarray          # [nmol, IM] number densities (cm^-3)
    denw: np.ndarray          # [IM] water number density
    rfndxm: np.ndarray | None = None
    hmod: str = ""

    @property
    def immax(self):
        return len(self.zmdl)


def load_model_atmosphere(mdl: int, nmol: int, hspace: float = 100.0
                          ) -> ModelProfile:
    """Built-in atmospheres 1..6 (MDLATM, lblatm.f90:2975-3035)."""
    t = loader._load("mlatm")
    alt = t["alt"]
    pm = t["pmdl"][mdl - 1]
    tm = t["tmdl"][mdl - 1]
    amol = t["amol"][mdl - 1]      # [8, 50] ppmv profiles + air density
    trac = t["trac"]               # [21, 50]

    immax = 50
    denm = np.zeros((MXMOL, immax))
    # dry air from the *nominal* H2O density (ppmv x total air), but the
    # stored H2O density is then ppmv x DRYAIR: the reference's
    # `DO 10 K=1,7` loop starts at K=1 and overwrites DENM(1,:)
    # (lblatm.f90:2988-2992) — a quirk, kept for parity; verified against
    # the reference-generated MONORTM_PROF.IN_sav layer amounts
    # (tests/test_layering_oracle.py)
    dryair = amol[7] * (1.0 - amol[0] * 1.0e-6)
    for k in range(1, min(nmol, 7) + 1):
        denm[k - 1] = amol[k - 1] * 1.0e-6 * dryair
    denw_ = denm[0].copy()
    for k in range(8, min(nmol, 28) + 1):
        denm[k - 1] = trac[k - 8] * 1.0e-6 * dryair

    # truncate at HSPACE (lblatm.f90:3019-3032)
    ispace = int(np.max(np.nonzero(hspace + 0.001 > alt)[0])) + 1
    return ModelProfile(zmdl=alt[:ispace].copy(), pm=pm[:ispace].copy(),
                        tm=tm[:ispace].copy(), denm=denm[:, :ispace].copy(),
                        denw=denw_[:ispace].copy(), hmod=ATMNAM[mdl - 1])


def _densat(atemp, b):
    """Saturation water density helper (lblatm.f90:4048)."""
    c1, c2, c3 = 18.9766, -14.9595, -2.4388
    return atemp * b * math.exp(c1 + c2 * atemp + c3 * atemp**2) * 1.0e-6


def _default_interp_z(z, junitp, junitt, junit, nmol):
    """DEFALT: model-atmosphere values at altitude z (lblatm.f90:3489-3683).

    Returns (p_or_None, t_or_None, wmol_overrides dict k->ppmv).
    """
    t = loader._load("mlatm")
    alt = t["alt"]
    im50 = 50
    i2 = im50
    for im in range(1, im50):
        if alt[im] >= z:
            i2 = im
            break
    i1, i0, i3 = i2 - 1, i2 - 2, i2 + 1
    iupper = 0
    if i0 < 0:
        i0, i1, i2, i3 = i1, i2, i3, i3 + 1
    elif i3 > im50 - 1:
        if z > alt[im50 - 1]:
            raise ValueError(f"Z = {z} above 120 km with model defaults")
        i3, i2, i1 = i2, i1, i0
        i0 = i1 - 1

    z0, z1, z2, z3 = alt[i0], alt[i1], alt[i2], alt[i3]
    den1 = (z0 - z1) * (z0 - z2) * (z0 - z3)
    den2 = (z1 - z2) * (z1 - z3) * (z1 - z0)
    den3 = (z2 - z3) * (z2 - z0) * (z2 - z1)
    den4 = (z3 - z0) * (z3 - z1) * (z3 - z2)
    a1 = (z - z1) * (z - z2) * (z - z3) / den1
    a2 = (z - z2) * (z - z3) * (z - z0) / den2
    a3 = (z - z3) * (z - z0) * (z - z1) / den3
    a4 = (z - z0) * (z - z1) * (z - z2) / den4

    def val(x0, x1_, x2_, x3_):
        return a1 * x0 + a2 * x1_ + a3 * x2_ + a4 * x3_

    p_out = t_out = None
    if junitp <= 6:
        lp = np.log(t["pmdl"][junitp - 1])
        p_out = math.exp(val(lp[i0], lp[i1], lp[i2], lp[i3]))
    if junitt <= 6:
        tm = t["tmdl"][junitt - 1]
        t_out = val(tm[i0], tm[i1], tm[i2], tm[i3])
    wmol = {}
    for k in range(1, nmol + 1):
        ju = junit.get(k, 10)
        if ju > 6:
            continue
        if k <= 7:
            prof = t["amol"][ju - 1][k - 1]
        else:
            prof = t["trac"][k - 8]
        wmol[k] = val(prof[i0], prof[i1], prof[i2], prof[i3])
    return p_out, t_out, wmol


def _default_interp_p(p, junitt, junit, nmol):
    """DEFALT_P: model values at pressure p (lblatm.f90:3688-3879)."""
    t = loader._load("mlatm")
    xlogp = np.log(p)
    t_out = None
    wmol = {}
    for j_mdl in range(1, 7):
        pm = t["pmdl"][j_mdl - 1]
        lvl50 = 50
        i2 = lvl50
        for lvl in range(1, lvl50):
            if p >= pm[lvl]:
                i2 = lvl
                break
        i1, i0, i3 = i2 - 1, i2 - 2, i2 + 1
        if i0 < 0:
            i0, i1, i2, i3 = i1, i2, i3, i3 + 1
        elif i3 > lvl50 - 1:
            if p > pm[lvl50 - 1]:
                i3, i2, i1 = i2, i1, i0
                i0 = i1 - 1
            else:
                raise ValueError("P above model top")
        lp = np.log(pm)
        p0, p1, p2, p3 = lp[i0], lp[i1], lp[i2], lp[i3]
        den1 = (p0 - p1) * (p0 - p2) * (p0 - p3)
        den2 = (p1 - p2) * (p1 - p3) * (p1 - p0)
        den3 = (p2 - p3) * (p2 - p0) * (p2 - p1)
        den4 = (p3 - p0) * (p3 - p1) * (p3 - p2)
        a1 = (xlogp - p1) * (xlogp - p2) * (xlogp - p3) / den1
        a2 = (xlogp - p2) * (xlogp - p3) * (xlogp - p0) / den2
        a3 = (xlogp - p3) * (xlogp - p0) * (xlogp - p1) / den3
        a4 = (xlogp - p0) * (xlogp - p1) * (xlogp - p2) / den4

        def val(prof):
            return (a1 * prof[i0] + a2 * prof[i1] + a3 * prof[i2]
                    + a4 * prof[i3])

        if junitt <= 6 and junitt == j_mdl:
            t_out = val(t["tmdl"][j_mdl - 1])
        for k in range(1, nmol + 1):
            ju = junit.get(k, 10)
            if ju > 6 or ju != j_mdl:
                continue
            prof = t["amol"][ju - 1][k - 1] if k <= 7 else t["trac"][k - 8]
            wmol[k] = val(prof)
    return t_out, wmol


def convert_units(p, t, junit, wmol, nmol):
    """CONVRT + WATVAP: generic units -> number densities [cm^-3]
    (lblatm.f90:3884-4136)."""
    denm = np.zeros(MXMOL)
    rhoair = cst.ALOSMT * (p / PZERO) * (TZERO / t)
    a = TZERO / t
    b1 = cst.AVOGAD / AMWT[0]
    r1 = cst.AIRMWT / AMWT[0]

    ju = junit.get(1, 10)
    w = wmol.get(1, 0.0)
    if ju == 10:
        w = w * 1.0e-6
        denm[0] = (w / (1.0 + w)) * rhoair
    elif ju == 11:
        denm[0] = w
    elif ju == 12:
        w = w * r1 * 1.0e-3
        denm[0] = (w / (1.0 + w)) * rhoair
    elif ju == 13:
        denm[0] = b1 * w * 1.0e-6
    elif ju == 14:
        denm[0] = cst.ALOSMT * (w / PZERO) * (TZERO / t)
    elif ju == 15:
        atd = TZERO / w
        denm[0] = _densat(atd, b1) * w / t
    elif ju == 16:
        atd = TZERO / (TZERO + w)
        denm[0] = _densat(atd, b1) * (TZERO + w) / t
    elif ju == 17:
        denm[0] = _densat(a, b1) * (w / 100.0)
    else:
        raise ValueError(f"WATVAP: bad junit {ju}")

    dryair = rhoair - denm[0]
    for k in range(2, nmol + 1):
        ju = junit.get(k, 10)
        w = wmol.get(k, 0.0)
        b = cst.AVOGAD / AMWT[k - 1]
        r = cst.AIRMWT / AMWT[k - 1]
        if ju <= 10:
            denm[k - 1] = w * dryair * 1.0e-6
        elif ju == 11:
            denm[k - 1] = w
        elif ju == 12:
            denm[k - 1] = r * w * 1.0e-3 * dryair
        elif ju == 13:
            denm[k - 1] = b * w * 1.0e-6
        elif ju == 14:
            denm[k - 1] = cst.ALOSMT * (w / PZERO) * (TZERO / t)
        else:
            raise ValueError(f"CONVRT: bad junit {ju}")
    return denm


def _densat_vec(atemp, b):
    """Vectorized saturation water density (lblatm.f90:4048)."""
    c1, c2, c3 = 18.9766, -14.9595, -2.4388
    return atemp * b * np.exp(c1 + c2 * atemp + c3 * atemp**2) * 1.0e-6


def convert_units_vec(p, t, junit, wmol, nmol):
    """Vectorized CONVRT + WATVAP over a level axis.

    p, t: [L]; wmol: [L, >=nmol]; junit: dict k -> junit code, uniform
    across levels (the fast path for machine-generated profiles — the
    scalar `convert_units` remains the general/oracle path).
    Returns denm [MXMOL, L].
    """
    p = np.asarray(p, np.float64)
    t = np.asarray(t, np.float64)
    L = len(p)
    denm = np.zeros((MXMOL, L))
    rhoair = cst.ALOSMT * (p / PZERO) * (TZERO / t)
    a = TZERO / t
    b1 = cst.AVOGAD / AMWT[0]
    r1 = cst.AIRMWT / AMWT[0]

    ju = junit.get(1, 10)
    w = np.asarray(wmol[:, 0], np.float64)
    if ju == 10:
        w = w * 1.0e-6
        denm[0] = (w / (1.0 + w)) * rhoair
    elif ju == 11:
        denm[0] = w
    elif ju == 12:
        w = w * r1 * 1.0e-3
        denm[0] = (w / (1.0 + w)) * rhoair
    elif ju == 13:
        denm[0] = b1 * w * 1.0e-6
    elif ju == 14:
        denm[0] = cst.ALOSMT * (w / PZERO) * (TZERO / t)
    elif ju == 15:
        atd = TZERO / w
        denm[0] = _densat_vec(atd, b1) * w / t
    elif ju == 16:
        atd = TZERO / (TZERO + w)
        denm[0] = _densat_vec(atd, b1) * (TZERO + w) / t
    elif ju == 17:
        denm[0] = _densat_vec(a, b1) * (w / 100.0)
    else:
        raise ValueError(f"WATVAP: bad junit {ju}")

    dryair = rhoair - denm[0]
    for k in range(2, nmol + 1):
        ju = junit.get(k, 10)
        w = np.asarray(wmol[:, k - 1], np.float64)
        b = cst.AVOGAD / AMWT[k - 1]
        r = cst.AIRMWT / AMWT[k - 1]
        if ju <= 10:
            denm[k - 1] = w * dryair * 1.0e-6
        elif ju == 11:
            denm[k - 1] = w
        elif ju == 12:
            denm[k - 1] = r * w * 1.0e-3 * dryair
        elif ju == 13:
            denm[k - 1] = b * w * 1.0e-6
        elif ju == 14:
            denm[k - 1] = cst.ALOSMT * (w / PZERO) * (TZERO / t)
        else:
            raise ValueError(f"CONVRT: bad junit {ju}")
    return denm


def _lagrange4_idx(i2):
    """4-point stencil base indices with the DEFALT boundary shifts: the
    scalar code's i0<0 / i3>49 adjustments are equivalent to clipping the
    centre to [2, 48]."""
    base = np.clip(i2, 2, 48)
    return base - 2, base - 1, base, base + 1


def _lagrange4_weights(x, x0, x1, x2, x3):
    a1 = (x - x1) * (x - x2) * (x - x3) / ((x0 - x1) * (x0 - x2) * (x0 - x3))
    a2 = (x - x2) * (x - x3) * (x - x0) / ((x1 - x2) * (x1 - x3) * (x1 - x0))
    a3 = (x - x3) * (x - x0) * (x - x1) / ((x2 - x3) * (x2 - x0) * (x2 - x1))
    a4 = (x - x0) * (x - x1) * (x - x2) / ((x3 - x0) * (x3 - x1) * (x3 - x2))
    return a1, a2, a3, a4


def default_interp_z_vec(z, junitp, junitt, junit, nmol):
    """Vectorized DEFALT over altitudes z [L] (uniform unit codes).

    Returns (p [L] or None, t [L] or None, {k: [L]} overrides).
    """
    t = loader._load("mlatm")
    alt = t["alt"]
    z = np.asarray(z, np.float64)
    if np.any(z > alt[49]):
        raise ValueError("Z above 120 km with model defaults")
    i2 = np.clip(np.searchsorted(alt, z, side="left"), 1, 49)
    i0, i1, i2b, i3 = _lagrange4_idx(i2)
    a1, a2, a3, a4 = _lagrange4_weights(z, alt[i0], alt[i1], alt[i2b],
                                        alt[i3])

    def val(prof):
        prof = np.asarray(prof, np.float64)
        return a1 * prof[i0] + a2 * prof[i1] + a3 * prof[i2b] + a4 * prof[i3]

    p_out = t_out = None
    if junitp <= 6:
        p_out = np.exp(val(np.log(t["pmdl"][junitp - 1])))
    if junitt <= 6:
        t_out = val(t["tmdl"][junitt - 1])
    wmol = {}
    for k in range(1, nmol + 1):
        ju = junit.get(k, 10)
        if ju > 6:
            continue
        prof = t["amol"][ju - 1][k - 1] if k <= 7 else t["trac"][k - 8]
        wmol[k] = val(prof)
    return p_out, t_out, wmol


def default_interp_p_vec(p, junitt, junit, nmol):
    """Vectorized DEFALT_P over pressures p [L] (uniform unit codes)."""
    t = loader._load("mlatm")
    p = np.asarray(p, np.float64)
    t_out = None
    wmol = {}
    need = set()
    if junitt <= 6:
        need.add(junitt)
    for k in range(1, nmol + 1):
        ju = junit.get(k, 10)
        if ju <= 6:
            need.add(ju)
    for j_mdl in sorted(need):
        pm = t["pmdl"][j_mdl - 1]              # descending
        hits = p[:, None] >= pm[None, 1:50]
        if not np.all(hits.any(axis=1)):
            raise ValueError("P above model top")
        i2 = np.argmax(hits, axis=1) + 1
        # scalar DEFALT_P raises when p sits exactly on the top level
        # (i3 > 49 and not p > pm[49]) — keep parity
        if np.any((i2 == 49) & ~(p > pm[49])):
            raise ValueError("P above model top")
        i0, i1, i2b, i3 = _lagrange4_idx(i2)
        lp = np.log(pm)
        xlogp = np.log(p)
        a1, a2, a3, a4 = _lagrange4_weights(xlogp, lp[i0], lp[i1],
                                            lp[i2b], lp[i3])

        def val(prof):
            prof = np.asarray(prof, np.float64)
            return (a1 * prof[i0] + a2 * prof[i1] + a3 * prof[i2b]
                    + a4 * prof[i3])

        if junitt == j_mdl:
            t_out = val(t["tmdl"][j_mdl - 1])
        for k in range(1, nmol + 1):
            if junit.get(k, 10) != j_mdl:
                continue
            prof = t["amol"][j_mdl - 1][k - 1] if k <= 7 else t["trac"][k - 8]
            wmol[k] = val(prof)
    return t_out, wmol


_JCHAR_MAP = {"1": 1, "2": 2, "3": 3, "4": 4, "5": 5, "6": 6,
              " ": 10, "A": 10, "B": 11, "C": 12, "D": 13, "E": 14,
              "F": 15, "G": 16, "H": 17, "I": 18, "J": 19, "K": 20}


def jou(char: str) -> int:
    """JCHAR -> JUNIT (lblatm.f90:3402-3434)."""
    c = char.upper() if char != " " else " "
    if char == " ":
        c = " "
    if c not in _JCHAR_MAP:
        raise ValueError(f"invalid JCHAR {char!r}")
    return _JCHAR_MAP[c]


def check_pt(value, ia, key):
    """CHECK: P/T unit conversions (lblatm.f90:3438-3485)."""
    if ia <= 10:
        return value
    if key == 1:   # pressure
        if ia == 11:
            return value * 1013.25
        if ia == 12:
            return value * 1013.25 / 760.0
        raise ValueError("CHECK(P)")
    if key == 2:   # temperature
        if ia <= 11:
            return value + 273.15
        raise ValueError("CHECK(T)")
    raise ValueError("CHECK key")


def cmpalt(pm, tm, denw, ref_z, ref_lat, re=6371.23):
    """Hydrostatic altitudes from P,T,H2O (CMPALT, lblatm.f90:7896-8016)."""
    pm = np.asarray(pm, np.float64)
    tm = np.asarray(tm, np.float64)
    denw = np.asarray(denw, np.float64)
    n = len(pm)
    xmass_h2o = cst.WVMWT * 1.0e-3
    xmass_dry = cst.AIRMWT * 1.0e-3
    xmass_ratio = xmass_h2o / xmass_dry
    g0 = cst.grav_const(ref_lat)

    ca0, ca1, ca2 = 1.58123e-6, -2.9331e-8, 1.1043e-10
    cb0, cb1 = 5.707e-6, -2.051e-8
    cc0, cc1 = 1.9898e-4, -2.376e-6
    cd, ce = 1.83e-11, -0.0765e-8

    h2o_mixrat = np.zeros(n)
    comp = np.zeros(n)
    for j in range(n):
        dt = tm[j] - 273.15
        total_air = pm[j] * 1.0e3 / (cst.BOLTZ * tm[j])
        dry_air = total_air - denw[j]
        h2o_mixrat[j] = denw[j] / dry_air
        chim = xmass_ratio * h2o_mixrat[j]
        comp[j] = 1.0 - (pm[j] * 100 / tm[j]) * (
            ca0 + ca1 * dt + ca2 * dt**2 + (cb0 + cb1 * dt) * chim
            + (cc0 + cc1 * dt) * chim**2) \
            + (cd + ce * chim**2) * (pm[j] * 100.0 / tm[j])**2

    zmdl = np.zeros(n)
    ztemp = np.zeros(n)
    ztemp[0] = ref_z * 1000.0
    zmdl[0] = ref_z
    for i in range(n - 1):
        gave = g0 * (re / (re + ztemp[i] / 1000.0))**2
        y = math.log(pm[i + 1] / pm[i])
        if y != 0.0:
            chi0 = h2o_mixrat[i]
            dchi = (h2o_mixrat[i + 1] - h2o_mixrat[i]) / y
            t0 = tm[i]
            dt = (tm[i + 1] - tm[i]) / y
            c1 = t0 + t0 * chi0
            c2 = t0 * dchi + dt * chi0 + dt
            c3 = dt * dchi
            b = 1 + xmass_ratio * chi0
            a = xmass_ratio * dchi
            alpha = a / b
            if abs(alpha * y) >= 0.01:
                raise ValueError("LAYER TOO THICK (CMPALT)")
            xint_tot = c1 * y + 0.5 * (c2 - c1 * alpha) * y**2 \
                + 0.3333 * (c3 - c2 * alpha + c1 * alpha**2) * y**3
            xint_tot = -xint_tot * (cst.GASCON * 1.0e-7) / (
                xmass_dry * gave * b)
            ztemp[i + 1] = ztemp[i] + xint_tot * comp[i]
            zmdl[i + 1] = ztemp[i + 1] / 1000.0
        else:
            ztemp[i + 1] = zmdl[i] * 1000.0
            zmdl[i + 1] = zmdl[i]
    return zmdl


# ----------------------------------------------------------------------
# refraction helpers
# ----------------------------------------------------------------------

def refractivity(prof: ModelProfile, xvbar: float) -> np.ndarray:
    """LOWTRAN6 refractivity (index-1) on the ZMDL grid
    (lblatm.f90:1112-1127)."""
    pph2o = prof.denm[0] * PZERO * prof.tm / (TZERO * cst.ALOSMT)
    return ((83.42 + (185.08 / (1.0 - (xvbar / 1.14e+5)**2))
             + (4.11 / (1.0 - (xvbar / 6.24e+4)**2)))
            * (prof.pm * 288.15) / (1013.25 * prof.tm)
            - (43.49 - (xvbar / 1.7e+4)**2) * (pph2o / 1013.25)) * 1.0e-6


class Refraction:
    """Exponential refractivity interpolation (FINDSH/SCALHT/ANDEX)."""

    def __init__(self, zmdl, rfndxm, re):
        self.zmdl = np.asarray(zmdl)
        self.rfndxm = np.asarray(rfndxm)
        self.re = re

    def scalht(self, z1, z2, r1, r2):
        rf1 = r1 + 1.0e-20
        rf2 = r2 + 1.0e-20
        ratio = rf1 / rf2
        if abs(ratio - 1.0) < 1.0e-5:
            return 0.0, r1
        sh = (z2 - z1) / math.log(ratio)
        gamma = rf1 * (rf2 / rf1) ** (-z1 / (z2 - z1))
        return sh, gamma

    def findsh(self, h):
        i2 = len(self.zmdl) - 1
        for im in range(1, len(self.zmdl)):
            if self.zmdl[im] >= h:
                i2 = im
                break
        i1 = i2 - 1
        return self.scalht(self.zmdl[i1], self.zmdl[i2],
                           self.rfndxm[i1], self.rfndxm[i2])

    @staticmethod
    def andex(h, sh, gamma):
        if sh == 0.0:
            return 1.0 + gamma
        return 1.0 + gamma * math.exp(-h / sh)

    @staticmethod
    def radref(h, sh, gamma):
        if sh == 0.0:
            return 1.0e36
        return sh * (1.0 + math.exp(h / sh) / gamma)

    def crfrct(self, h):
        sh, gamma = self.findsh(h)
        return (self.re + h) * self.andex(h, sh, gamma)


# ----------------------------------------------------------------------
# path engine
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PathResult:
    """FPACK output: the /PATHD/ payload (lblatm.f90:5954-6046)."""
    pbar: np.ndarray        # [L]
    tbar: np.ndarray
    amount: np.ndarray      # [nmol, L]
    wn2l: np.ndarray        # broadening column per layer
    rhosum: np.ndarray
    altz: np.ndarray        # [L+1] level altitudes, altz[0]=bottom
    pz: np.ndarray
    tz: np.ndarray
    ipath: np.ndarray
    secnta: np.ndarray
    zout: np.ndarray
    h1: float = 0.0
    h2: float = 0.0
    angle: float = 0.0
    phi: float = 0.0
    hmin: float = 0.0
    bendng: float = 0.0
    len_: int = 0


class PathEngine:
    """Refracted-path integration over one ModelProfile."""

    def __init__(self, prof: ModelProfile, xvbar: float, re: float,
                 nmol: int, zmax: float | None = None):
        self.prof = prof
        self.nmol = nmol
        self.re = re
        self.zmin = prof.zmdl[0]
        self.zmax = zmax if zmax is not None else prof.zmdl[-1]
        prof.rfndxm = refractivity(prof, xvbar)
        self.refr = Refraction(prof.zmdl, prof.rfndxm, re)

    # ---------------- geometry (FSCGEO family) ----------------

    def fndhmn(self, h1, angle, h2, len_, iter_):
        """FNDHMN (lblatm.f90:4678-4800): returns (h2, len_, hmin, phi)."""
        r = self.refr
        dh, eta = 0.2, 5.0e-7
        sh, gamma = r.findsh(h1)
        cpath = r.crfrct(h1) * math.sin(angle / DEG)
        ch2 = r.crfrct(h2)
        if abs(cpath / ch2) > 1.0:
            raise ValueError(
                "H2 is less than the tangent height for this path")
        if angle <= 90.0:
            hmin = h1
            len_ = 0
        else:
            if h1 <= h2:
                len_ = 1
            if len_ != 1:
                len_ = 0
                hmin = h2
            else:
                cmin = r.crfrct(0.0)
                if iter_ == 0 and cpath < cmin:
                    # tangent path intersects earth (lblatm.f90:4757-4765)
                    h2 = 0.0
                    hmin = 0.0
                    len_ = 0
                    ch2 = cmin
                    phi = math.asin(min(cpath / ch2, 1.0)) * DEG
                    if angle <= 90.0 or len_ == 1:
                        phi = 180.0 - phi
                    return h2, len_, hmin, phi
                ht1 = h1 * math.sin(angle / DEG) \
                    + (math.sin(angle / DEG) - 1.0) * self.re
                n = 0
                while True:
                    n += 1
                    ct1 = r.crfrct(ht1)
                    if abs((cpath - ct1) / cpath) < eta:
                        break
                    if n > 15:
                        raise RuntimeError("FNDHMN did not converge")
                    ctp = r.crfrct(ht1 - dh)
                    deriv = (ct1 - ctp) / dh
                    ht1 = ht1 + (cpath - ct1) / deriv
                hmin = ht1
        phi = math.asin(min(max(cpath / ch2, -1.0), 1.0)) * DEG
        if angle <= 90.0 or len_ == 1:
            phi = 180.0 - phi
        return h2, len_, hmin, phi

    def reduce(self, h1, h2, angle, phi):
        """REDUCE (lblatm.f90:4451-4495)."""
        if h1 <= self.zmax and h2 <= self.zmax:
            return h1, h2, angle, phi
        r = self.refr
        sh, gamma = r.findsh(h1)
        cpath = r.andex(h1, sh, gamma) * (self.re + h1) \
            * math.sin(angle / DEG)
        czmax = r.crfrct(self.zmax)
        angmax = 180.0 - math.asin(cpath / czmax) * DEG
        if h1 > self.zmax:
            h1 = self.zmax
            angle = angmax
        if h2 > self.zmax:
            h2 = self.zmax
            phi = angmax
        return h1, h2, angle, phi

    def rtbis(self, x1, cx1, x2, cx2, cpath):
        """RTBIS bisection for tangent height (lblatm.f90:7566-7610)."""
        r = self.refr
        fmid = cx2 - cpath
        f = cx1 - cpath
        if f * fmid >= 0.0:
            raise ValueError("root must be bracketed for bisection")
        if f < 0.0:
            rt, dx = x1, x2 - x1
        else:
            rt, dx = x2, x1 - x2
        for _ in range(40):
            dx *= 0.5
            xmid = rt + dx
            fmid = r.crfrct(xmid) - cpath
            if fmid <= 0.0:
                rt = xmid
            if abs(dx) < 1e-5 or fmid == 0.0:
                return rt
        return x2 if abs(cx2) < abs(cx1) else x1

    def fndpth(self, cpath, h1, htan, rangei, angle):
        """FNDPTH (lblatm.f90:7613-7760): (h2, rangei, beta, len_, phi)."""
        r = self.refr
        dr = 0.005
        if rangei < dr:
            raise ValueError("FNDPTH: range too small")
        rangeo = 0.0
        beta = 0.0
        ctheta = -1.0
        for i in (1, 2):
            if angle <= 90.0 and i == 1:
                continue
            if i == 1:
                r1, r2 = h1, htan
            else:
                if htan < 0.001 and angle > 90.0:
                    continue
                r2 = self.zmax
                r1 = h1 if angle <= 90.0 else htan
            dz = -dr if r2 < r1 else dr
            z = r1
            while z < r2:
                z2 = z
                rr = z + self.re
                sh, gamma = r.findsh(z2)
                rx = r.andex(z2, sh, gamma)
                stheta = min(max(cpath / (rx * rr), -1.0), 1.0)
                save = stheta
                ctheta = math.sqrt(1.0 - stheta**2)
                if r1 > r2:
                    ctheta = -ctheta
                ratio = -(rx * sh) / (rx - 1.0) if rx != 1.0 else -1e36
                caprj = -rr / ratio
                pntgrn = 1.0 / (1.0 - caprj * stheta * stheta)
                rpldr = rr + dz
                z2 = z + dz
                sh, gamma = r.findsh(z2)
                rx = r.andex(z2, sh, gamma)
                stheta = cpath / (rx * rpldr)
                cthet1 = ctheta
                ctheta = math.sqrt(max(1.0 - stheta**2, 0.0))
                if r1 > r2:
                    ctheta = -ctheta
                dx = ctheta * dz + (ctheta - cthet1) * rr
                drng = pntgrn * dx
                rangeo += drng
                dbeta = (((save + stheta) * 0.5) * (pntgrn * dx)) \
                    / (z - 0.5 * dz + self.re)
                beta += dbeta
                if rangeo >= rangei:
                    diff = rangei - (rangeo - drng)
                    h2 = z + (dz / drng) * diff
                    beta_deg = beta * DEG
                    if i == 2:
                        len_ = 1
                        if angle <= 90.0:
                            len_ = 0
                        if h2 < htan:
                            h2 = htan
                            len_ = 0
                    else:
                        len_ = 0
                    if rangei < 5.0 and rangeo / rangei > 1.05:
                        perp = math.sin(angle / DEG) * rangei
                        base = math.cos(angle / DEG) * rangei + self.re + h1
                        beta_deg = math.atan(perp / base) * DEG
                        h2 = math.cos(angle / DEG) * rangei + h1
                    phi = 180.0 - math.acos(ctheta) * DEG
                    return h2, rangei, beta_deg, len_, phi
                z += dz
        # reached ZMAX without consuming the range (lblatm.f90:7736-7758)
        rangei = rangeo
        h2 = self.zmax
        len_ = 0 if angle <= 90.0 else 1
        if htan < 0.001 and angle > 90.0:
            len_ = 0
            h2 = 0.0
        beta_deg = beta * DEG
        phi = 180.0 - math.acos(ctheta) * DEG
        return h2, rangei, beta_deg, len_, phi

    def newh2(self, h1, angle, rangei):
        """NEWH2 (lblatm.f90:7468-7560): (h2, range, beta, len_, htan, phi)."""
        r = self.refr
        cpath = r.crfrct(h1) * math.sin(angle / DEG)
        if angle == 90.0:
            htan = h1
        else:
            jmax = 0
            for j in range(self.prof.immax):
                if h1 >= self.prof.zmdl[j]:
                    jmax = j
            jmax += 1
            zj1 = self.prof.zmdl[min(jmax, self.prof.immax - 1)]
            cpj1 = r.crfrct(zj1)
            htan = -1.0
            for j in range(min(jmax, self.prof.immax - 1), -1, -1):
                if htan < 0.0:
                    if j == 0:
                        htan = 0.0
                    else:
                        cpj = cpj1
                        zj = zj1
                        zj1 = self.prof.zmdl[j - 1]
                        cpj1 = r.crfrct(zj1)
                        if cpj1 <= cpath <= cpj:
                            htan = self.rtbis(zj1, cpj1, zj, cpj, cpath)
        h2, rangei, beta, len_, phi = self.fndpth(cpath, h1, htan, rangei,
                                                  angle)
        if len_ == 0:
            htan = h2
        if angle <= 90.0:
            htan = min(h1, h2)
        return h2, rangei, beta, len_, htan, phi

    def fscgeo(self, h1, h2, angle, range_, beta, itype, len_, hobs=0.0):
        """FSCGEO (lblatm.f90:4140-4447).

        Returns dict with standard-form h1,h2,angle,phi,hmin,len.
        """
        iter_ = 0
        if itype not in (2, 3):
            raise ValueError(f"ITYPE must be 2 or 3, got {itype}")

        if itype == 3:
            if h2 == 0:
                h2 = self.zmax
                h2, len_, hmin, phi = self.fndhmn(h1, angle, h2, len_, iter_)
            else:
                hmin = h2
                h2 = self.zmax
                if h1 < hmin:
                    raise ValueError("H1 < HMIN in case 3B")
                _, len_, hmin, angle = self.fndhmn(hmin, 90.0, h1, len_,
                                                   iter_)
                _, len_, hmin, phi = self.fndhmn(hmin, 90.0, h2, len_,
                                                 iter_)
                if hmin < h1:
                    len_ = 1
        else:
            if range_ > 0.0:
                iselct = 23 if (h2 > 0.0 or angle == 0.0) else 22
            elif beta > 0.0:
                iselct = 24
            else:
                iselct = 21

            if iselct == 21:
                if h1 >= h2 and angle <= 90.0:
                    raise ValueError("case 2A: H1>=H2 with ANGLE<=90")
                if h1 == 0.0 and angle > 90.0:
                    raise ValueError("case 2A: path intersects the earth")
                h2st = h2
                h2, len_, hmin, phi = self.fndhmn(h1, angle, h2, len_,
                                                  iter_)
                if h2 != h2st:
                    raise ValueError("case 2A: cannot reach H2")
            elif iselct == 22:
                h2, range_, beta, len_, hmin, phi = self.newh2(h1, angle,
                                                               range_)
            elif iselct == 23:
                if abs(h1 - h2) > range_:
                    raise ValueError("case 2C: |H1-H2| > RANGE")
                r1 = h1 + self.re
                r2 = h2 + self.re
                zarg2 = (h1**2 - h2**2 + range_**2 + 2.0 * self.re *
                         (h1 - h2)) / (2.0 * r1 * range_)
                if 0.0 <= abs(zarg2) - 1.0 <= 1.0e-6:
                    zarg2 = math.copysign(1.0, zarg2)
                angle = 180.0 - math.acos(zarg2) * DEG
                zarg3 = (h2**2 - h1**2 + range_**2 + 2 * self.re *
                         (h2 - h1)) / (2.0 * r2 * range_)
                if 0.0 <= abs(zarg3) - 1.0 <= 1.0e-6:
                    zarg3 = math.copysign(1.0, zarg3)
                phi = 180.0 - math.acos(zarg3) * DEG
                beta = phi + angle - 180.0
                if range_ > 2.0 and beta > 0:
                    h1, h2, angle, phi, hmin, len_, beta = self.fdbeta(
                        h1, h2, beta, angle, phi, len_)
                else:
                    len_ = 1 if (angle > 90.0 and phi > 90.0) else 0
                    h2, len_, hmin, phi = self.fndhmn(h1, angle, h2, len_,
                                                      iter_)
            else:
                h1, h2, angle, phi, hmin, len_, beta = self.fdbeta(
                    h1, h2, beta, angle, 0.0, len_)

        len_ = 1 if hmin < min(h1, h2) else 0
        if hmin >= self.zmax:
            raise ValueError("entire path above atmosphere top")
        if h1 > self.zmax or h2 > self.zmax:
            h1, h2, angle, phi = self.reduce(h1, h2, angle, phi)
        return {"h1": h1, "h2": h2, "angle": angle, "phi": phi,
                "hmin": hmin, "len": len_, "beta": beta, "range": range_}

    def fdbeta(self, h1, h2, betas, angle, phi, len_):
        """FDBETA (lblatm.f90:4499-4674)."""
        tolrnc, itermx, betd = 5.0e-3, 10, 0.04
        beta = betas
        if h1 <= h2:
            iorder = 1
            ha, hb = h1, h2
        else:
            iorder = -1
            ha, hb = h2, h1

        ra = self.re + ha
        rb = self.re + hb
        sg = math.sqrt((ha - hb)**2 + 4.0 * ra * rb *
                       math.sin(beta / (2.0 * DEG))**2)
        angle1 = 180.0 - math.acos(
            (ha**2 - hb**2 + 2.0 * self.re * (ha - hb) + sg**2)
            / (2.0 * ra * sg)) * DEG
        hmin = ha
        if angle1 > 90.0:
            hmin = ra * math.sin(angle1 / DEG) - self.re
        iter_ = 0
        _, len_, hmin, phi = self.fndhmn(ha, angle1, hb, len_, iter_)
        len_ = 1 if hmin < ha else 0
        _, beta1, _ = self.rfpath_geometry_only(ha, hb, angle1, phi, len_,
                                                hmin)
        sg = math.sqrt((ha - hb)**2 + 4.0 * ra * rb *
                       math.sin((beta + betd) / (2.0 * DEG))**2)
        anglep = 180.0 - math.acos(
            (ha**2 - hb**2 + 2.0 * self.re * (ha - hb) + sg**2)
            / (2.0 * ra * sg)) * DEG
        dang = angle1 - anglep
        iflag = 0
        if hmin < 0.0:
            iflag = 1
            hmin = 0.0
            _, len_, hmin, angle1 = self.fndhmn(hmin, 90.0, ha, len_, 1)
        iter_ = 1
        len_ = 1 if angle1 > 90.0 else 0
        _, len_, hmin, phi = self.fndhmn(ha, angle1, hb, len_, iter_)
        len_ = 1 if hmin < ha else 0
        _, beta1, _ = self.rfpath_geometry_only(ha, hb, angle1, phi, len_,
                                                hmin)
        if iflag == 1 and beta1 < beta:
            raise ValueError("FDBETA: path intersects the earth")
        angle2 = angle1
        beta2 = beta1
        while True:
            anglep2 = angle1 - dang
            len_ = 1 if anglep2 > 90.0 else 0
            _, len_, hmin, phi = self.fndhmn(ha, anglep2, hb, len_, iter_)
            len_ = 1 if hmin < ha else 0
            _, betap, _ = self.rfpath_geometry_only(ha, hb, anglep2, phi,
                                                    len_, hmin)
            if abs(beta1 - betap) < tolrnc:
                angle2 = anglep2
                beta = betap
                break
            iter_ += 1
            angle2 = angle1 + (angle1 - anglep2) * (beta - beta1) \
                / (beta1 - betap)
            len_ = 1 if angle2 > 90.0 else 0
            _, len_, hmin, phi = self.fndhmn(ha, angle2, hb, len_, iter_)
            len_ = 1 if hmin < ha else 0
            _, beta2, _ = self.rfpath_geometry_only(ha, hb, angle2, phi,
                                                    len_, hmin)
            if beta2 < beta and hmin < 0.0:
                raise ValueError("FDBETA: tangent height below ground")
            angle1 = angle2
            beta1 = beta2
            if abs(beta - beta2) < tolrnc:
                break
            if iter_ > itermx:
                raise RuntimeError("FDBETA did not converge")
        if hmin < 0.0:
            raise ValueError("FDBETA: tangent height below ground")
        angle = angle2
        beta_out = beta2
        if iorder != 1:
            phi, angle = angle, phi
        return h1, h2, angle, phi, hmin, len_, beta_out

    # ---------------- layering (AUTLAY/HALFWD) ----------------

    def halfwd_z(self, z, xvbar):
        """HALFWD (lblatm.f90:5830-5887): interpolate P,T at z, widths."""
        prof = self.prof
        im = prof.immax - 1
        for i2 in range(1, prof.immax):
            if prof.zmdl[i2] >= z:
                im = i2
                break
        fac = (z - prof.zmdl[im - 1]) / (prof.zmdl[im] - prof.zmdl[im - 1])
        p = expint(prof.pm[im - 1], prof.pm[im], fac)
        t = prof.tm[im - 1] + (prof.tm[im] - prof.tm[im - 1]) * fac
        al = ALZERO * (p / PZERO) * math.sqrt(296.0 / t)
        ad = ADCON * xvbar * math.sqrt(t / AVMWT)
        av = 0.5 * (al + math.sqrt(al**2 + 4.0 * ad**2))
        return p, t, al, ad, av

    def halfwd_p(self, p, t, xvbar):
        """HALFWD_P (lblatm.f90:5775-5823)."""
        al = ALZERO * (p / PZERO) * math.sqrt(296.0 / t)
        ad = ADCON * xvbar * math.sqrt(t / AVMWT)
        av = 0.5 * (al + math.sqrt(al**2 + 4.0 * ad**2))
        return al, ad, av

    def autlay(self, hmin, hmax, xvbar, avtrat, tdiff1, tdiff2, altd1,
               altd2):
        """AUTLAY (lblatm.f90:5582-5770): returns zbnd, pbnd, tbnd."""
        prof = self.prof
        zround = lambda zx: 0.1 * float(int(10.0 * zx))
        hmin = max(hmin, prof.zmdl[0])
        ihmin = prof.immax - 1
        for im in range(1, prof.immax):
            if prof.zmdl[im] > hmin:
                ihmin = im
                break
        htop = min(hmax, self.zmax)
        avtm = {}
        im = ihmin - 1
        _, _, _, _, avtm[im] = self.halfwd_z(prof.zmdl[im], xvbar)
        zbnd = [hmin]
        pb, tb, al, ad, av = self.halfwd_z(hmin, xvbar)
        pbnd, tbnd, avoigt = [pb], [tb], [av]
        im = ihmin
        while True:
            # IB loop (lblatm.f90:5650-5742)
            tmin = tmax = tbnd[-1]
            ind = 0
            zb_prev = zbnd[-1]
            while True:
                ipass = 0
                zb = prof.zmdl[im]
                zbndti = prof.zmdl[im]
                if zb >= htop:
                    zb = htop
                pb, tb, al, ad, av = self.halfwd_z(zb, xvbar)
                avtm[im] = av
                if (avoigt[-1] / av) >= avtrat:
                    ipass = 1
                    av_target = avoigt[-1] / avtrat
                    x = avtm[im] / avtm[im - 1]
                    alogx = 1.0 - x
                    if abs(alogx) < 0.001:
                        zb = (prof.zmdl[im] + prof.zmdl[im - 1]) / 2.0
                    else:
                        alogx = math.log(x)
                        y = av_target / avtm[im - 1]
                        alogy = 1.0 - y
                        if abs(alogy) > 0.001:
                            alogy = math.log(y)
                        zb = prof.zmdl[im - 1] + \
                            (prof.zmdl[im] - prof.zmdl[im - 1]) * alogy / alogx
                fac = (zb_prev - altd1) / (altd2 - altd1)
                tdiff = expint(tdiff1, tdiff2, fac)
                if prof.tm[im] > tmax:
                    ind = 1
                    tmax = prof.tm[im]
                if prof.tm[im] < tmin:
                    ind = 2
                    tmin = prof.tm[im]
                if tmax - tmin > tdiff:
                    tb_target = tmin + tdiff if ind == 1 else tmax - tdiff
                    ipass = 2
                    if abs(prof.tm[im] - prof.tm[im - 1]) < 0.0001:
                        zbndti = (prof.zmdl[im] + prof.zmdl[im - 1]) / 2.0
                    else:
                        zbndti = prof.zmdl[im - 1] + \
                            (prof.zmdl[im] - prof.zmdl[im - 1]) * \
                            (tb_target - prof.tm[im - 1]) / \
                            (prof.tm[im] - prof.tm[im - 1])
                if zbndti < zb:
                    zb = zbndti
                if zb >= htop:
                    zb = htop
                    if zb - zbnd[-1] <= 0.1:
                        zbnd.pop()
                        pbnd.pop()
                        tbnd.pop()
                        avoigt.pop()
                    pb, tb, al, ad, av = self.halfwd_z(zb, xvbar)
                    zbnd.append(zb)
                    pbnd.append(pb)
                    tbnd.append(tb)
                    avoigt.append(av)
                    return (np.asarray(zbnd), np.asarray(pbnd),
                            np.asarray(tbnd))
                if ipass == 0:
                    im += 1
                    continue
                zb = zround(zb)
                pb, tb, al, ad, av = self.halfwd_z(zb, xvbar)
                zbnd.append(zb)
                pbnd.append(pb)
                tbnd.append(tb)
                avoigt.append(av)
                break

    # ---------------- ray trace (RFPATH/AMERGE/ALAYER) ----------------

    def amerge(self, h1, h2, hmin, len_, zbnd):
        """AMERGE (lblatm.f90:5111-5285)."""
        prof = self.prof
        tol = 5.0e-4
        hmid = min(h1, h2)
        hmax = max(h1, h2)
        zh = [hmin]
        if len_ == 0:
            zh.append(hmax)
        else:
            zh.append(hmid)
            if abs(h1 - h2) < tol:
                h1 = h2
            if h1 != h2:
                zh.append(hmax)
        ihmax = len(zh)
        zbnd = list(zbnd)
        ibmax = len(zbnd)

        zout = [zh[0]]
        i1 = ibmax
        for i in range(ibmax):
            if abs(zbnd[i] - zh[0]) < tol:
                zh[0] = zbnd[i]
            if zbnd[i] > zh[0]:
                i1 = i
                break
        ib = i1
        ih = 1
        while True:
            if ib > ibmax - 1:
                zout.append(zh[ih])
                ih += 1
                if ih > ihmax - 1:
                    break
                continue
            if abs(zbnd[ib] - zh[ih]) < tol:
                zh[ih] = zbnd[ib]
            if zbnd[ib] < zh[ih]:
                zout.append(zbnd[ib])
                ib += 1
                continue
            if zbnd[ib] == zh[ih]:
                ib += 1
            zout.append(zh[ih])
            ih += 1
            if ih > ihmax - 1:
                break
        zout = np.asarray(zout)
        ioutmx = len(zout)

        # merge zout with zmdl into zpth.  The walk is a scalar
        # recurrence (tolerance snaps cascade into later comparisons) so
        # it stays a loop; the native helper runs it when on
        # (bit-identical — same expint/pow and snap order), with the
        # Python-float-list walk below as the oracle.
        if native.enabled():
            (zpth_n, pp_n, tp_n, rf_n, src_im, src_jm, src_a,
             iphmid, hmid) = native.amerge_walk(
                 prof.zmdl, prof.pm, prof.tm, prof.rfndxm, zout, hmin,
                 hmid, tol)
            n = len(zpth_n)
            denp = np.empty((MXMOL, n))
            mod = src_im >= 0
            if mod.any():
                denp[:, mod] = prof.denm[:, src_im[mod]]
            for i in np.nonzero(~mod)[0]:
                jm, a = int(src_jm[i]), src_a[i]
                denp[:, i] = expint_vec(prof.denm[:, jm - 1],
                                        prof.denm[:, jm], a)
            return (zpth_n, pp_n, tp_n, rf_n, denp, zout, iphmid, h1, h2,
                    hmid)

        immax = prof.immax
        zmdl_l = prof.zmdl.tolist()
        pm_l = prof.pm.tolist()
        tm_l = prof.tm.tolist()
        rfndx_l = prof.rfndxm.tolist()
        im = None
        for i, zi in enumerate(zmdl_l):
            if zi >= hmin:
                im = i
                break
        if im is None:
            raise ValueError("AMERGE: profile does not extend up to HMIN")
        zpth, pp, tp, rf = [], [], [], []
        # density columns are gathered vectorized after the merge walk:
        # model levels record their index, interpolated points (jm, a)
        den_src: list = []
        iphmid = 0
        iout = 0
        zout_l = zout.tolist()
        while True:
            if im <= immax - 1 and iout <= ioutmx - 1:
                if abs(zout_l[iout] - zmdl_l[im]) < tol:
                    zmdl_l[im] = zout_l[iout]
            if im <= immax - 1 and \
                    (iout > ioutmx - 1 or zout_l[iout] >= zmdl_l[im]):
                if iout <= ioutmx - 1 and zout_l[iout] == zmdl_l[im]:
                    iout += 1
                zpth.append(zmdl_l[im])
                pp.append(pm_l[im])
                tp.append(tm_l[im])
                rf.append(rfndx_l[im])
                den_src.append(im)
                im += 1
            else:
                z = zout_l[iout]
                jm = max(im, 1)
                a = (z - zmdl_l[jm - 1]) / (zmdl_l[jm] - zmdl_l[jm - 1])
                zpth.append(z)
                pp.append(expint(pm_l[jm - 1], pm_l[jm], a))
                tp.append(tm_l[jm - 1]
                          + (tm_l[jm] - tm_l[jm - 1]) * a)
                rf.append(expint(rfndx_l[jm - 1], rfndx_l[jm], a))
                den_src.append((jm, a))
                iout += 1
            # hmid snap: both branches move the path point to hmid.  The
            # reference instead moves HMID to the model altitude in the
            # model-level branch (lblatm.f90:5254) — an intentional,
            # unified deviation bounded by tol (0.5 m) and mirrored in
            # the native walk (monortm_native.cpp amerge_walk), so the
            # two implementations stay bit-identical
            if abs(zpth[-1] - hmid) < tol:
                if zpth[-1] != hmid:
                    zpth[-1] = hmid
                hmid = zpth[-1]
            if zpth[-1] == hmid:
                iphmid = len(zpth)          # 1-based
            if abs(zpth[-1] - zout_l[-1]) < tol:
                zpth[-1] = zout_l[-1]
            if zpth[-1] == zout_l[-1]:
                break

        n = len(zpth)
        denp = np.empty((MXMOL, n))
        mod_cols = np.asarray([i for i, s in enumerate(den_src)
                               if not isinstance(s, tuple)], np.int64)
        if len(mod_cols):
            src = np.asarray([den_src[i] for i in mod_cols], np.int64)
            denp[:, mod_cols] = prof.denm[:, src]
        for i, s in enumerate(den_src):
            if isinstance(s, tuple):
                jm, a = s
                denp[:, i] = expint_vec(prof.denm[:, jm - 1],
                                        prof.denm[:, jm], a)
        return (np.asarray(zpth), np.asarray(pp), np.asarray(tp),
                np.asarray(rf), denp, zout, iphmid, h1, h2,
                hmid)

    def alayer(self, j, sinai, cosai, cpath, sh, gamma, iamt, zpth, pp, tp,
               denp, sums):
        """ALAYER (lblatm.f90:5289-5578): one level interval.

        sums: dict with ppsum,tpsum,rhopsm,amtp[nmol] arrays; updated at j.
        Returns (sinai, cosai, s, bend).
        """
        r = self.refr
        epsiln = 1.0e-5
        z1, z2 = zpth[j], zpth[j + 1]
        h1 = z1
        r1 = self.re + h1
        dhmin = DELTAS**2 / (2.0 * r1)
        sinai1, cosai1 = sinai, cosai
        y1 = 0.0
        if (1.0 - sinai) < epsiln:
            y1 = cosai1**2 / 2.0 + cosai1**4 / 8.0 + cosai1**6 * 3.0 / 48.0
        y3 = 0.0
        x1 = -r1 * cosai1
        ratio1 = r1 / r.radref(h1, sh, gamma)
        ratio_bottom = ratio1
        rad_top = self.re + z2
        ratio_top = rad_top / r.radref(z2, sh, gamma)
        dsdx1 = 1.0 / (1.0 - ratio1 * sinai1**2)
        dbndx1 = dsdx1 * sinai1 * ratio1 / r1
        s = 0.0
        bend = 0.0

        if iamt != 2:
            pa, pb_ = pp[j], pp[j + 1]
            if pb_ == pa:
                raise ValueError("pressures in adjoining levels must differ")
            ta, tb_ = tp[j], tp[j + 1]
            rhoa = pa / (GCAIR * ta)
            rhob = pb_ / (GCAIR * tb_)
            dz = z2 - z1
            hp = -dz / math.log(pb_ / pa)
            if abs(rhob / rhoa - 1.0) >= epsiln:
                hrho = -dz / math.log(rhob / rhoa)
            else:
                hrho = 1.0e30
            dena = denp[:, j].copy()
            denb_lvl = denp[:, j + 1]
            hden = np.zeros(self.nmol)
            for k in range(self.nmol):
                da, db = dena[k], denb_lvl[k]
                if da == 0.0 or db == 0.0 or abs(1.0 - da / db) <= epsiln:
                    hden[k] = 0.0
                else:
                    hden[k] = -dz / math.log(db / da)

        while True:
            dh = -DELTAS * cosai1
            dh = max(dh, dhmin)
            h3 = h1 + dh
            if h3 > z2:
                h3 = z2
            dh = h3 - h1
            r3 = self.re + h3
            h2_ = h1 + dh / 2.0
            r2 = self.re + h2_
            sinai2 = cpath / (r.andex(h2_, sh, gamma) * r2)
            sinai3 = cpath / (r.andex(h3, sh, gamma) * r3)
            ratio2 = r2 / r.radref(h2_, sh, gamma)
            ratio3 = r3 / r.radref(h3, sh, gamma)
            if (1.0 - sinai2) <= epsiln:
                y3 = y1 + (sinai1 * (1.0 - ratio1) / r1
                           + 4.0 * sinai2 * (1.0 - ratio2) / r2
                           + sinai3 * (1.0 - ratio3) / r3) * dh / 6.0
                cosai3 = -math.sqrt(max(2.0 * y3 - y3**2, 0.0))
                x3 = -r3 * cosai3
                dx = x3 - x1
                w1, w2, w3 = 0.5 * dx, 0.0, 0.5 * dx
                cosai2 = cosai1  # unused in this branch
            else:
                cosai2 = -math.sqrt(1.0 - sinai2**2)
                cosai3 = -math.sqrt(1.0 - sinai3**2)
                x2 = -r2 * cosai2
                x3 = -r3 * cosai3
                d31, d32, d21 = x3 - x1, x3 - x2, x2 - x1
                if d32 == 0.0 or d21 == 0.0:
                    w1, w2, w3 = 0.5 * d31, 0.0, 0.5 * d31
                else:
                    w1 = (2.0 - d32 / d21) * d31 / 6.0
                    w2 = d31**3 / (d32 * d21 * 6.0)
                    w3 = (2.0 - d21 / d32) * d31 / 6.0
            dsdx2 = 1.0 / (1.0 - ratio2 * sinai2**2)
            dsdx3 = 1.0 / (1.0 - ratio3 * sinai3**2)
            dbndx2 = dsdx2 * sinai2 * ratio2 / r2
            dbndx3 = dsdx3 * sinai3 * ratio3 / r3
            ds = w1 * dsdx1 + w2 * dsdx2 + w3 * dsdx3
            dbend = w1 * dbndx1 + w2 * dbndx2 + w3 * dbndx3

            # MJA elevation fix (lblatm.f90:5483-5513).  Fortran
            # precedence: A .OR. B .AND. C == A .or. (B and C).  The
            # original stores its bending into DBND (with a DBDNDR3
            # typo) — a dead store — so only DS is actually replaced;
            # replicated faithfully.
            if ratio_top >= 1.0 or (ratio_bottom >= 1.0
                                    and (1.0 - sinai2) > epsiln):
                d31, d32, d21 = r3 - r1, r3 - r2, r2 - r1
                if d32 == 0.0 or d21 == 0.0:
                    w1, w2, w3 = 0.5 * d31, 0.0, 0.5 * d31
                else:
                    w1 = (2.0 - d32 / d21) * d31 / 6.0
                    w2 = d31**3 / (d32 * d21 * 6.0)
                    w3 = (2.0 - d21 / d32) * d31 / 6.0
                dsdr1 = -1.0 / cosai1
                dsdr2 = -1.0 / cosai2
                dsdr3 = -1.0 / cosai3
                ds = w1 * dsdr1 + w2 * dsdr2 + w3 * dsdr3

            s += ds
            bend += dbend

            if iamt != 2:
                dsdz = ds / dh if dh != 0 else 0.0
                pb_ = pa * math.exp(-dh / hp)
                rhob = rhoa * math.exp(-dh / hrho)
                if (dh / hrho) >= epsiln:
                    sums["ppsum"][j] += dsdz * (hp / (1.0 + hp / hrho)) * \
                        (pa * rhoa - pb_ * rhob)
                    sums["tpsum"][j] += dsdz * hp * (pa - pb_) / GCAIR
                    sums["rhopsm"][j] += dsdz * hrho * (rhoa - rhob)
                else:
                    sums["ppsum"][j] += 0.5 * ds * (pa * rhoa + pb_ * rhob)
                    sums["tpsum"][j] += 0.5 * ds * (pa + pb_) / GCAIR
                    sums["rhopsm"][j] += 0.5 * ds * (rhoa + rhob)
                for k in range(self.nmol):
                    if hden[k] == 0.0 or abs(dh / hden[k]) < epsiln:
                        denb = denp[k, j] + (denp[k, j + 1] - denp[k, j]) \
                            * (h3 - z1) / (z2 - z1)
                        sums["amtp"][k, j] += 0.5 * (dena[k] + denb) * ds \
                            * 1.0e5
                    else:
                        denb = denp[k, j] * math.exp(-(h3 - z1) / hden[k])
                        sums["amtp"][k, j] += dsdz * hden[k] * \
                            (dena[k] - denb) * 1.0e5
                    dena[k] = denb
                pa = pb_
                rhoa = rhob

            if h3 < z2:
                h1, r1 = h3, r3
                sinai1 = sinai3
                ratio1 = ratio3
                y1 = y3
                cosai1 = cosai3
                x1 = x3
                dsdx1 = dsdx3
                dbndx1 = dbndx3
            else:
                return sinai3, cosai3, s, bend

    def rfpath(self, h1, h2, angle, phi, len_, hmin, iamt, zbnd):
        """RFPATH (lblatm.f90:4917-5105)."""
        if h1 <= h2:
            iorder = 1
            ha, hb = h1, h2
            anglea = angle
        else:
            iorder = -1
            ha, hb = h2, h1
            anglea = phi

        (zpth, pp, tp, rfndxp, denp, zout, iphmid, h1m, h2m, hmid) = \
            self.amerge(h1, h2, hmin, len_, zbnd)
        r = self.refr
        if len_ == 0:
            sh, gamma = r.findsh(ha)
            cpath = (self.re + ha) * r.andex(ha, sh, gamma) * \
                math.sin(anglea / DEG)
        else:
            sh, gamma = r.findsh(hmin)
            cpath = (self.re + hmin) * r.andex(hmin, sh, gamma)

        beta = 0.0
        s = 0.0
        bendng = 0.0
        if len_ == 1:
            sinai, cosai = 1.0, 0.0
            theta = 90.0
        else:
            theta = anglea
            if anglea <= 45.0:
                sinai = math.sin(anglea / DEG)
                cosai = -math.cos(anglea / DEG)
            else:
                sinai = math.cos((90.0 - anglea) / DEG)
                cosai = -math.sin((90.0 - anglea) / DEG)

        ipmax = len(zpth)
        sums = {"ppsum": np.zeros(ipmax - 1), "tpsum": np.zeros(ipmax - 1),
                "rhopsm": np.zeros(ipmax - 1),
                "amtp": np.zeros((MXMOL, ipmax - 1)),
                "sp": np.zeros(ipmax - 1)}

        # whole-path native loop (SCALHT + ALAYER + angle bookkeeping in
        # C++, one call per path)
        if native.enabled():
            nsums, sc = native.rfpath_integrate(
                zpth, pp, tp, rfndxp, denp, self.nmol, sinai, cosai, cpath,
                self.re, DELTAS, GCAIR, iamt, theta, len_, iphmid)
            sums["ppsum"] = nsums["ppsum"]
            sums["tpsum"] = nsums["tpsum"]
            sums["rhopsm"] = nsums["rhopsm"]
            sums["sp"] = nsums["sp"]
            sums["amtp"][:self.nmol] = nsums["amtp_nmol"]
            s, beta, bendng = sc["s"], sc["beta"], sc["bendng"]
            phi_j = sc["phi_j"]
            phi_out = anglea if iorder == -1 else phi_j
            return {"zpth": zpth, "pp": pp, "tp": tp, "zout": zout,
                    "iphmid": iphmid, "sums": sums, "range": s,
                    "beta": beta, "bendng": bendng, "hmid": hmid,
                    "phi": phi_out}

        for j in range(ipmax - 1):
            sh, gamma = r.scalht(zpth[j], zpth[j + 1], rfndxp[j],
                                 rfndxp[j + 1])
            sinai, cosai, ds, dbend = self.alayer(
                j, sinai, cosai, cpath, sh, gamma, iamt, zpth, pp, tp,
                denp, sums)
            sums["sp"][j] = ds
            dbend = dbend * DEG
            phi_j = math.asin(min(max(sinai, -1.0), 1.0)) * DEG
            dbeta = theta - phi_j + dbend
            phi_j = 180.0 - phi_j
            s += ds
            bendng += dbend
            beta += dbeta
            theta = 180.0 - phi_j
            if len_ == 1 and (j + 2) == iphmid:
                bendng *= 2.0
                beta *= 2.0
                s *= 2.0
        phi_out = anglea if iorder == -1 else phi_j
        return {"zpth": zpth, "pp": pp, "tp": tp, "zout": zout,
                "iphmid": iphmid, "sums": sums, "range": s, "beta": beta,
                "bendng": bendng, "hmid": hmid, "phi": phi_out}

    def rfpath_geometry_only(self, ha, hb, angle, phi, len_, hmin):
        """RFPATH with IAMT=2 for FDBETA iterations; returns (range, beta,
        bending)."""
        zbnd = np.asarray([self.zmin, self.zmax])
        out = self.rfpath(ha, hb, angle, phi, len_, hmin, 2, zbnd)
        return out["range"], out["beta"], out["bendng"]

    # ---------------- packing (FPACK) ----------------

    def fpack(self, trace_out, h1, h2, len_, n_zero, iemit=1):
        """FPACK (lblatm.f90:5891-6056)."""
        zpth = trace_out["zpth"]
        pp = trace_out["pp"]
        tp = trace_out["tp"]
        zout = list(trace_out["zout"])
        sums = trace_out["sums"]
        hmid = trace_out["hmid"]
        nmol = self.nmol

        ioutmx = len(zout)
        nlay_max = ioutmx - 1
        pbar = np.zeros(nlay_max)
        tbar = np.zeros(nlay_max)
        rhosum = np.zeros(nlay_max)
        sout = np.zeros(nlay_max)
        amount = np.zeros((MXMOL, nlay_max))
        pz = np.zeros(nlay_max + 1)
        tz = np.zeros(nlay_max + 1)
        altz = np.zeros(nlay_max + 1)

        i2 = len(zpth) - 1
        pz[0] = pp[0]
        tz[0] = tp[0]
        # layer boundaries are exact members of zpth (amerge snaps them);
        # locate them once and segment-sum with reduceat
        q = np.searchsorted(zpth, np.asarray(zout[1:]))
        vec_ok = (len(zpth) > 1 and np.all(np.diff(zpth) > 0)
                  and np.all(q < len(zpth))
                  and np.all(zpth[np.minimum(q, len(zpth) - 1)] == zout[1:])
                  and q[-1] == i2)
        if vec_ok:
            starts = np.concatenate([[0], q[:-1]])
            pbar[:] = np.add.reduceat(sums["ppsum"], starts)
            tbar[:] = np.add.reduceat(sums["tpsum"], starts)
            rhosum[:] = np.add.reduceat(sums["rhopsm"], starts)
            sout[:] = np.add.reduceat(sums["sp"], starts)
            amount[:, :] = np.add.reduceat(sums["amtp"], starts, axis=1)
            pz[1:] = pp[q]
            tz[1:] = tp[q]
        else:
            iout = 0
            for ip in range(i2):
                pbar[iout] += sums["ppsum"][ip]
                tbar[iout] += sums["tpsum"][ip]
                rhosum[iout] += sums["rhopsm"][ip]
                sout[iout] += sums["sp"][ip]
                amount[:, iout] += sums["amtp"][:, ip]
                if zpth[ip + 1] == zout[iout + 1]:
                    pz[iout + 1] = pp[ip + 1]
                    tz[iout + 1] = tp[ip + 1]
                    iout += 1
            if iout != ioutmx - 1:
                raise RuntimeError("FPACK: IOUT mismatch")

        amttot = amount.sum(axis=1)
        # the reference's iskip(7)=0 (lblatm.f90:5973) is immediately
        # overwritten by the amttot loop; final state is amttot-based
        iskip = (amttot == 0.0).astype(int)
        amtcum = np.zeros(MXMOL)
        l2 = ioutmx - 1
        lmax = l2
        wn2l = np.zeros(nlay_max)
        secnta = np.zeros(nlay_max)
        ipath = np.zeros(nlay_max, int)
        for l in range(l2):
            pbar[l] /= rhosum[l]
            tbar[l] /= rhosum[l]
            rhosum[l] *= 1.0e5
            sumamt = amount[:nmol, l].sum()
            wn2l[l] = rhosum[l] - sumamt
            secnta[l] = sout[l] / (zout[l + 1] - zout[l])
            if l == 0:
                altz[0] = zout[0]
            altz[l + 1] = zout[l + 1]
            if len_ == 1:
                if zout[l] < hmid:
                    ipath[l] = 2
                elif h1 > h2:
                    ipath[l] = 1
                else:
                    ipath[l] = 3
            else:
                ipath[l] = 3 if h1 < h2 else 1
            iskpt = 0
            nmol_max = nmol - 1 if iskip[6] == 1 else nmol
            fac = 2.0 if ipath[l] == 2 else 1.0
            stop_layers = False
            for k in range(nmol):
                if n_zero == 2:
                    zero_it = False
                    if iskip[k] == 1:
                        zero_it = True
                    elif not (k == 6 or (iemit == 1 and ipath[l] != 3)):
                        if ((amttot[k] - amtcum[k]) / amttot[k]) <= 0.001:
                            zero_it = True
                    if zero_it:
                        iskip[k] = 1
                        amount[k, l] = 0.0
                        iskpt += 1
                        if iskpt >= nmol_max:
                            stop_layers = True
                            break
                        continue
                amtcum[k] += fac * amount[k, l]
            if stop_layers:
                break
            lmax = l + 1
        ioutmx = lmax + 1

        return PathResult(
            pbar=pbar[:lmax], tbar=tbar[:lmax],
            amount=amount[:, :lmax], wn2l=wn2l[:lmax],
            rhosum=rhosum[:lmax], altz=altz[:lmax + 1],
            pz=pz[:lmax + 1], tz=tz[:lmax + 1], ipath=ipath[:lmax],
            secnta=secnta[:lmax], zout=np.asarray(zout[:lmax + 1]))


def fixtyp_layers(pbar, tbar, wtotl, amount_h2o, xvbar, iemit=1,
                  sample=4.0):
    """Per-layer ITYL DV-ratio codes (FIXTYP, lblatm.f90:6062-6156).

    Computes the layer-to-layer DV ratio type from the mean Voigt width
    AVBAR = (ALBAR + sqrt(ALBAR^2 + 4 ADBAR^2))/2 with ALZERO=0.04 cm-1,
    AVMWT=36 (lblatm.f90:1772) and the H2O self-broadening factor
    (1+4*FRH2O).  MonoRTM ignores the TAPE5 SAMPLE field
    (monortm_sub.F90:219-224), so the LBLRTM default SAMPLE=4 is used;
    ITYL is decorative for a monochromatic model but preserved for TAPE7
    compatibility.  Returns int codes; layer 1 carries the reference's
    sentinel 99.
    """
    pbar = np.asarray(pbar, np.float64)
    tbar = np.asarray(tbar, np.float64)
    wtotl = np.asarray(wtotl, np.float64)
    amount_h2o = np.asarray(amount_h2o, np.float64)
    n = len(pbar)
    ityl = np.zeros(n, np.int64)
    olddv = 0.0
    for l in range(n):
        frh2o = amount_h2o[l] / wtotl[l]
        alfcor = (pbar[l] / PZERO) * np.sqrt(296.0 / tbar[l])
        adbar = 3.581155e-07 * xvbar * np.sqrt(tbar[l] / 36.0)
        h2oslf = 1.0 - frh2o + 5.0 * frh2o
        albar = 0.04 * alfcor * h2oslf
        avbar = 0.5 * (albar + np.sqrt(albar * albar
                                       + 4.0 * adbar * adbar))
        dv = avbar / sample
        itype = 99
        if l == 0:
            # round DV to 3 significant (even) figures (lblatm.f90:6105-6114)
            iscal = int(np.log10(dv) - 3.0)
            scal = 10.0 ** iscal
            idv = int(dv / scal + 0.5)
            if idv % 2 > 0:
                idv += 1
            dv = scal * idv
        else:
            type_ = olddv / dv
            if type_ > 2.5:
                itype = 99          # reference flags IPROB/ISTOP
            elif type_ >= 1.2:
                itype = int(1.0 / (type_ - 1.0) + 0.5)
                if itype == 3:
                    itype = 2
                dv = olddv * itype / (itype + 1.0)
            elif type_ >= 0.8:
                dv = olddv
                itype = 0
            else:
                dv = olddv
                itype = 0
                if iemit != 1:
                    itype = int(type_ / (1.0 - type_) + 0.5)
                    dv = dv * (itype + 1.0) / itype
                    itype = -itype
        olddv = dv
        ityl[l] = itype
    return ityl
