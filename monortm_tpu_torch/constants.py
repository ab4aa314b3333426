"""Physical constants (a copy of `monortm_tpu.constants`).

Values mirror the reference model's constant set (NIST 2002 vintage) so that
radiances/brightness temperatures agree with AER MonoRTM v5.6:
ref: PhysConstants.f90:19-43, PlanetEarth.f90:19-20.

All constants are plain Python floats (f64).  The port keeps its own copy
so that it imports nothing of the JAX package; tests/test_torch_copies.py
holds the two equal.
"""

from __future__ import annotations

import math

# --- mathematical ---
PI = 3.1415926535898

# --- fundamental (CGS units, NIST 01/11/2002) ---
PLANCK = 6.62606876e-27  # g cm^2 / s
BOLTZ = 1.3806503e-16    # g cm^2 / (s^2 K)
CLIGHT = 2.99792458e+10  # cm / s
AVOGAD = 6.02214199e+23  # molec / mole
ALOSMT = 2.6867775e+19   # Loschmidt number, molec / cm^3 @273.15K, 1 atm

# --- derived ---
GASCON = 8.314472e+07        # g cm^2 / (s^2 K mole)
RADCN1 = 1.191042722e-12     # first radiation constant  (2 h c^2 * 1e-7)
RADCN2 = 1.4387752           # second radiation constant (h c / k)  [cm K]

# RADCT used by the line-by-line code (PLANCK*CLIGHT/BOLTZ); the reference
# computes it from the fundamental constants (modm.f90:874), which differs
# from RADCN2 in the last digits.  Keep both to reproduce its arithmetic.
RADCT = PLANCK * CLIGHT / BOLTZ

# --- planet (Earth) ---
WVMWT = 18.015    # molecular weight of water  [g/mole]
AIRMWT = 28.964   # molecular weight of dry air [g/mole]

# --- reference state ---
T0 = 296.0        # K     (line parameters reference temperature)
P0 = 1013.25      # hPa   (reference pressure used by the line code, modm.f90:876)
P0_CNT = 1013.0   # hPa   (reference pressure used by the continuum, contnm.f90:86)
TSKY = 2.75       # K     cosmic microwave background (RTMmono.f90:111)

# column conversions
PWV_CM_PER_MOLEC_CM2 = 2.99150e-23   # molec/cm^2 -> cm of PWV (monortm_sub.F90:843)
DOBSON_TO_MOLEC_CM2 = 2.68678e16     # DU -> molec/cm^2 (monortm_sub.F90:1033)

# Loschmidt variant used inside the continuum module (contnm.f90:87)
XLOSMT = 2.68675e+19

SQRT_LN2 = math.sqrt(math.log(2.0))
LN2 = math.log(2.0)

# default gravitational constant (PlanetEarth.f90:81), latitude 45 deg
def grav_const(latitude_deg: float = 45.0) -> float:
    return 9.80665 - 0.02586 * math.cos(2.0 * PI * latitude_deg / 180.0)
