"""Operation tables of the line-sum lanes and the H100's peaks.

Frozen copies of chip_smoke.py's per-class tables (an FP32 add,
multiply, compare, divide, sqrt, exp or cos is one operation, a fused
multiply-add two; counted by hand from csrc/linesum_math.cuh).  Rows are
the classes of a line: O2 coupled with XF -1, O2 coupled, O2, CO2 with XF
-1 or -5, CO2, other coupled, other plain, and an uncoupled O2 line
outside the 25 cm^-1 window; columns are without and with the mirror term
K(wn + nu).
"""

# chip_smoke.py:244-245 (FWD_LORENTZ_OPS)
FWD_LORENTZ = ((22, 22), (14, 14), (13, 16), (23, 23), (15, 15), (18, 26),
               (14, 18), (5, 5))
# chip_smoke.py:265-266 (BWD_LORENTZ_OPS)
BWD_LORENTZ = ((63, 63), (39, 39), (29, 39), (59, 59), (38, 38), (44, 69),
               (31, 43), (9, 9))
# chip_smoke.py:225-226 (FWD_SD_OPS, BWD_SD_OPS): an SD-Voigt lane at
# Humlicek's cheapest region, without and with the mirror term
FWD_SD = (82, 151)
BWD_SD = (465, 875)
# the lane switch of a layer that holds SD-Voigt lanes (chip_smoke.py:
# 241-242, 263-264): one operation on every Lorentz lane but the last row's
# in the forward, on every Lorentz lane in the adjoint
SWITCH = 1

# NVIDIA H100 SXM data sheet, dense: FP32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
