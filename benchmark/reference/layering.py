"""The reference's layering of stacked radiosonde runs: LBLATM (lblatm.f90,
called from monortm.f90:369 for IATM=1) for one geometry, in plain
PyTorch float64.

The geometry is upstream example case 3's: user levels in altitude
(MODEL 0, IMMAX > 0) with P in mb and T in K (JCHARP, JCHART `A`), H2O
as relative humidity (JCHAR `H`) and the other molecules from the US
standard atmosphere (`6`), explicit boundary altitudes (IBMAX > 0) and a
zenith path looking up from H1 to H2 (ITYPE 2, ANGLE 0), without the
0.1% zeroing (NOZERO 1).  Anything else raises NotImplementedError.

From the levels to the layers:
- WATVAP (JCHAR H): n(H2O) = DENSAT(T0/T) RH / 100, DENSAT(a) = a
  (N_A / M_H2O) exp(18.9766 - 14.9595 a - 2.4388 a^2) 1e-6; the air
  n = L0 (P / P0) (T0 / T), the dry air that less n(H2O).
- DEFALT (JCHAR 6): the US standard ppmv at z by 4-point Lagrange
  interpolation on the model's 50 altitudes (the four nearest, shifted
  inside the table at its ends); CONVRT: n = ppmv 1e-6 n(dry air).
- AMERGE: the path's points are the levels from H1 to H2 and the
  boundaries between them; a boundary between two levels takes P and
  the densities interpolated exponentially (linearly where either end is
  0) and T linearly.
- ALAYER, for each interval between points (dz, ends a and b): the air
  density rho = P / (k' T), k' = 1e-3 R / N_A; scale heights
  H_P = -dz / ln(P_b/P_a), H_rho = -dz / ln(rho_b/rho_a) (1e30 where
  the ratio is within 1e-5 of 1) and, per molecule, H = -dz /
  ln(n_b/n_a); the Curtis-Godson sums, exactly integrated for
  exponential profiles where dz / H_rho >= 1e-5:
  sum P rho = H_P / (1 + H_P / H_rho) (P_a rho_a - P_b rho_b),
  sum T rho = H_P (P_a - P_b) / k', sum rho = H_rho (rho_a - rho_b),
  and by the trapezoid otherwise; each amount H (n_a - n_b) 1e5 cm,
  by the trapezoid where an end is 0, n_a / n_b is within 1e-5 of 1 or
  |dz / H| < 1e-5.
- FPACK, per layer between boundaries: P = sum P rho / sum rho, T =
  sum T rho / sum rho, the amounts summed, WBRODL = 1e5 sum rho less
  the nmol amounts; the level T and P at the boundaries.

Departures from LBLATM, none of which moves a number beyond rounding
here:
- The path length is dz: at ANGLE 0 Snell's invariant is 0, so the
  refracted ray is the vertical (no refractivity is computed), and
  LBLATM's ds weights sum to dz.
- LBLATM steps each interval in DELTAS = 5 km steps; the closed forms
  above sum any split of an interval to the same value, so each
  interval is one step.
- LBLATM carries P_b and rho_b from P_a and rho_a through the scale
  heights; the reference takes the level's own values, which differ
  only where H_rho is set to 1e30.
- AMERGE snaps points within 0.5 m of each other; the reference
  refuses such points where they are not equal (the generator writes
  1 m steps).

It imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.reference.data import AVOGAD, table
from benchmark.reference.inputs import _ff, _fi

ALOSMT = 2.6867775e19       # Loschmidt's number (PhysConstants.f90)
GASCON = 8.314472e7         # PhysConstants.f90
PZERO, TZERO = 1013.25, 273.15
GCAIR = 1.0e-3 * GASCON / AVOGAD     # lblatm.f90 ATMPTH
AMWT_H2O = 18.015           # lblatm.f90 AMWT(1)
EPS = 1.0e-5                # ALAYER's EPSILN
TOL = 5.0e-4                # AMERGE's TOL, km
F64 = torch.float64


def parse_run(path) -> dict:
    """A stacked MONORTM.IN: the first block's records 1.3 (the grid)
    and 1.4 (TBOUND, emissivity and reflectivity polynomials), and each
    '$' block's lines (records 1.2 on)."""
    lines = Path(path).read_text().splitlines()
    starts = [k for k, ln in enumerate(lines) if ln.startswith("$")]
    ends = starts[1:] + [next(k for k in range(starts[-1], len(lines))
                              if lines[k].startswith("%"))]
    blocks = [lines[a + 1:b] for a, b in zip(starts, ends)]
    r12, r13, r14 = (b.ljust(105) for b in blocks[0][:3])
    if _fi(r12[49:50]) != 1 or _fi(r12[14:15]) != 1 or _fi(r12[69:70]):
        raise NotImplementedError("the reference layers IATM=1, ICNTNM=1 "
                                  "runs without cross-sections")
    v1, v2, dvset = _ff(r13[0:10]), _ff(r13[10:20]), _ff(r13[30:40])
    if _fi(r13[100:105]) or v1 < 0.0:
        raise NotImplementedError("the reference applies no scaling and "
                                  "reads no list of wavenumbers")
    wn = v1 + dvset * np.arange(int(round((v2 - v1) / dvset) + 1))
    return dict(wn=wn, tbound=_ff(r14[0:10]),
                bndemi=[_ff(r14[10 + 10 * j:20 + 10 * j]) for j in range(3)],
                bndrfl=[_ff(r14[40 + 10 * j:50 + 10 * j]) for j in range(3)],
                blocks=blocks)


def parse_block(block: list) -> dict:
    """Records 3.1-3.6 of one block (after 1.2-1.4): the path and the
    levels."""
    r = [ln.ljust(80) for ln in block[3:]]
    model, itype, ibmax = _fi(r[0][0:5]), _fi(r[0][5:10]), _fi(r[0][10:15])
    nozero, nmol = _fi(r[0][15:20]), _fi(r[0][25:30])
    h1, h2, angle = _ff(r[1][0:10]), _ff(r[1][10:20]), _ff(r[1][20:30])
    if (model, itype, nozero) != (0, 2, 1) or ibmax <= 0 or angle != 0.0 \
            or _ff(r[1][30:40]) or _ff(r[1][40:50]) or not h1 < h2 \
            or not 1 <= nmol <= 7:
        raise NotImplementedError("the reference layers MODEL 0, ITYPE 2, "
                                  "NOZERO 1, explicit altitude boundaries, "
                                  "ANGLE 0 looking up, NMOL <= 7")
    nb = -(-ibmax // 8)
    zbnd = np.array([_ff(ln[10 * j:10 * j + 10]) for ln in r[2:2 + nb]
                     for j in range(8)])[:ibmax]
    immax = _fi(r[2 + nb][0:5])
    if immax <= 0:
        raise NotImplementedError("the reference reads levels in altitude")
    lv = r[3 + nb:3 + nb + 2 * immax]
    jc = {ln[35:37] + ln[38:39] + ln[40:40 + nmol] for ln in lv[0::2]}
    if jc != {"AA " + "H666666"[:nmol]}:
        raise NotImplementedError(f"the reference reads P (mb), T (K), H2O "
                                  f"as RH and model 6's other molecules, "
                                  f"not {sorted(jc)}")
    zpt = np.array([[_ff(ln[10 * j:10 * j + 10]) for j in range(3)]
                    for ln in lv[0::2]])
    rh = np.array([_ff(ln[0:10]) for ln in lv[1::2]])
    z, p, t = np.ascontiguousarray(zpt.T)
    return dict(h1=h1, h2=h2, zbnd=zbnd, z=z, p=p, t=t, rh=rh, nmol=nmol)


def _defalt(z: torch.Tensor, nmol: int) -> torch.Tensor:
    """DEFALT: the US standard ppmv of molecules 2..nmol at z, [nmol-1,
    L]."""
    tab = table("usstd")
    alt = torch.as_tensor(tab["alt"], dtype=F64)
    amol = torch.as_tensor(tab["amol"][1:nmol], dtype=F64)
    i2 = torch.searchsorted(alt, z).clamp(2, len(alt) - 2)
    idx = i2[None, :] + torch.arange(-2, 2)[:, None]          # [4, L]
    za = alt[idx]
    w = torch.ones_like(za)
    for j in range(4):
        for m in range(4):
            if m != j:
                w[j] = w[j] * (z - za[m]) / (za[j] - za[m])
    return (amol[:, idx] * w[None]).sum(1)


def level_densities(b: dict):
    """(z, P, T, n [nmol, L]) of the levels (cm^-3)."""
    z, p, t = (torch.as_tensor(b[k], dtype=F64) for k in ("z", "p", "t"))
    rh = torch.as_tensor(b["rh"], dtype=F64)
    a = TZERO / t
    h2o = (a * (AVOGAD / AMWT_H2O) * torch.exp(
        18.9766 - 14.9595 * a - 2.4388 * a * a) * 1.0e-6 * rh / 100.0)
    dry = ALOSMT * (p / PZERO) * (TZERO / t) - h2o
    ppmv = _defalt(z, b["nmol"])
    return z, p, t, torch.cat([h2o[None], ppmv * 1.0e-6 * dry[None]])


def _path_points(b: dict, z, p, t, n):
    """AMERGE: the path's points (z, P, T, n) from H1 to H2 and the
    indices of the layer boundaries among them."""
    h1, h2 = b["h1"], b["h2"]
    zout = np.concatenate([[h1], [x for x in b["zbnd"] if h1 < x < h2],
                           [h2]])
    zl = z.numpy()
    if zl[0] > h1 or zl[-1] < h2:
        raise NotImplementedError("the levels do not span H1 to H2")
    keep = (zl >= h1) & (zl <= h2)
    pts = np.union1d(zl[keep], zout)
    if np.any(np.diff(pts) < TOL):
        raise NotImplementedError("points within AMERGE's tolerance")
    zp = torch.as_tensor(pts, dtype=F64)
    hi = torch.searchsorted(z, zp).clamp(1, len(zl) - 1)
    lo = hi - 1
    f = (zp - z[lo]) / (z[hi] - z[lo])

    def expint(x):
        a, c = x[..., lo], x[..., hi]
        lin = (a == 0) | (c == 0)
        return torch.where(lin, a + (c - a) * f,
                           a * (c / torch.where(lin, 1.0, a)) ** f)

    at_level = torch.as_tensor(np.isin(pts, zl), dtype=torch.bool)
    pp = torch.where(at_level, p[hi.where(z[hi] == zp, lo)], expint(p))
    tp = torch.where(at_level, t[hi.where(z[hi] == zp, lo)],
                     t[lo] + (t[hi] - t[lo]) * f)
    npth = torch.where(at_level, n[:, hi.where(z[hi] == zp, lo)], expint(n))
    return zp, pp, tp, npth, np.searchsorted(pts, zout)


def layer(b: dict) -> dict:
    """The layers of one parsed block: p, t [L], tz, altz, pz [L + 1],
    wkl [L, 39], wbrodl, clw [L], nmol, angle, irt (3, looking up)."""
    z, p, t, n = level_densities(b)
    zp, pp, tp, npth, bnd = _path_points(b, z, p, t, n)
    dz = zp[1:] - zp[:-1]
    pa, pb, ta, tb = pp[:-1], pp[1:], tp[:-1], tp[1:]
    ra, rb = pa / (GCAIR * ta), pb / (GCAIR * tb)
    hp = -dz / torch.log(pb / pa)
    hr = torch.where((rb / ra - 1.0).abs() >= EPS,
                     -dz / torch.log(rb / ra), torch.full_like(dz, 1e30))
    ex = dz / hr >= EPS
    ppsum = torch.where(ex, hp / (1.0 + hp / hr) * (pa * ra - pb * rb),
                        0.5 * dz * (pa * ra + pb * rb))
    tpsum = torch.where(ex, hp * (pa - pb) / GCAIR,
                        0.5 * dz * (pa + pb) / GCAIR)
    rsum = torch.where(ex, hr * (ra - rb), 0.5 * dz * (ra + rb))
    na, nb = npth[:, :-1], npth[:, 1:]
    flat = (na == 0) | (nb == 0) | ((1.0 - na / nb).abs() <= EPS)
    hden = -dz / torch.log(torch.where(flat, 2.0, nb / na))
    flat = flat | ((dz / hden).abs() < EPS)
    amt = 1.0e5 * torch.where(flat, 0.5 * (na + nb) * dz,
                              hden * (na - nb))
    seg = torch.as_tensor(np.repeat(np.arange(len(bnd) - 1),
                                    np.diff(bnd)))
    nlay = len(bnd) - 1

    def per_layer(x):
        return torch.zeros(x.shape[:-1] + (nlay,), dtype=F64).index_add_(
            -1, seg, x)

    rho = per_layer(rsum)
    amount = per_layer(amt)
    nmol = b["nmol"]
    wkl = torch.zeros(nlay, 39, dtype=F64)
    wkl[:, :nmol] = amount.T
    return dict(p=(per_layer(ppsum) / rho).numpy(),
                t=(per_layer(tpsum) / rho).numpy(),
                tz=tp[bnd].numpy(), pz=pp[bnd].numpy(),
                altz=zp[bnd].numpy(), wkl=wkl.numpy(),
                wbrodl=(1.0e5 * rho - amount.sum(0)).numpy(),
                clw=np.zeros(nlay), nmol=nmol, angle=0.0, irt=3)
