"""The reference's line-by-line optical depth: LINES, LSF_LORTZ and
LSF_SDVOIGT (modm.f90:277-831), TIPS_2003 (tips_2003.f90:2-292) and
GET_LNFL's regrouping (lnfl_mod.f90:43-117), vectorised in plain PyTorch.

A rewrite of the loop oracles tests/reference_lines.py and the TIPS part
of tests/reference_e2e.py over tensors: every (layer, wavenumber, line)
lane follows the Fortran's rules.  A line is skipped where it lies more
than 25 cm^-1 from the wavenumber, except an O2 line; a lane takes the
Lorentz shape where |wn - nu| > 100 Doppler widths or zeta > 0.99, and
the speed-dependent Voigt otherwise.  It starts from the TAPE3 records as
generated (a dict of arrays) and keeps RDLNFL's panel selection, so it
derives the line grouping itself.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import data as D
from benchmark.reference.shapes import lorentz, sdvoigt

TEMPLC = (200.0, 250.0, 296.0, 340.0)
DELTNUC = 25.0
NLINEREC = 250


def select_panels(raw: dict, v1: float, v2: float) -> np.ndarray:
    """Indices of the records RDLNFL reads for [v1, v2]: panels of 250 in
    file order, a panel skipped where its last wavenumber lies below
    max(0, v1 - 25), reading stopped after a panel that ends beyond
    v2 + 25 (lnfl_mod.f90:116, 157-168)."""
    keep = []
    lo = max(0.0, v1 - DELTNUC)
    for s in range(0, len(raw["vnu"]), NLINEREC):
        e = min(s + NLINEREC, len(raw["vnu"]))
        if raw["vnu"][e - 1] < lo:
            continue
        keep.append(np.arange(s, e))
        if raw["vnu"][e - 1] > v2 + DELTNUC:
            break
    return np.concatenate(keep) if keep else np.zeros(0, np.int64)


def catalog(raw: dict, v1: float, v2: float) -> dict:
    """One entry per line, with its coupling coefficients: the regrouping
    of GET_LNFL (molecule = mol mod 100; a coupling record, iflg < 0,
    belongs to the line before it; O2 and N2 air widths to foreign
    widths; an H2O self width of 0 to 5 foreign widths) and the J/JJ
    walk of LINES (a line with XG -1 or -3 reads the next record's
    A = (VNU, ALFA, MOL as a float, TMPALF) and B = (SP, EPP, HWHM,
    PSHIFT) at the four TEMPLC temperatures)."""
    idx = select_panels(raw, v1, v2)
    r = {k: v[idx] for k, v in raw.items()}
    iflg = r["iflg"].astype(np.int64)
    if np.any((iflg < 0) & (iflg != -1) & (iflg != -3)) or np.any(
            (iflg == 5) | (iflg == 2)):
        raise NotImplementedError("the reference reads XG 0, -1 and -3")
    line = iflg >= 0
    nxt = np.minimum(np.arange(len(iflg)) + 1, len(iflg) - 1)
    coupled = line & (iflg > 0)
    has_row = coupled & (np.arange(len(iflg)) + 1 < len(iflg)) & \
        (iflg[nxt] < 0)
    mol = (np.abs(r["mol"]) % 100).astype(np.int64)
    alpf = r["alfa"].astype(np.float64)
    alps = r["hwhm"].astype(np.float64)
    alpf = np.where(mol == 7, (alpf - 0.21 * alps) / 0.79, alpf)
    alpf = np.where(mol == 22, (alpf - 0.79 * alps) / 0.21, alpf)
    alps = np.where((mol == 1) & (alps == 0.0), 5.0 * alpf, alps)
    rmol = r["mol"].astype("<i4").view("<f4").astype(np.float64)
    f64 = lambda k: r[k].astype(np.float64)
    a = np.stack([f64("vnu"), f64("alfa"), rmol, f64("tmpalf")], 1)[nxt]
    b = np.stack([f64("sp"), f64("epp"), f64("hwhm"), f64("pshift")],
                 1)[nxt]
    a = np.where(has_row[:, None], a, 0.0)
    b = np.where(has_row[:, None], b, 0.0)
    iso = (np.abs(r["mol"]).astype(np.int64) % 1000) // 100
    sel = np.nonzero(line)[0]
    out = dict(mol=mol, iso=iso, nu0=f64("vnu"), s0=f64("sp"),
               e=f64("epp"), alpf=alpf, alps=alps, x=f64("tmpalf"),
               deltnu=f64("pshift"), sdep=f64("speed_dep"),
               xg=-iflg.astype(np.float64), a=a, b=b)
    out = {k: v[sel] for k, v in out.items()}
    out["mass"] = np.array([D.smass(m, i) for m, i in
                            zip(out["mol"], out["iso"])])
    return out


def _atob(t, tdat, q):
    """AtoB (tips_2003.f90:4610-4702): Lagrange interpolation of q(tdat)
    at t (a tensor), 3 points at the ends of the table, 4 inside, with
    the 0.0001 guards of a zero difference."""
    npt = len(tdat)
    td = torch.as_tensor(tdat, dtype=t.dtype, device=t.device)
    qt = torch.as_tensor(q, dtype=t.dtype, device=t.device)
    # first 1-based I in 2..npt with A(I) >= t (npt when none)
    i = torch.clamp(torch.searchsorted(td[1:].contiguous(),
                                       t.detach().contiguous()) + 2,
                    max=npt)
    ends = (i < 3) | (i == npt)
    j = torch.where(i < 3, 3, torch.where(i == npt, npt, i))

    def guard(v):
        return torch.where(v != 0.0, v, torch.full_like(v, 1e-4))

    a = [td[j - 3], td[j - 2], td[j - 1], td[torch.clamp(j, max=npt - 1)]]
    bq = [qt[j - 3], qt[j - 2], qt[j - 1], qt[torch.clamp(j, max=npt - 1)]]
    d = lambda r_, s: guard(a[r_] - a[s])
    three = ((t - a[1]) * (t - a[2]) / (d(0, 1) * d(0, 2)) * bq[0]
             + (t - a[0]) * (t - a[2]) / (-d(0, 1) * d(1, 2)) * bq[1]
             + (t - a[0]) * (t - a[1]) / (d(0, 2) * d(1, 2)) * bq[2])
    four = sum(_prod([t - a[s] for s in range(4) if s != r_])
               / _prod([d(r_, s) for s in range(4) if s != r_]) * bq[r_]
               for r_ in range(4))
    return torch.where(ends, three, four)


def _prod(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def tips_ratio(t, mol: int, iso: int):
    """Q(296) / Q(t) of one isotope (TIPS_2003): 1 for atomic O and where
    no table exists, the classical law for CH3OH."""
    if mol == 34:
        return torch.ones_like(t)
    if mol == 39:
        return 296.0 / ((t / 296.0) ** 1.5)
    tq = D.tips_q(mol, min(max(iso, 1), 9))
    if tq is None:
        return torch.ones_like(t)
    q296 = _atob(torch.full_like(t, 296.0), *tq)
    qt = _atob(t, *tq)
    return torch.where(qt > 0, q296 / qt, torch.ones_like(t))


class LineOD:
    """Line optical depth of layers at wavenumbers.  cat: `catalog()`;
    device and dtype of the computation."""

    def __init__(self, cat: dict, device, dtype):
        self.dev, self.dt = torch.device(device), dtype
        T = lambda v, dt=dtype: torch.as_tensor(v, dtype=dt,
                                                device=self.dev)
        self.mol = T(cat["mol"], torch.int64)
        self.n = len(cat["mol"])
        for k in ("nu0", "s0", "e", "alpf", "alps", "x", "deltnu", "sdep",
                  "xg", "mass"):
            setattr(self, k, T(cat[k]))
        self.a, self.b = T(cat["a"]), T(cat["b"])
        self.pairs = sorted({(int(m), int(min(max(i, 1), 9)))
                             for m, i in zip(cat["mol"], cat["iso"])})
        key = {p: k for k, p in enumerate(self.pairs)}
        self.pair_of = T([key[(int(m), int(min(max(i, 1), 9)))]
                          for m, i in zip(cat["mol"], cat["iso"])],
                         torch.int64)

    def params(self, p, t, wk, wbrod):
        """Per (row, line) quantities of LINES for rows of layers: p, t,
        wbrod [R]; wk [R, 39].  Returns a dict of [R, N] tensors (stild
        times the molecule's column; `on` where that column is not zero)
        and `rows`, the rows' t and p / P0."""
        c = lambda v: v[:, None]
        wtot = wk.sum(-1) + wbrod
        rp = p / D.P0
        ilc = torch.where(t < TEMPLC[1], 1, torch.where(t < TEMPLC[2], 2, 3))
        tl = torch.as_tensor(TEMPLC, dtype=self.dt, device=self.dev)
        rectlc = 1.0 / (tl[ilc] - tl[ilc - 1])
        tmpdif = t - tl[ilc - 1]
        rt = t / D.T0
        xn0 = (D.P0 / (D.BOLTZ * D.T0)) * 1e3
        rhorat = (p / (D.BOLTZ * t)) * 1e3 / xn0
        lo, hi = c(ilc - 1).expand(-1, self.n), c(ilc).expand(-1, self.n)
        ab = lambda m: (torch.gather(m.T.expand(len(t), -1, -1), 1,
                                     lo[:, None]).squeeze(1),
                        torch.gather(m.T.expand(len(t), -1, -1), 1,
                                     hi[:, None]).squeeze(1))
        a_lo, a_hi = ab(self.a)
        b_lo, b_hi = ab(self.b)
        aip = a_lo + (a_hi - a_lo) * c(rectlc * tmpdif)
        bip = b_lo + (b_hi - b_lo) * c(rectlc * tmpdif)
        nu0 = self.nu0
        s0adj = self.s0 * (nu0 * (1.0 - torch.exp(-D.RADCT * nu0 / D.T0)))
        xnu = nu0 + self.deltnu * c(rhorat)
        scor = torch.stack([tips_ratio(t, m, i) for m, i in self.pairs], 1)
        xipsf = torch.gather(scor, 1, self.pair_of.expand(len(t), -1))
        s = (s0adj * (torch.exp(-D.RADCT * self.e / c(t))
                      / torch.exp(-D.RADCT * self.e / D.T0)) * xipsf)
        stild = s * (1.0 + torch.exp(-D.RADCT * xnu / c(t))) / (
            xnu * (1.0 - torch.exp(-D.RADCT * xnu / D.T0)))
        wsp = torch.gather(wk, 1, (self.mol - 1).clamp(0, 38)
                           .expand(len(t), -1))
        rho_m = c(rhorat) * wsp / c(wtot)
        rtx = c(rt) ** self.x
        alfa0i, hwhmsi = self.alpf * rtx, self.alps * rtx
        hwc = alfa0i * (c(rhorat) - rho_m) + hwhmsi * rho_m
        hwd = (xnu / D.CLIGHT) * torch.sqrt(
            2.0 * D.LN2 * D.BOLTZ * c(t) * D.AVOGAD / self.mass)
        hwc = torch.where(self.xg == -3.0,
                          hwc * (1.0 - aip * c(rp) - bip * c(rp * rp)), hwc)
        return dict(xnu=xnu, stild=stild * wsp, hwc=hwc, hwd=hwd,
                    zeta=hwc / (hwc + hwd), aip=aip, bip=bip, on=wsp != 0.0,
                    rows=dict(t=t, rp=rp))

    def rules(self, pr, wn, sl=slice(None)):
        """The Fortran's masks of the lanes [R, W, n] of lines `sl` at
        wavenumbers wn [W]: (computed, sdvoigt, mirror, inside).  A lane is
        computed unless the line is not O2 and lies beyond 25 cm^-1; takes
        the speed-dependent Voigt where |wn - nu| <= 100 hwd and zeta <=
        0.99; reads the mirror term K(wn + nu) where wn + nu <= 25, and a
        coupled O2 line always; `inside` is |wn - nu| <= 25."""
        w = wn[None, :, None]
        xnu = pr["xnu"][:, None, sl]
        d1 = w - xnu
        o2 = self.mol[sl] == 7
        inside = d1.abs() <= DELTNUC
        comp = (inside | o2) & pr["on"][:, None, sl]
        sd = comp & (d1.abs() <= 100.0 * pr["hwd"][:, None, sl]) & \
            (pr["zeta"][:, None, sl] <= 0.99)
        mirror = ((w + xnu) - DELTNUC <= 0.0) | (o2 & (self.xg[sl] != 0.0))
        return comp, sd, mirror, inside

    def od(self, pr, wn, lane_budget: int = 1 << 24):
        """Line OD [R, W] at wn [W] (all molecules), in blocks of lines of
        at most `lane_budget` lanes."""
        R, W = pr["xnu"].shape[0], len(wn)
        step = max(1, lane_budget // max(1, R * W))
        out = 0.0
        for s in range(0, self.n, step):
            out = out + self._block(pr, wn, slice(s, min(s + step, self.n)))
        t = pr["rows"]["t"][:, None]
        return wn * torch.tanh(D.RADCT * wn / (2.0 * t)) * out

    def _block(self, pr, wn, sl):
        """Sum over the lines `sl` of stild * w * sls, [R, W]."""
        xg, sdep = self.xg[sl], self.sdep[sl]
        comp, sdl, near_mirror, inside = self.rules(pr, wn, sl)
        shape = comp.shape
        w = wn[None, :, None]
        xnu = pr["xnu"][:, None, sl]
        hw = pr["hwc"][:, None, sl].expand(shape)
        ad = pr["hwd"][:, None, sl].expand(shape)
        d1 = (w - xnu).expand(shape)
        d2 = (w + xnu).expand(shape)
        lor = comp & ~sdl
        mol = self.mol[sl]
        o2, co2, cpl = mol == 7, mol == 2, xg != 0.0

        def shape_of(d):
            """K(d) on every computed lane: Lorentz or SD-Voigt."""
            f = torch.zeros(shape, dtype=d.dtype, device=d.device)
            i = lor.nonzero(as_tuple=True)
            f = f.index_put(i, lorentz(d[i], hw[i]))
            i = sdl.nonzero(as_tuple=True)
            if i[0].numel():
                f = f.index_put(i, sdvoigt(d[i], hw[i], ad[i],
                                           sdep.expand(shape)[i]))
            return f

        f1, f2 = shape_of(d1), shape_of(d2)
        f3 = shape_of(torch.full_like(d1, DELTNUC))
        aip, bip = pr["aip"][:, None, sl], pr["bip"][:, None, sl]
        rp = pr["rows"]["rp"][:, None, None]
        y1 = 1.0 + aip / hw * rp * d1 + bip * rp * rp
        y1p = 1.0 + aip / hw * rp * DELTNUC + bip * rp * rp
        y2 = 1.0 - aip / hw * rp * d2 + bip * rp * rp
        y2p = 1.0 - aip / hw * rp * DELTNUC + bip * rp * rp
        near = d2 - DELTNUC <= 0.0
        # molecules other than CO2 and O2
        other = torch.where(
            cpl, torch.where(near, y1 * f1 - y1p * f3 + y2 * f2 - y2p * f3,
                             y1 * f1 - y1p * f3),
            torch.where(near, f1 + f2 - 2.0 * f3, f1 - f3))
        # O2 at every distance, CO2 inside the window
        q = 2.0 - d1 * d1 / DELTNUC ** 2
        o2v = torch.where(
            inside & ~cpl, torch.where(near, f1 + f2, f1),
            torch.where(cpl, torch.where(xg == -1.0, f1 * y1 + f2 * y2,
                                         f1 + f2), torch.zeros_like(f1)))
        co2v = torch.where(
            inside & ~cpl, f1 - f3 * q,
            torch.where((xg == -1.0) | (xg == -5.0),
                        f1 * y1 - f3 * q - f3 * (y1 - 1.0) * q,
                        f1 - f3 * q))
        sls = torch.where(o2, o2v, torch.where(co2, co2v, other))
        sls = torch.where(comp, sls, torch.zeros_like(sls))
        return (pr["stild"][:, None, sl] * sls).sum(-1)
