"""Microwave line catalogs, drawn from a seed.

A configuration lists its lines as classes (`config["lines"]`): each
class has a `kind` (`h2o`, `o2`, `o2_coupled`) and either the line
positions of its source (`ghz`) or a count and a band (`n`, `cm`, lines
placed uniformly there).  The other fields of each line are drawn from
the seed with the distributions of
`monortm_tpu_torch.testing.synthetic_catalog_mw` (speed-dependent H2O
lines; O2 lines, the coupled ones each followed by a coupling record with
Y and G at the four TEMPLC temperatures), frozen here and drawn in a few
vectorised calls, so that a later change to the program cannot move the
benchmark's inputs and a 250k-line catalog takes milliseconds.

The records are returned as a dict of arrays in TAPE3 field order
(`FIELDS`), sorted by wavenumber as a TAPE3 is, each coupling record
after its line, and every 250-record panel of RDLNFL's ending on a line:
the panel skip reads a panel's last VNU, which a coupling record holds Y
in, so that it could drop the panel.  `n_lines` of the records is then
what the program reads.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("vnu", "sp", "alfa", "epp", "mol", "hwhm", "tmpalf", "pshift",
          "iflg", "brd_mol_flg", "brd_mol_hw", "brd_mol_tmp",
          "brd_mol_shft", "speed_dep")
GHZ_PER_CM = 29.9792458
NLINEREC = 250
_DTYPES = (("vnu", np.float64), ("sp", np.float32), ("alfa", np.float32),
           ("epp", np.float32), ("mol", np.int32), ("hwhm", np.float32),
           ("tmpalf", np.float32), ("pshift", np.float32),
           ("iflg", np.int32), ("speed_dep", np.float32))


def _positions(cls: dict, rng) -> np.ndarray:
    if "ghz" in cls:
        return np.asarray(cls["ghz"], np.float64) / GHZ_PER_CM
    return rng.uniform(*cls["cm"], int(cls["n"]))


def _fields(kind: str, nu: np.ndarray, rng) -> dict:
    """The line records of one class at positions nu (cm^-1)."""
    n = len(nu)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    if kind == "h2o":
        return dict(vnu=nu, sp=10 ** u(-28, -24), alfa=u(0.06, 0.1),
                    epp=u(20, 600), mol=1 + 100 * rng.integers(1, 4, n),
                    hwhm=u(0.3, 0.5), tmpalf=u(0.6, 0.8),
                    pshift=u(-0.02, 0.02), iflg=np.zeros(n),
                    speed_dep=u(0, 0.12))
    if kind in ("o2", "o2_coupled"):
        return dict(vnu=nu, sp=10 ** u(-26, -25), alfa=u(0.04, 0.05),
                    epp=u(0, 100), mol=np.full(n, 107), hwhm=u(0.04, 0.05),
                    tmpalf=u(0.7, 0.75), pshift=np.zeros(n),
                    iflg=np.full(n, int(kind == "o2_coupled")),
                    speed_dep=np.zeros(n))
    raise ValueError(f"unknown line kind {kind!r}")


def _coupling(n: int, rng) -> dict:
    """Coupling records: Y and G at the four temperatures in the fields
    (vnu, alfa, mol bits, tmpalf) and (sp, epp, hwhm, pshift)."""
    y, g = rng.uniform(-0.02, 0.02, (n, 4)), rng.uniform(-2e-4, 0.0, (n, 4))
    return dict(vnu=y[:, 0], sp=g[:, 0], alfa=y[:, 1], epp=g[:, 1],
                mol=y[:, 2].astype(np.float32).view(np.int32),
                hwhm=g[:, 2], tmpalf=y[:, 3], pshift=g[:, 3],
                iflg=np.full(n, -1), speed_dep=np.zeros(n))


def synthetic_lines(classes: list, seed: int) -> dict:
    """The TAPE3 records of the line classes `classes` (see above)."""
    rng = np.random.default_rng(seed)
    recs, key, ids, sub = [], [], [], []
    n0 = 0
    for cls in classes:
        nu = _positions(cls, rng)
        line_id = n0 + np.arange(len(nu))
        n0 += len(nu)
        recs.append(_fields(cls["kind"], nu, rng))
        key.append(nu)
        ids.append(line_id)
        sub.append(np.zeros(len(nu)))
        if cls["kind"] == "o2_coupled":
            recs.append(_coupling(len(nu), rng))
            key.append(nu)
            ids.append(line_id)
            sub.append(np.ones(len(nu)))
    order = np.lexsort((np.concatenate(sub), np.concatenate(ids),
                        np.concatenate(key)))
    order = _panel_ends_on_lines(order, np.concatenate(
        [r["iflg"] for r in recs]))
    out = {k: np.concatenate([r[k].astype(dt) for r in recs])[order]
           for k, dt in _DTYPES}
    n = len(out["vnu"])
    out["brd_mol_flg"] = np.zeros((n, 7), np.int32)
    for k in ("brd_mol_hw", "brd_mol_tmp", "brd_mol_shft"):
        out[k] = np.zeros((n, 7), np.float32)
    return {k: out[k] for k in FIELDS}


def _panel_ends_on_lines(order: np.ndarray, iflg: np.ndarray) -> np.ndarray:
    """The record order with every panel ending on a line: a coupling
    record that would end a panel trades places with the nearest
    uncoupled line before its pair (the records between move up one)."""
    order = order.copy()
    n = len(order)
    for e in np.r_[NLINEREC - 1:n:NLINEREC, n - 1]:
        if iflg[order[e]] >= 0:
            continue
        u = e - 2
        while u > e - NLINEREC and iflg[order[u]] != 0:
            u -= 1
        if u <= e - NLINEREC or u < 0:
            raise ValueError("no uncoupled line to end a TAPE3 panel")
        order[u:e + 1] = np.roll(order[u:e + 1], -1)
    return order


def n_lines(raw: dict) -> int:
    """Lines of a record set (coupling records are not lines)."""
    return int((raw["iflg"] >= 0).sum())
