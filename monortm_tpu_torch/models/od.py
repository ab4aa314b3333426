"""Optical-depth model: lines + continuum + cloud (port of
`monortm_tpu.models.od`, MODM modm.f90:21-274).

An `ODModel` is built once per run for a static wavenumber grid and
catalog, on one device.  Its host half — the block-sparse plans — is the
JAX package's numpy code (`_build_pallas_plan`, :217-306) copied, so both
packages build identical plans; the plans then live on the device.  Its
call is a function of the layered state, batched over an optional
leading profile axis.

The line sum has four engines.  Two run the CUDA kernel over the same
kind of plan, in float32: "full" (the kernel with the Lorentz/SD-Voigt
switch, nt=256/wt=128 by default) and "lorentz" (its VOIGT=false
instantiation, exact where every line of a layer is in the Lorentz
regime, on its own 128/128 plan); "hybrid" splits the layer axis between
them (`engine_split` picks the layers).  "dense" is the JAX package's XLA
engine (`_build_line_tiles`, `_one_wtile`, `line_od`): eager PyTorch over
`ops.lineshape.line_od_block`, in float32 or float64; a float64 model
always takes it, and asking it for a kernel engine raises.

The dense sweep runs over blocks of a fixed shape: DENSE_ROWS flattened
layer rows (the last block padded), `dense_wn_tile` wavenumbers and
`dense_line_tile` lines (the JAX package's `wn_tile` / `line_tile`,
DENSE_WN_TILE and DENSE_LINE_TILE by default).  So every product and
reduction in it sees the same shapes whatever the number of profiles in
a call, and a profile's bits do not depend on the chunk it is computed
in.  A model builds the dense tiles on the first call of the dense
engine, so a float32 model that runs only the kernels never holds them;
one built with `kernels=False` (the JAX `use_pallas=False`) builds no
kernel plan and runs the dense engine alone.

The continuum and cloud stage is one call of `CONTINUUM_KERNEL`
(csrc/continuum.cu) each way for CUDA float32 states, and the eager
`ContinuumPlan.__call__` + `ops.cloud.od_clw` otherwise.

Cross-sections are host numpy (`ops.xsec`, the pipeline's `xsec-prep`
stage); `od_xsec` adds their OD to the total.

On a (prof, wn[, line]) mesh (`parallel.sharding.Mesh`, the JAX
`ODModel(mesh=)`) a model takes this rank's profile block and returns its
block of the wavenumber grid.  Every plan pads its wavenumber tiles to a
multiple of the "wn" axis and its candidate columns (and the dense
engine's O2 tiles) to a multiple of the "line" axis, as the JAX plans do;
each rank keeps its own rows and column block, with a reverse map made
from them, and launches the kernels there.  The line-axis partials are
all-reduced (`distributed.sum_partials`).  The continuum runs on the full
grid and is sliced (its XINT regrid and host windowing see the whole
grid), the cloud, RFT*W and RT on the rank's columns (the cloud on the
whole grid too where the continuum kernels compute it with the
continuum, on CUDA float32 states).  Gradients: the line
sum's inputs, which every (wn, line) rank holds alike, sum their
cotangents over ("wn", "line") (the kernel path's seven cotangents), and
the state's wn-local uses sum theirs over "wn" (`wn_entry`), so each
rank's state gradient is its profile block's whole one.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.lines import PackedCatalog
from monortm_tpu_torch.ops.cloud import od_clw
from monortm_tpu_torch.ops.continuum import (CONTINUUM_KERNEL, SPECIES,
                                             ContinuumFactors, ContinuumPlan)
from monortm_tpu_torch.ops.lineshape import (LineConfig, catalog_to_device,
                                             catalog_to_host, line_od_block)
from monortm_tpu_torch.ops.linesum import (VOIGT_KERNEL, line_constants,
                                           line_od_forward, reverse_map)
from monortm_tpu_torch.ops.linesum_lorentz import (LORENTZ_KERNEL,
                                                   all_lorentz_predicate)
from monortm_tpu_torch.ops.tips import Tips
from monortm_tpu_torch.parallel.distributed import (all_reduce, shared_input,
                                                    sum_partials)
from monortm_tpu_torch.types import FIELDS, LayerState
from monortm_tpu_torch.utils.trace import span, traced

ENGINES = ("full", "lorentz", "hybrid", "dense")
_KERNELS = {"full": VOIGT_KERNEL, "lorentz": LORENTZ_KERNEL}
# the dense sweep's block: layer rows, and the default wavenumbers and
# lines (the JAX package's wn_tile / line_tile defaults; see the module
# docstring)
DENSE_ROWS, DENSE_WN_TILE, DENSE_LINE_TILE = 64, 128, 4096
# [rows, wavenumbers, lines] arrays a dense block holds at once
# (line_od_block's shapes and their autograd-free temporaries)
DENSE_LIVE = 48


def dense_block_bytes(n_lines: int, itemsize: int, wn_tile: int,
                      line_tile: int) -> int:
    """Device bytes the dense engine's block holds at once, whatever the
    batch, for a catalog of `n_lines` lines at `itemsize` bytes swept in
    tiles of `wn_tile` wavenumbers and `line_tile` lines."""
    return (DENSE_ROWS * wn_tile * min(line_tile, n_lines) * itemsize
            * DENSE_LIVE)


@dataclasses.dataclass
class ODResult:
    od_total: Any       # [..., W, L]   total layer OD (wn-major like O(M,K))
    od_by_mol: Any      # [..., W, M, L] line OD per molecule
    oc: Any             # dict species -> [..., L, W] continuum OD
    od_clw: Any         # [..., L, W]
    od_xsec: Any = None  # [..., L, W] extra OD from the host, or None


def wn_blocks(nwn: int, wt: int, n_wn: int) -> list[tuple[int, int]]:
    """Each wn rank's columns [c0, c1) of the real grid: tiles of `wt`
    wavenumbers, their count padded to a multiple of n_wn, split into
    equal runs of tiles in rank order (the last ranks may hold padding
    alone)."""
    n_wt = max(1, -(-nwn // wt))
    rows = -(-n_wt // n_wn)
    return [(min(nwn, w * rows * wt), min(nwn, (w + 1) * rows * wt))
            for w in range(n_wn)]


def build_plan(catalog: PackedCatalog, host_cat: dict, wn64: np.ndarray,
               nt: int, wt: int, n_wn: int = 1, n_line: int = 1) -> dict:
    """Block-sparse plan for the line sum (host numpy).

    Lines are re-ordered into nu-sorted windowed tiles of `nt` followed by
    O2 tiles (O2 is exempt from the 25 cm^-1 cut, modm.f90:384); each
    wavenumber tile of `wt` gets a static candidate list of the windowed
    tiles overlapping its +-25 cm^-1 reach plus every O2 tile.  Padding
    slots map to tile 0 with valid=0 and are skipped, so pruning is purely
    an optimisation.  The JAX package's `ODModel._build_pallas_plan`,
    returning the plan instead of setting attributes, plus the reverse map
    of the adjoint (`linesum_pallas._reverse_map`).  On a mesh the tile
    count is padded to a multiple of n_wn and the candidate columns to a
    multiple of n_line (`shard_plan` cuts each rank's block).
    """
    nwn = len(wn64)
    nt = max(128, (nt // 128) * 128)
    wt = max(128, (wt // 128) * 128)
    valid = np.asarray(catalog.valid)
    is_o2 = (np.asarray(catalog.mol) == 7) & valid
    idx_o2 = np.nonzero(is_o2)[0]
    idx_win = np.nonzero(~is_o2 & valid)[0]
    nu0 = np.asarray(catalog.nu0)
    idx_win = idx_win[np.argsort(nu0[idx_win], kind="stable")]

    def tiles_from(idx):
        k = max(1, -(-len(idx) // nt))
        rows = np.zeros(k * nt, np.int64)
        rows[:len(idx)] = idx
        mask = np.zeros(k * nt, bool)
        mask[:len(idx)] = True
        return rows.reshape(k, nt), mask.reshape(k, nt)

    win_rows, win_mask = tiles_from(idx_win)
    k_win = win_rows.shape[0] if len(idx_win) else 0
    parts = [(win_rows, win_mask)] if k_win else []
    k_o2 = 0
    if len(idx_o2):
        o2_rows, o2_mask = tiles_from(idx_o2)
        k_o2 = o2_rows.shape[0]
        parts.append((o2_rows, o2_mask))
    if not parts:                       # empty catalog: one dead tile
        parts = [tiles_from(np.zeros(0, np.int64))]
        k_win = 1
    rows = np.concatenate([p[0] for p in parts]).reshape(-1)
    mask = np.concatenate([p[1] for p in parts]).reshape(-1)

    cat = {k: v[rows] for k, v in host_cat.items()}
    cat["valid"] = np.asarray(catalog.valid)[rows] & mask

    # padded wavenumber grid + host two-float split (float64 numpy); equal
    # tiles per wn rank
    n_wtile = max(1, -(-nwn // wt))
    n_wtile = -(-n_wtile // n_wn) * n_wn
    wp = n_wtile * wt
    wn_pad = np.full(wp, 1.0e6, np.float64)
    wn_pad[:nwn] = wn64
    wn_hi = wn_pad.astype(np.float32)
    wn_lo = (wn_pad - wn_hi.astype(np.float64)).astype(np.float32)
    n_wt = wp // wt

    # candidate tiles per wavenumber tile: windowed tiles whose nu range
    # (pressure-shift margin included) reaches within 25 cm^-1, plus every
    # O2 tile
    margin = 25.0
    if len(catalog.pshift):
        margin += 2.0 * float(np.max(np.abs(catalog.pshift)))
    cands = []
    if k_win and len(idx_win):
        nu_t = np.where(win_mask, nu0[win_rows], np.nan)
        lo = np.nanmin(nu_t, axis=1) - margin
        hi = np.nanmax(nu_t, axis=1) + margin
    for i in range(n_wt):
        w = wn_pad[i * wt:(i + 1) * wt]
        w = w[w < 9.0e5]
        sel = []
        if k_win and len(idx_win) and len(w):
            wmin, wmax = w.min(), w.max()
            sel = list(np.nonzero((lo <= wmax) & (hi >= wmin))[0])
        sel += list(range(k_win, k_win + k_o2))    # O2 tiles always
        cands.append(sel)
    n_cand = max(max((len(c) for c in cands), default=0), 1)
    # equal candidate columns per line rank
    n_cand = -(-n_cand // n_line) * n_line
    cmap = np.zeros((n_wt, n_cand), np.int32)
    cvalid = np.zeros((n_wt, n_cand), np.int32)
    for i, c in enumerate(cands):
        cmap[i, :len(c)] = c
        cvalid[i, :len(c)] = 1
    # the adjoint kernel walks the transpose: wn tiles per line tile
    rmap, rvalid = reverse_map(cmap, cvalid, len(rows) // nt)
    return {"cat": cat, "nt": nt, "wt": wt, "wn_hi": wn_hi, "wn_lo": wn_lo,
            "cand_map": cmap, "cand_valid": cvalid, "rev_map": rmap,
            "rev_valid": rvalid}


def shard_plan(plan: dict, n_wn: int, n_line: int, w: int, l: int) -> dict:
    """The block of a mesh-padded plan that wn rank `w`, line rank `l`
    sweeps: its rows of the candidate map and its column block, its
    wavenumbers, and the reverse map of that block (the JAX per-shard
    reverse maps, linesum_pallas.py:766-780); the plan itself on one
    device."""
    if n_wn == n_line == 1:
        return plan
    cm, cv = plan["cand_map"], plan["cand_valid"]
    rows, cols = cm.shape[0] // n_wn, cm.shape[1] // n_line
    rs, cs = slice(w * rows, (w + 1) * rows), slice(l * cols, (l + 1) * cols)
    cm, cv = np.ascontiguousarray(cm[rs, cs]), np.ascontiguousarray(cv[rs, cs])
    ws = slice(w * rows * plan["wt"], (w + 1) * rows * plan["wt"])
    rmap, rvalid = reverse_map(cm, cv, len(plan["cat"]["mol"]) // plan["nt"])
    return {**plan, "wn_hi": plan["wn_hi"][ws], "wn_lo": plan["wn_lo"][ws],
            "cand_map": cm, "cand_valid": cv, "rev_map": rmap,
            "rev_valid": rvalid}


def plan_to_device(plan: dict, device) -> dict:
    """A host plan's arrays as tensors on `device`, after checking that
    every candidate index names a line tile of the catalog, with the
    catalog's per-line constants of the line sum and its prologue
    (`line_constants`), made once here rather than at every call."""
    n_tiles = len(plan["cat"]["mol"]) // plan["nt"]
    cm = plan["cand_map"]
    if cm.size and (cm.min() < 0 or cm.max() >= n_tiles):
        raise ValueError(f"candidate map names tiles outside [0, {n_tiles})")
    cat = catalog_to_device(plan["cat"], device)
    return {
        "cat": cat, "const": line_constants(cat),
        "nt": plan["nt"], "wt": plan["wt"],
        "wn_hi": torch.as_tensor(plan["wn_hi"], device=device),
        "wn_lo": torch.as_tensor(plan["wn_lo"], device=device),
        "cand_map": torch.as_tensor(cm, device=device),
        "cand_valid": torch.as_tensor(plan["cand_valid"], device=device),
        "rev": tuple(torch.as_tensor(plan[k], device=device)
                     for k in ("rev_map", "rev_valid")),
    }


def build_dense_tiles(catalog: PackedCatalog, host_cat: dict,
                      wn64: np.ndarray, wn_tile: int, line_tile: int,
                      n_wn: int = 1, n_line: int = 1) -> dict:
    """Tiles of the dense engine (host numpy): the JAX package's
    `ODModel._build_line_tiles` and wavenumber tiling.

    The catalog splits into (a) O2 tiles, visited for every wavenumber
    tile (no 25 cm^-1 cut for O2, modm.f90:384), and (b) nu-sorted
    windowed tiles with a static candidate list per wavenumber tile, whose
    nu range (pressure-shift margin included) reaches the tile.  Padding
    lines repeat line 0 with valid=0, so the pruning changes no result.
    On a mesh the wavenumber tiles are padded to a multiple of n_wn, and
    each tile's candidate list and the O2 tiles are cut into n_line
    column blocks (the JAX padding, od.py:99 and :198); `shard_dense`
    takes a rank's.
    """
    nwn = len(wn64)
    wt = min(wn_tile, max(8, nwn))
    n_wt = -(-nwn // wt)
    n_wt = -(-n_wt // n_wn) * n_wn
    wn_pad = np.full(n_wt * wt, 1.0e6, np.float64)
    wn_pad[:nwn] = wn64
    wn_tiles = wn_pad.reshape(n_wt, wt)
    wn_hi = wn_tiles.astype(np.float32)
    wn_lo = (wn_tiles - wn_hi.astype(np.float64)).astype(np.float32)

    valid = np.asarray(catalog.valid)
    nu0 = np.asarray(catalog.nu0)
    is_o2 = (np.asarray(catalog.mol) == 7) & valid
    idx_o2 = np.nonzero(is_o2)[0]
    idx_win = np.nonzero(~is_o2 & valid)[0]
    idx_win = idx_win[np.argsort(nu0[idx_win], kind="stable")]

    def tiles_from(idx):
        nt = min(line_tile, max(8, len(idx)))
        k = max(1, -(-len(idx) // nt))
        rows = np.zeros(k * nt, np.int64)
        rows[:len(idx)] = idx
        mask = np.zeros(k * nt, bool)
        mask[:len(idx)] = True
        return rows.reshape(k, nt), mask.reshape(k, nt)

    def gather(rows, mask):
        out = {k: v[rows] for k, v in host_cat.items()}
        out["valid"] = valid[rows] & mask
        return out

    o2 = gather(*tiles_from(idx_o2)) if len(idx_o2) else None
    win, cands = None, [[] for _ in range(n_wt)]
    if len(idx_win):
        rows, mask = tiles_from(idx_win)
        win = gather(rows, mask)
        margin = 25.0
        if len(catalog.pshift):
            margin += 2.0 * float(np.max(np.abs(catalog.pshift)))
        nu = np.where(mask, nu0[rows], np.nan)
        lo = np.nanmin(nu, axis=1) - margin
        hi = np.nanmax(nu, axis=1) + margin
        for i, w in enumerate(wn_tiles):
            w = w[w < 9.0e5]
            wmin, wmax = (w.min(), w.max()) if len(w) else (0.0, 0.0)
            cands[i] = np.nonzero((lo <= wmax) & (hi >= wmin))[0].tolist()
    n_o2 = 0 if o2 is None else len(o2["mol"])
    return {"wt": wt, "wn": wn_tiles, "wn_hi": wn_hi, "wn_lo": wn_lo,
            "win": win, "o2": o2, "cand": cands, "o2_idx": list(range(n_o2)),
            "cols": -(-max(1, max(map(len, cands), default=0)) // n_line),
            "o2_cols": -(-n_o2 // n_line)}


def shard_dense(tiles: dict, n_wn: int, n_line: int, w: int, l: int) -> dict:
    """The dense tiles wn rank `w`, line rank `l` sweeps: its rows of
    wavenumber tiles, its block of each tile's candidate columns and of
    the O2 tiles (padding slots dropped: they add nothing); the tiles
    themselves on one device."""
    if n_wn == n_line == 1:
        return tiles
    rows = len(tiles["cand"]) // n_wn
    rs = slice(w * rows, (w + 1) * rows)
    c, k = tiles["cols"], tiles["o2_cols"]
    return {**tiles, "wn": tiles["wn"][rs], "wn_hi": tiles["wn_hi"][rs],
            "wn_lo": tiles["wn_lo"][rs],
            "cand": [cd[l * c:(l + 1) * c] for cd in tiles["cand"][rs]],
            "o2_idx": tiles["o2_idx"][l * k:(l + 1) * k]}


def dense_to_device(tiles: dict, device, dtype: torch.dtype) -> dict:
    """The dense engine's tiles as tensors on `device`."""
    cat = lambda c: None if c is None else catalog_to_device(c, device)
    return {"wt": tiles["wt"], "cand": tiles["cand"],
            "o2_idx": tiles["o2_idx"],
            "wn": torch.as_tensor(tiles["wn"], dtype=dtype, device=device),
            "wn_hi": torch.as_tensor(tiles["wn_hi"], device=device),
            "wn_lo": torch.as_tensor(tiles["wn_lo"], device=device),
            "win": cat(tiles["win"]), "o2": cat(tiles["o2"])}


class ODModel:
    """Optical depths for one spectral setup, on one device (the CUDA card
    unless `device` names another), in float32 (every engine) or float64
    (the dense engine); with `mesh`, this rank's block of a (prof, wn[,
    line]) mesh (see the module docstring).

    The keywords' names against the JAX `ODModel` / `MonoRTM`'s:

        JAX                                port
        wn_tile / line_tile                dense_wn_tile / dense_line_tile
        pallas_wn_tile / pallas_line_tile  wn_tile / line_tile
        use_pallas                         kernels

    so `wn_tile` / `line_tile` are the kernel plan's tiles and
    `dense_wn_tile` / `dense_line_tile` the dense engine's.
    `kernels=False` (the JAX `use_pallas=False`) builds no kernel plan: the
    model runs the dense engine alone, and on a mesh its wavenumber split
    follows the dense tile.  A kernel model (float32, `kernels=True`)
    splits the grid by the kernels' tiles; its dense engine then raises
    where the dense tile would split the grid otherwise.
    """

    def __init__(self, wn: np.ndarray, dvset: float, catalog: PackedCatalog,
                 nmol: int = 39,
                 factors: ContinuumFactors = ContinuumFactors(),
                 line_cfg: LineConfig = LineConfig(), *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 wn_tile: int = 128, line_tile: int = 256,
                 dense_wn_tile: int = DENSE_WN_TILE,
                 dense_line_tile: int = DENSE_LINE_TILE,
                 kernels: bool = True, mesh=None):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64: {dtype}")
        tiles = dict(wn_tile=wn_tile, line_tile=line_tile,
                     dense_wn_tile=dense_wn_tile,
                     dense_line_tile=dense_line_tile)
        bad = {k: v for k, v in tiles.items() if int(v) < 1}
        if bad:
            raise ValueError(f"tiles must be positive: {bad}")
        # the device a tensor made there reports: a bare "cuda" becomes the
        # current card ("cuda:0"), so that `_check` accepts states made on
        # "cuda" (a torch.device("cuda") compares unequal to "cuda:0")
        self.device = torch.empty(0, device=device).device
        self.wn64 = np.asarray(wn, np.float64)
        self.nwn = len(self.wn64)
        self.nmol = int(nmol)
        self.dtype = dtype
        self.line_cfg = line_cfg
        # a mesh of one rank is no mesh
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        m = self.mesh
        n_wn = m.shape["wn"] if m else 1
        n_line = m.shape.get("line", 1) if m else 1
        shard = (n_wn, n_line, m.coords["wn"] if m else 0,
                 m.coords.get("line", 0) if m else 0)
        # kernel plans only at float32, as the JAX use_pallas
        self.kernels = bool(kernels) and dtype == torch.float32
        self.dense_wn_tile = int(dense_wn_tile)
        self.dense_line_tile = int(dense_line_tile)
        # the wavenumber tiles of the engines this model's runs take must
        # split the grid alike: the kernels' two plans, or the dense tile
        # of a dense-only model (`dense` checks its own at first use)
        if self.kernels:
            wts = {max(128, (wn_tile // 128) * 128), 128}
        else:
            wts = {self._dense_wt()}
        blocks = {tuple(wn_blocks(self.nwn, wt, n_wn)) for wt in wts}
        if len(blocks) > 1:
            raise ValueError(f"wavenumber tiles {sorted(wts)} split the "
                             f"grid over {n_wn} wn ranks differently; take "
                             "wn_tile=128")
        blocks = blocks.pop()
        self._split = (sorted(wts), blocks)
        self.wn_cols = blocks[shard[2]]
        self.wn_sizes = [c1 - c0 for c0, c1 in blocks]
        with span("model-build.tables"):
            self.cont = ContinuumPlan(self.wn64, dvset=dvset,
                                      factors=factors, nmol=nmol,
                                      device=self.device)
            self.tips = Tips(self.device, dtype)
        self.catalog = catalog
        with span("model-build.catalog"):
            self.host_cat = catalog_to_host(catalog, dtype)
            self.dev_cat = catalog_to_device(self.host_cat, self.device)
        self.default_engine = "full" if self.kernels else "dense"
        self._shard = shard
        self._dense = None
        self.dev_plans = {}
        if self.kernels:
            # the kernels' plans; the all-Lorentz engine gets its own
            # 128/128 plan over the same catalog unless the tiles already
            # match (as monortm_tpu's ODModel)
            with span("model-build.plan"):
                self.plan = build_plan(catalog, self.host_cat, self.wn64,
                                       nt=line_tile, wt=wn_tile, n_wn=n_wn,
                                       n_line=n_line)
                if (line_tile, wn_tile) != (128, 128):
                    self.plan_lorentz = build_plan(
                        catalog, self.host_cat, self.wn64, nt=128, wt=128,
                        n_wn=n_wn, n_line=n_line)
                else:
                    self.plan_lorentz = self.plan
            with span("model-build.upload"):
                self.dev_plans = {
                    e: plan_to_device(shard_plan(p, *shard), self.device)
                    for e, p in (("full", self.plan),
                                 ("lorentz", self.plan_lorentz))}
        # this rank's wavenumbers in the compute dtype (== the plan's wn_hi
        # over the real grid)
        c0, c1 = self.wn_cols
        self.wn_t = torch.as_tensor(self.wn64[c0:c1], dtype=dtype,
                                    device=self.device)

    def local_wn(self, x):
        """This rank's columns of `x`, a tensor on the model's full grid
        (last axis nwn); `x` itself on one device, or where it does not
        span the grid (a number, a broadcast axis)."""
        if self.mesh is None or not torch.is_tensor(x) or x.ndim == 0 \
                or x.shape[-1] != self.nwn:
            return x
        return x[..., self.wn_cols[0]:self.wn_cols[1]]

    def wn_entry(self, x):
        """`x` (a state field) where it enters work split over "wn": its
        gradient is summed over the wn ranks."""
        return shared_input(x, self.mesh and self.mesh.group("wn"))

    def _check(self, state: LayerState) -> LayerState:
        """The state in the model's dtype; it must already be on its device."""
        for f in FIELDS:
            v = getattr(state, f)
            if v.device != self.device:
                raise ValueError(f"state.{f} is on {v.device}; the model is "
                                 f"on {self.device}")
        return LayerState(**{f: getattr(state, f).to(self.dtype)
                             for f in FIELDS})

    def _engine(self, engine):
        """`engine`, or the model's default for None; a kernel engine on a
        float64 model, or on one built with kernels=False, raises."""
        engine = self.default_engine if engine is None else engine
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}: {engine!r}")
        if engine != "dense" and not self.kernels:
            which = (f"a {self.dtype} model" if self.dtype != torch.float32
                     else "a model built with kernels=False")
            raise ValueError(
                f"engine {engine!r} runs the float32 line-sum kernels; "
                f"{which} takes engine='dense'")
        return engine

    def _dense_wt(self) -> int:
        """The dense engine's wavenumber tile on this grid
        (`build_dense_tiles`' own)."""
        return min(self.dense_wn_tile, max(8, self.nwn))

    @property
    def dense(self) -> dict:
        """The dense engine's tiles on the device, built on first use.  On
        a mesh they must split the grid over the wn ranks as the model's
        columns do (a kernel model's are the kernels' 128-wide tiles)."""
        if self._dense is None:
            n_wn, n_line = self._shard[:2]
            wt, (wts, blocks) = self._dense_wt(), self._split
            if tuple(wn_blocks(self.nwn, wt, n_wn)) != blocks:
                raise ValueError(
                    f"the dense engine's wavenumber tile {wt} splits the "
                    f"grid over {n_wn} wn ranks otherwise than the "
                    f"kernels' tiles {wts}, which this model's columns "
                    "follow; build it with kernels=False, or with "
                    "dense_wn_tile=128")
            self._dense = dense_to_device(shard_dense(
                build_dense_tiles(self.catalog, self.host_cat, self.wn64,
                                  self.dense_wn_tile, self.dense_line_tile,
                                  n_wn, n_line), *self._shard),
                self.device, self.dtype)
        return self._dense

    def line_od_dense(self, state: LayerState, scor_flat):
        """Line OD [..., L, W, M] (RFT and columns included) through the
        dense engine: the JAX package's `line_od`, with the flattened
        layer rows swept in blocks of DENSE_ROWS; on a mesh over this
        rank's wavenumber tiles and candidate columns, the line ranks'
        partials summed (od.py:467-511)."""
        dn, dtype = self.dense, self.dtype
        lead = state.p.shape
        group = self.mesh and self.mesh.group("wn", "line")
        flat = lambda a, trail: shared_input(
            a.to(dtype).reshape((-1,) + trail), group)
        rows = [flat(state.p, ()), flat(state.t, ()),
                flat(state.wkl, (state.wkl.shape[-1],)),
                flat(state.wbrodl, ()),
                flat(scor_flat, (scor_flat.shape[-1],))]
        n = rows[0].shape[0]
        nb = max(1, -(-n // DENSE_ROWS))
        pad = nb * DENSE_ROWS - n
        if pad:      # repeat row 0: finite operands, cropped below
            rows = [torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
                    for a in rows]
        tile = lambda c, k: {key: v[k] for key, v in c.items()}
        blocks = []
        for b in range(nb):
            args = [a[b * DENSE_ROWS:(b + 1) * DENSE_ROWS] for a in rows]
            cols = []
            for i, cand in enumerate(dn["cand"]):
                if dtype == torch.float64:
                    wn_c, split = dn["wn"][i], None
                else:
                    wn_c = dn["wn_hi"][i]
                    split = (dn["wn_hi"][i], dn["wn_lo"][i])
                acc = torch.zeros((DENSE_ROWS, dn["wt"], self.nmol),
                                  dtype=dtype, device=self.device)
                tiles = ([tile(dn["win"], k) for k in cand]
                         + [tile(dn["o2"], k) for k in dn["o2_idx"]])
                for c in tiles:
                    acc = acc + line_od_block(c, wn_c, split, *args,
                                              self.line_cfg, self.nmol,
                                              dtype)
                cols.append(acc)
            blocks.append(torch.cat(cols, dim=1))
        out = torch.cat(blocks)[:n, :len(self.wn_t)]
        out = sum_partials(out, self.mesh and self.mesh.group("line"))
        return out.reshape(lead + out.shape[1:])

    def line_od(self, state: LayerState, scor_flat, engine: str = None,
                lor_layers=None):
        """Line OD [..., L, W, M] (RFT and columns included).

        The kernel engines flatten leading batch axes into the kernel's
        layer axis.  engine="hybrid" sweeps the lor_layers indices (layers
        whose every line passes zeta > 0.99) through the all-Lorentz
        instantiation and the rest through the full one, scattering
        results back in layer order; "dense" is `line_od_dense`.
        """
        engine = self._engine(engine)
        if engine == "dense":
            return self.line_od_dense(state, scor_flat)
        if engine == "hybrid":
            L = state.p.shape[-1]
            lor = sorted(int(i) for i in (lor_layers or ()))
            voigt = [i for i in range(L) if i not in set(lor)]
            if not lor or not voigt:
                return self.line_od(state, scor_flat,
                                    engine="lorentz" if lor else "full")

            ixL = torch.as_tensor(lor, device=self.device)
            ixV = torch.as_tensor(voigt, device=self.device)

            def sub(ix):
                st = LayerState(
                    p=state.p.index_select(-1, ix),
                    t=state.t.index_select(-1, ix),
                    tz=state.tz,
                    wkl=state.wkl.index_select(-2, ix),
                    wbrodl=state.wbrodl.index_select(-1, ix),
                    clw=state.clw)
                return st, scor_flat.index_select(-2, ix)

            outL = self.line_od(*sub(ixL), engine="lorentz")
            outV = self.line_od(*sub(ixV), engine="full")
            out = outL.new_zeros(outL.shape[:-3] + (L,) + outL.shape[-2:])
            out.index_copy_(-3, ixL, outL)
            return out.index_copy_(-3, ixV, outV)
        plan = self.dev_plans[engine]
        dtype = self.dtype
        lead = state.p.shape                       # [..., L]
        flat = lambda a, trail: a.to(dtype).reshape((-1,) + trail)
        m = self.mesh
        sf = line_od_forward(
            plan["cat"], plan["wn_hi"], plan["wn_lo"], plan["cand_map"],
            plan["cand_valid"], plan["nt"], plan["wt"],
            flat(state.p, ()), flat(state.t, ()),
            flat(state.wkl, (state.wkl.shape[-1],)), flat(state.wbrodl, ()),
            scor_flat.reshape(-1, scor_flat.shape[-1]),
            cfg=self.line_cfg, n_mol=self.nmol, kernel=_KERNELS[engine],
            rev=plan["rev"], grad_group=m and m.group("wn", "line"),
            const=plan["const"])
        # this rank's real wavenumbers; on a line axis, the sum over the
        # line ranks' candidate column blocks (linesum_pallas.py:636-656)
        sf = sum_partials(sf[:, :len(self.wn_t)], m and m.group("line"))
        sf = sf.reshape(lead + sf.shape[1:])

        # od = RFT * W_species * SF (modm.f90:436-438)
        t_ = self.wn_entry(state.t.to(dtype))
        wn_d = self.wn_t
        rft = wn_d * torch.tanh(cst.RADCT * wn_d / (2.0 * t_[..., None]))
        wk_m = self.wn_entry(state.wkl.to(dtype))[..., :self.nmol]
        return rft[..., :, None] * wk_m[..., None, :] * sf

    def engine_split(self, state: LayerState):
        """(engine, lor_layers) for `state`, as bench.py dispatches: the
        layers whose every valid line takes the Lorentz branch (zeta >
        0.99, modm.f90:427) in every profile take the all-Lorentz engine,
        which equals the full one there.  The predicate is evaluated on
        the model's device; only the per-layer verdict comes to the
        host.  A model without kernels (float64, or kernels=False) has
        only the dense engine: ("dense", ())."""
        if not self.kernels:
            return "dense", ()
        with span("engine-split"):
            state = self._check(state)
            scor = self.tips.scor(state.t)
            rows = all_lorentz_predicate(
                self.dev_cat, state.p, state.t, state.wkl, state.wbrodl,
                scor.reshape(scor.shape[:-2] + (39 * 9,)), self.line_cfg,
                self.dtype)
            rows = rows.reshape(-1, rows.shape[-1]).all(dim=0).to(
                torch.int32)
            rows = all_reduce(rows, self.mesh and self.mesh.group("prof"),
                              "min")
            rows = rows.cpu().numpy().astype(bool)
        if rows.all():
            return "lorentz", ()
        if rows.any():
            return "hybrid", tuple(np.nonzero(rows)[0].tolist())
        return "full", ()

    def __call__(self, state: LayerState, engine: str = None,
                 lor_layers=None, od_xsec=None) -> ODResult:
        """Full OD computation (modm.f90:200-272).

        od_total / od_by_mol come out wn-major, [..., W, L] and
        [..., W, M, L], for the RT solver; the rest [..., L, W].
        engine: one of ENGINES, or None for the model's default ("full"
        in float32, "dense" in float64).
        od_xsec: an optional [..., L, W] tensor on the model's device added
        to the total last, as the JAX package adds its host-made
        cross-section OD (the pipeline passes `ops.xsec.xsec_od`'s OD
        plus the TES cloud file's there); on a mesh W is the full grid.
        On a mesh every output holds this rank's columns (W = len(wn_t)).
        """
        dtype = self.dtype
        engine = self._engine(engine)
        state = self._check(state)

        def lines(st):
            scor = self.tips.scor(st.t)
            return self.line_od(st, scor.reshape(scor.shape[:-2] + (39 * 9,)),
                                engine=engine, lor_layers=lor_layers)

        def continuum(st):
            sw = LayerState(**{f: self.wn_entry(getattr(st, f))
                               for f in FIELDS})
            if sw.p.device.type == "cuda" and dtype == torch.float32:
                # the kernels, cloud included, over the whole grid
                oc, o_clw = CONTINUUM_KERNEL(self.cont, sw.p, sw.t, sw.wkl,
                                             sw.wbrodl, sw.clw)
                return ({k: self.local_wn(v) for k, v in oc.items()},
                        self.local_wn(o_clw))
            oc = {k: self.local_wn(v) for k, v in self.cont(
                sw.p, sw.t, sw.wkl, sw.wbrodl, dtype=dtype).items()}
            # cloud liquid water (modm.f90:264)
            return oc, od_clw(self.wn_t, sw.t[..., None], sw.clw[..., None])

        def od_sum(od_lines, oc, o_clw, od_xsec):
            # molecule-axis sum in a FIXED sequential order, as the JAX
            # package's scan: the order does not depend on shapes or devices
            total = torch.zeros_like(od_lines[..., 0])
            for m in range(od_lines.shape[-1]):
                total = total + od_lines[..., m]
            for sp in SPECIES[:-1]:
                total = total + oc[sp]
            total = total + oc["rayleigh"] + o_clw
            o_x = None
            if od_xsec is not None:
                o_x = self.local_wn(od_xsec.to(dtype))
                total = total + o_x
            return total, o_x

        od_lines = traced("lines", lines, state)    # [..., L, W, M]
        oc, o_clw = traced("continuum", continuum, state)
        total, o_x = traced("od-sum", od_sum, od_lines, oc, o_clw, od_xsec)
        return ODResult(od_total=total.movedim(-2, -1),
                        od_by_mol=od_lines.movedim(-3, -1), oc=oc,
                        od_clw=o_clw, od_xsec=o_x)
