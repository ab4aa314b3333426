"""Line-axis sharding: partial line sums combined with one all_reduce.

The port of `monortm_tpu.parallel.linesharded`.  For catalogs too large
for one card, every rank of a mesh's "line" axis holds a shard of the
catalog, evaluates the whole [layer, wn] block against it, and the
per-molecule OD partials (a sum over lines already) are summed over the
axis.  Wavenumbers and layers stay whole on each rank.  The production
engines split the candidate tiles instead (`models.od`, a mesh with a
"line" axis); this is the plain form of the same contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from monortm_tpu_torch.lines import PackedCatalog
from monortm_tpu_torch.ops.lineshape import (LineConfig, catalog_to_device,
                                             catalog_to_host, line_od_block)
from monortm_tpu_torch.parallel.distributed import sum_partials


def split_catalog_stack(catalog: PackedCatalog, n_shards: int,
                        dtype: torch.dtype = torch.float32) -> dict:
    """Round-robin split of the catalog's valid lines into n_shards
    equal-shape shards, stacked on a leading axis: {col: [S, Npad, ...]}
    as host numpy arrays.  Padding rows replicate row 0 with valid=False,
    so every shard's masked line sum is exact."""
    host = catalog_to_host(catalog, dtype)
    valid_idx = np.nonzero(np.asarray(catalog.valid))[0]
    shards = [valid_idx[s::n_shards] for s in range(n_shards)]
    npad = max(1, max(len(s) for s in shards))
    rows = np.zeros((n_shards, npad), np.int64)
    mask = np.zeros((n_shards, npad), bool)
    for s, idx in enumerate(shards):
        rows[s, :len(idx)] = idx
        mask[s, :len(idx)] = True
    out = {k: v[rows] for k, v in host.items()}
    out["valid"] = mask
    return out


def line_od_linesharded(cat_stack: dict, wn, wn_split, state, scor_flat,
                        cfg: LineConfig, n_mol: int, mesh,
                        axis: str = "line",
                        dtype: torch.dtype = torch.float32):
    """Per-molecule line OD with the catalog sharded over the mesh's
    `axis`: this rank's shard of `cat_stack` (from split_catalog_stack,
    leading dim == the axis's size) through `line_od_block`, then the sum
    over the axis.  state: the LayerState every rank of the axis holds;
    wn / wn_split on the state's device.  Returns [..., W, n_mol], the
    unsharded `line_od_block` up to the order of the sum."""
    n_shards = mesh.shape.get(axis, 1)
    if len(next(iter(cat_stack.values()))) != n_shards:
        raise ValueError(f"catalog stack of {len(cat_stack['mol'])} "
                         f"shards for a {axis} axis of {n_shards}")
    dev = state.p.device
    shard = catalog_to_device({k: v[mesh.coords.get(axis, 0)]
                               for k, v in cat_stack.items()}, dev)
    od = line_od_block(shard, wn, wn_split, state.p.to(dtype),
                       state.t.to(dtype), state.wkl.to(dtype),
                       state.wbrodl.to(dtype), scor_flat.to(dtype), cfg,
                       n_mol, dtype)
    return sum_partials(od, mesh.group(axis))
