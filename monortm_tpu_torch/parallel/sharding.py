"""Multi-device execution: a (prof, wn[, line]) mesh of torch.distributed
ranks and the sharded batched forward and gradient.

The port of `monortm_tpu.parallel.sharding`.  The natural axes of the
problem map onto the mesh:

  * "prof" — independent atmospheric profiles (data parallel: each rank
    holds its block of the batch);
  * "wn"   — wavenumber tiles (each rank sweeps its own tiles, and the
    continuum, cloud and RT run on its columns);
  * "line" — optional: the candidate line tiles of each wavenumber tile,
    split into column blocks whose partial sums are all-reduced.

Each rank is one process with one device (`parallel.distributed`); a
`Mesh` holds the shape, this rank's coordinates and a process group for
every set of axes, made with one `dist.new_group` per group (every rank
creates every group, in one order).  A model built with `mesh=` takes
this rank's profile block (`shard_state`, `shard_batch`) and the
wavenumber-axis inputs (emissivity, reflectivity, observations) on the
full grid, and returns its (prof, wn) block.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from monortm_tpu_torch.parallel import distributed
from monortm_tpu_torch.types import FIELDS, LayerState

AXES = ("prof", "wn", "line")


def mesh_shape(n_devices: int, n_prof: int | None = None,
               n_wn: int | None = None, n_line: int = 1) -> dict:
    """The mesh shape the JAX `make_mesh` gives for `n_devices`: without
    n_prof and n_wn every device on "wn"; a missing one fills the rest; a
    "line" axis only where n_line > 1.  Raises where the shape does not
    cover the devices exactly."""
    n = n_devices // n_line
    if n_prof is None and n_wn is None:
        n_wn, n_prof = n, 1
    elif n_prof is None:
        n_prof = n // n_wn
    elif n_wn is None:
        n_wn = n // n_prof
    if n_prof * n_wn * n_line != n_devices or min(n_prof, n_wn) < 1:
        raise ValueError(f"mesh {n_prof}x{n_wn}x{n_line} needs "
                         f"{n_prof * n_wn * n_line} rank(s); the world has "
                         f"{n_devices}")
    shape = {"prof": n_prof, "wn": n_wn}
    if n_line > 1:
        shape["line"] = n_line
    return shape


class Mesh:
    """A (prof, wn[, line]) mesh over the ranks of the default process
    group, rank = (prof * n_wn + wn) * n_line + line.  `coords` is this
    rank's place on each axis; `group(*axes)` the process group of the
    ranks that share this rank's coordinates on every other axis (None
    where it holds this rank alone, so callers skip the collective)."""

    def __init__(self, shape: dict):
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.shape = dict(shape)
        names = tuple(self.shape)
        if names not in (AXES[:2], AXES):
            raise ValueError(f"mesh axes must be {AXES[:2]} or {AXES}: "
                             f"{names}")
        dims = [self.shape[a] for a in names]
        if int(np.prod(dims)) != world:
            raise ValueError(f"mesh {'x'.join(map(str, dims))} needs "
                             f"{int(np.prod(dims))} rank(s); the world has "
                             f"{world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = {a: int(c) for a, c in
                       zip(names, np.unravel_index(self.rank, dims))}
        self._groups = {}
        if world == 1:
            return
        ranks = np.arange(world).reshape(dims)
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(range(len(names)), k):
                other = [i for i in range(len(names)) if i not in axes]
                members = np.transpose(ranks, other + list(axes)).reshape(
                    -1, int(np.prod([dims[i] for i in axes])))
                for row in members:
                    g = dist.new_group(row.tolist())
                    if self.rank in row and len(row) > 1:
                        self._groups[tuple(names[i] for i in axes)] = g

    def size(self, *axes) -> int:
        """Ranks along `axes` (all axes when none is named)."""
        return int(np.prod([self.shape.get(a, 1)
                            for a in (axes or tuple(self.shape))]))

    def group(self, *axes):
        """The process group over `axes` through this rank, or None."""
        return self._groups.get(tuple(a for a in self.shape if a in axes))


def make_mesh(n_prof: int | None = None, n_wn: int | None = None,
              n_line: int = 1) -> Mesh:
    """A (prof, wn[, line]) mesh over every rank of the process group (one
    rank without one), shaped as `mesh_shape`.  n_line > 1 adds the "line"
    axis: the candidate line tiles are contracted across it with one
    all_reduce per forward."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh(mesh_shape(world, n_prof, n_wn, n_line))


def shard_batch(x, mesh: Mesh):
    """This rank's block of a profile-batched tensor (leading axis split
    over "prof" in rank order)."""
    n = mesh.shape["prof"]
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split over {n} "
                         "prof shards; pad it")
    b = x.shape[0] // n
    return x[mesh.coords["prof"] * b:(mesh.coords["prof"] + 1) * b]


def shard_state(state: LayerState, mesh: Mesh) -> LayerState:
    """This rank's profile block of a batched LayerState."""
    return LayerState(**{f: shard_batch(getattr(state, f), mesh)
                         for f in FIELDS})


def shard_forward(model, mesh: Mesh, irt: int, engine: str = None,
                  lor_layers=()):
    """The batched forward on the mesh: returns fn(state, tsfc, emis,
    refl, gather=False) -> tb.  state and tsfc are this rank's profile
    block (`shard_state`, `shard_batch`; tsfc may be a float); emis and
    refl span the full grid.  tb is this rank's [B_local, W_local] block,
    or with gather=True the whole [B, W] on every rank.  engine and
    lor_layers: as `MonoRTM.tb` takes them (e.g. the model's
    `engine_split`, which every rank takes alike)."""
    def fn(state, tsfc, emis, refl, gather: bool = False):
        tb = model.tb(state, tsfc, emis, refl, irt, engine=engine,
                      lor_layers=lor_layers)
        if gather:
            return distributed.gather(tb, mesh, -1, model.od_model.wn_sizes)
        return tb

    return fn


def shard_forward_and_grad(model, mesh: Mesh, irt: int, engine: str = None,
                           lor_layers=()):
    """Forward and adjoint (retrieval sensitivity) on the mesh: returns
    fn(state, tsfc, emis, refl, tb_obs) -> (loss, grads), the forward as
    `shard_forward` runs it.

    The loss is mean((tb - tb_obs)^2) over the global B x W, its value
    all-reduced over ("prof", "wn"); tb_obs holds this rank's profile rows
    on the full grid.  grads is a LayerState of d loss / d state for this
    rank's profile block, each with the wn (and line) partials summed:
    the model all-reduces the line sum's seven cotangents over ("wn",
    "line") and the other wn-local parts' gradients over "wn"."""
    od = model.od_model

    def fn(state, tsfc, emis, refl, tb_obs):
        leaves = LayerState(**{f: getattr(state, f).detach()
                               .requires_grad_() for f in FIELDS})
        tb = model.tb(leaves, tsfc, emis, refl, irt, engine=engine,
                      lor_layers=lor_layers)
        n = tb.shape[0] * mesh.size("prof") * od.nwn
        local = ((tb - od.local_wn(tb_obs)) ** 2).sum() / n
        grads = torch.autograd.grad(local, [getattr(leaves, f)
                                            for f in FIELDS])
        loss = distributed.all_reduce(local.detach(),
                                      mesh.group("prof", "wn"))
        return loss, LayerState(**dict(zip(FIELDS, grads)))

    return fn
