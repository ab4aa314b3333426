"""Multi-process runs over torch.distributed: one process per rank.

The port of `monortm_tpu.parallel.distributed`.  The JAX package runs one
controller per host that drives all of its devices; here every rank is a
process with one device, started torchrun-style with RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT in its environment (`spawn` starts
such a set of processes on one host).  A mesh axis is a process group
(`parallel.sharding.Mesh`).

Backends: "nccl" for one rank per card, "gloo" for ranks that share a card
or run on the CPU (NCCL refuses two ranks on one card).  Gloo runs
all_gather on host tensors only, so every collective of a CUDA tensor
under gloo runs on a host copy (and under nccl every collective of a
host tensor on a copy on the rank's card), in `_staged`: the one place
where a collective moves data between host and card.  Nothing switches
backend on failure.

Profiles are block-distributed over the "prof" axis in rank order
(`host_local_batch`); each rank uploads only its block
(`make_global_state`), and results come back on every rank through
`gather_to_host`.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from monortm_tpu_torch.convert import state_from_numpy

BACKENDS = ("nccl", "gloo")
# a rank waits this long in a collective for a peer before it fails
TIMEOUT_S = 600


def init_distributed(backend: str, device=None) -> bool:
    """Join the process group described by the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over `backend`.

    No-op (returns False) without WORLD_SIZE or with one process, so one
    entry point serves everywhere; returns True once joined.  With nccl
    the rank's card (`device`) becomes its current device first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` where it names one (e.g. "cuda:0" for
    ranks that share a card, or "cpu"); for None or a bare "cuda", the
    card cuda:LOCAL_RANK."""
    if device is None or str(device) == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(device)


def rank_devices(device) -> list[str]:
    """Every rank's device, in rank order (a collective).  Two nccl ranks
    on one card raise: NCCL refuses them, so they must take gloo."""
    devs = [None] * dist.get_world_size()
    dist.all_gather_object(devs, str(device))
    if dist.get_backend() == "nccl" and len(set(devs)) < len(devs):
        raise ValueError(f"nccl needs one card per rank, got {devs}; ranks "
                         "that share a card take --backend gloo")
    return devs


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective over `group` runs on: `x` itself, a host
    copy of a CUDA tensor under gloo, or a copy of a host tensor on the
    rank's current card under nccl."""
    backend = dist.get_backend(group)
    if x.is_cuda and backend == "gloo":
        return x.detach().cpu()
    if not x.is_cuda and backend == "nccl":
        return x.detach().cuda()
    return x.detach().contiguous()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: `x` reduced ("sum" or "min") over `group`, on x's
    device; `x` itself where the group is None (a single rank)."""
    if group is None:
        return x
    y = _staged(x, group).clone()
    dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM,
                           "min": dist.ReduceOp.MIN}[op], group=group)
    return y.to(x.device)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0,
                   sizes=None) -> torch.Tensor:
    """The blocks of `x` on the ranks of `group`, concatenated along `dim`
    in group-rank order, on x's device.  `sizes`: each rank's extent
    along `dim` where they differ (blocks are padded to the largest for
    the collective and cropped after)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    dim = dim % x.ndim
    sizes = [x.shape[dim]] * n if sizes is None else list(sizes)
    if x.shape[dim] != sizes[dist.get_rank(group)]:
        raise ValueError(f"block of {x.shape[dim]} along dim {dim}, "
                         f"expected {sizes[dist.get_rank(group)]}")
    y = _staged(x, group)
    big = max(sizes)
    if y.shape[dim] < big:
        pad = list(y.shape)
        pad[dim] = big - y.shape[dim]
        y = torch.cat([y, y.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y.contiguous(), group=group)
    out = torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                    dim=dim)
    return out.to(x.device)


class _SumPartials(torch.autograd.Function):
    """all_reduce(sum) of partial sums whose total every rank of the group
    then uses alike: the backward passes the cotangent on as it is (every
    rank holds the same cotangent of the one total)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SharedInput(torch.autograd.Function):
    """Identity on a value every rank of the group holds alike and spends
    on its own part of the work: the backward sums the cotangents of the
    parts over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of each rank's partial `x`, differentiable
    (`_SumPartials`); `x` where the group is None."""
    return x if group is None else _SumPartials.apply(x, group)


def shared_input(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, with its gradient summed over `group` (`_SharedInput`); `x`
    where the group is None."""
    return x if group is None else _SharedInput.apply(x, group)


def global_mesh(n_wn: int = 1):
    """A (prof, wn) mesh over every rank: world / n_wn profile shards."""
    from monortm_tpu_torch.parallel.sharding import make_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_wn:
        raise ValueError(f"{n} ranks do not split into wn shards of {n_wn}")
    return make_mesh(n_prof=n // n_wn, n_wn=n_wn)


def host_local_batch(n_global: int, mesh) -> tuple[int, int]:
    """(start, count) of the profiles this rank loads: the batch is
    block-distributed over the prof axis in rank order, and n_global must
    divide evenly by it (pad the batch otherwise)."""
    n_prof = mesh.shape["prof"]
    if n_global % n_prof:
        raise ValueError(f"batch of {n_global} profiles does not split over "
                         f"{n_prof} prof shards; pad it")
    count = n_global // n_prof
    return mesh.coords["prof"] * count, count


def make_global_state(local, n_global: int, mesh, device,
                      dtype: torch.dtype):
    """This rank's profile block (numpy fields p, t, tz, wkl, wbrodl, clw,
    as `host_local_batch` names it) as a LayerState on its device."""
    _, count = host_local_batch(n_global, mesh)
    if np.shape(local.p)[0] != count:
        raise ValueError(f"local block of {np.shape(local.p)[0]} profiles, "
                         f"expected {count}")
    return state_from_numpy(local, device, dtype)


def gather(x: torch.Tensor, mesh, wn_dim=None, wn_sizes=None):
    """A (prof[, wn])-block result [B_local, ...] as the whole [B, ...] on
    every rank (on x's device): gathered over "wn" along `wn_dim` (each wn
    rank's columns given by `wn_sizes`; None: not split over wn), then
    over "prof" along the leading axis.  Every line rank of a (prof, wn)
    block holds the same block, so "line" takes no part."""
    if mesh is None:
        return x
    if wn_dim is not None:
        x = all_gather_cat(x, mesh.group("wn"), wn_dim, wn_sizes)
    return all_gather_cat(x, mesh.group("prof"), 0)


def gather_to_host(x: torch.Tensor, mesh, wn_dim=None,
                   wn_sizes=None) -> np.ndarray:
    """`gather` to numpy on every rank."""
    return gather(x, mesh, wn_dim, wn_sizes).detach().cpu().numpy()


def free_port() -> int:
    """A free TCP port on localhost, for MASTER_PORT."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv: list[str], n: int, *, env=None, cwd=None,
          timeout: float = 600.0) -> list[tuple[int, str]]:
    """Run `python argv...` as `n` ranks on this host (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR=localhost, a free MASTER_PORT) and wait for
    all.  Unless `env` sets OMP_NUM_THREADS, each rank takes an equal
    share of the host's cores for its intra-op threads (as torchrun
    limits them), so that the ranks' thread pools do not contend.  When a
    rank fails or the time runs out, every rank still running is killed.
    Returns each rank's (exit code, output), stdout and stderr together,
    in rank order."""
    base = dict(os.environ if env is None else env)
    base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1)
                                               // n)))
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(n))
    logs, procs = [], []
    try:
        for r in range(n):
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=cwd,
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        end = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > end:
                break
            time.sleep(0.05)
        out = []
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            f.seek(0)
            out.append((p.returncode, f.read()))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
