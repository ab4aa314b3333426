"""Command-line driver: `python -m monortm_tpu_torch.cli [options]`.

Reads MONORTM.IN (+ MONORTM_PROF.IN when IATM=0, TAPE3) and writes
MONORTM.OUT and MONORTM.LOG (plus TAPE7, IOD=1 layer files and
`--netcdf` files where asked), like PROGRAM MONORTM
(monortm.f90:292-298), on one CUDA card unless `--device cpu`.  A port
of `monortm_tpu.cli`, taking every option of its command line with its
meaning.  `--precision float64` runs the dense line engine; `--engine`
picks the line engine as `pipeline.run` does (under the port's names or
the JAX CLI's, xla and pallas); `--wn-tile` / `--line-tile` set the
dense engine's block, and leave the kernels' plan as it is.

Several ranks: start one process per rank with RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT set (torchrun, or
`parallel.distributed.spawn`) and pass `--distributed`.  Each rank takes
the card cuda:LOCAL_RANK unless `--device` names one (`--device cuda:0`
puts every rank on one card, which needs `--backend gloo`; `--device
cpu` runs the ranks on the CPU).  `--mesh` shapes the ranks (its size
must be the world's); every rank prints its backend and device, and its
line-sum kernel launches at the end; rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _mesh_arg(text: str):
    """'auto', 'off' or PxW[xL] -> 'auto', None or (n_prof, n_wn, n_line)."""
    if text in ("auto", "off"):
        return None if text == "off" else text
    dims = [int(v) for v in text.lower().split("x")]
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise argparse.ArgumentTypeError(f"mesh must be auto, off or "
                                         f"PROFxWN[xLINE]: {text!r}")
    return (dims[0], dims[1], dims[2] if len(dims) == 3 else 1)


def _tile_arg(text: str) -> int:
    """A tile size: a positive integer."""
    try:
        n = int(text)
    except ValueError:
        n = 0
    if n < 1:
        raise argparse.ArgumentTypeError(f"a tile must be a positive "
                                         f"integer: {text!r}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monortm-tpu-torch",
                                 description=__doc__)
    ap.add_argument("--in", dest="filein", default="MONORTM.IN")
    ap.add_argument("--prof", dest="fileprof", default="MONORTM_PROF.IN")
    ap.add_argument("--tape3", dest="hfile", default="TAPE3")
    ap.add_argument("--out", dest="fileout", default="MONORTM.OUT")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device: 'cuda' (the default; fails without "
                         "a card; with --distributed the rank's card "
                         "cuda:LOCAL_RANK), 'cuda:N' (a named card) or "
                         "'cpu' (plain line sums)")
    ap.add_argument("--precision", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--wn-tile", type=_tile_arg, default=128,
                    help="the dense engine's block of wavenumbers (the JAX "
                         "CLI's flag); the kernels keep their own plan")
    ap.add_argument("--line-tile", type=_tile_arg, default=4096,
                    help="the dense engine's block of lines (the JAX CLI's "
                         "flag); the kernels keep their own plan")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "dense", "full", "hybrid", "xla",
                             "pallas"),
                    help="line engine: auto (float32: both kernels through "
                         "the per-chunk engine split; float64: dense), "
                         "dense or xla (the dense engine), full or pallas "
                         "(the VOIGT=true kernel alone) or hybrid; the "
                         "kernels are float32 only, and float64 with a "
                         "kernel engine raises")
    ap.add_argument("--netcdf", action="store_true",
                    help="also write MONORTM.NNNNN.nc per profile "
                         "(USENETCDF build option of the reference)")
    ap.add_argument("--workers", type=int, default=None,
                    help="host processes for IATM=1 layering "
                         "(default: auto for large profile stacks)")
    ap.add_argument("--mesh", type=_mesh_arg, default="auto",
                    metavar="PROFxWN[xLINE]",
                    help="rank mesh: 'auto' (default; every rank on a "
                         "(prof, wn) mesh), 'off' (each rank alone) or a "
                         "shape like '2x2'; a third factor splits the "
                         "candidate line tiles, e.g. '1x1x2'")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed run that RANK, "
                         "WORLD_SIZE, MASTER_ADDR and MASTER_PORT describe")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="with --distributed: nccl (the default on cards; "
                         "one card per rank) or gloo (the default on the "
                         "CPU; ranks that share a card)")
    args = ap.parse_args(argv)
    if args.backend and not args.distributed:
        ap.error("--backend needs --distributed")

    import torch
    import torch.distributed as dist

    from monortm_tpu_torch.parallel import distributed
    from monortm_tpu_torch.parallel.sharding import make_mesh
    from monortm_tpu_torch.pipeline import run

    device = args.device or "cuda"
    joined = False
    if args.distributed:
        device = distributed.rank_device(args.device)
        backend = args.backend or ("gloo" if device.type == "cpu"
                                   else "nccl")
        joined = distributed.init_distributed(backend, device)
        if not joined:
            print("monortm-tpu-torch: --distributed set but WORLD_SIZE is "
                  "not above 1; running one process")
    try:
        if joined:
            devs = distributed.rank_devices(device)
            shared = [r for r, d in enumerate(devs) if d == str(device)]
            print(f"monortm-tpu-torch: rank {dist.get_rank()} of "
                  f"{dist.get_world_size()}: backend {dist.get_backend()}, "
                  f"device {device}"
                  + (f" (shared by ranks {shared})" if len(shared) > 1
                     else ""), flush=True)
        mesh = args.mesh
        if isinstance(mesh, tuple):
            mesh = make_mesh(n_prof=mesh[0], n_wn=mesh[1], n_line=mesh[2])
        t0 = time.time()
        res = run(filein=args.filein, fileprof=args.fileprof,
                  hfile=args.hfile, fileout=args.fileout,
                  outdir=args.outdir, device=device,
                  dtype=getattr(torch, args.precision), engine=args.engine,
                  wn_tile=args.wn_tile, line_tile=args.line_tile,
                  netcdf=args.netcdf, workers=args.workers, mesh=mesh)
        dt = time.time() - t0
        from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL
        from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
        rank = dist.get_rank() if joined else 0
        print(f"monortm-tpu-torch: rank {rank}: line-sum kernel launches "
              + json.dumps({k.name: k.launches
                            for k in (VOIGT_KERNEL, LORENTZ_KERNEL)}),
              flush=True)
        print(f"monortm-tpu-torch: {len(res.tb)} profile(s) x "
              f"{len(res.wn)} wavenumber(s) in {dt:.2f}s")
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
