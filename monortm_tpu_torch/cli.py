"""Command-line driver: `python -m monortm_tpu_torch.cli [options]`.

Reads MONORTM.IN (+ MONORTM_PROF.IN when IATM=0, TAPE3) and writes
MONORTM.OUT and MONORTM.LOG (plus TAPE7, IOD=1 layer files and
`--netcdf` files where asked), like PROGRAM MONORTM
(monortm.f90:292-298), on one CUDA card unless `--device cpu`.  A port
of `monortm_tpu.cli`: one device, so no mesh options.  `--precision
float64` runs the dense line engine; `--engine` picks the line engine as
`pipeline.run` does.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monortm-tpu-torch",
                                 description=__doc__)
    ap.add_argument("--in", dest="filein", default="MONORTM.IN")
    ap.add_argument("--prof", dest="fileprof", default="MONORTM_PROF.IN")
    ap.add_argument("--tape3", dest="hfile", default="TAPE3")
    ap.add_argument("--out", dest="fileout", default="MONORTM.OUT")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default; fails without a "
                         "card) or 'cpu' (plain line sums)")
    ap.add_argument("--precision", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--engine", choices=("auto", "dense", "full", "hybrid"),
                    default="auto",
                    help="line engine: auto (float32: both kernels through "
                         "the per-chunk engine split; float64: dense), "
                         "dense, full (the VOIGT=true kernel alone) or "
                         "hybrid; the kernels are float32 only")
    ap.add_argument("--netcdf", action="store_true",
                    help="also write MONORTM.NNNNN.nc per profile "
                         "(USENETCDF build option of the reference)")
    ap.add_argument("--workers", type=int, default=None,
                    help="host processes for IATM=1 layering "
                         "(default: auto for large profile stacks)")
    args = ap.parse_args(argv)

    import torch

    from monortm_tpu_torch.pipeline import run

    t0 = time.time()
    res = run(filein=args.filein, fileprof=args.fileprof, hfile=args.hfile,
              fileout=args.fileout, outdir=args.outdir, device=args.device,
              dtype=getattr(torch, args.precision), engine=args.engine,
              netcdf=args.netcdf, workers=args.workers)
    dt = time.time() - t0
    print(f"monortm-tpu-torch: {len(res.tb)} profile(s) x {len(res.wn)} "
          f"wavenumber(s) in {dt:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
