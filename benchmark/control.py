"""The control of a cell's check: the plain reference put in the
program's place, computed in the precision below the configuration's
(`BELOW`: bfloat16 for float32, float32 for float64), judged by the
cell's comparison against the float64 reference.  It has to come out not
correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--device cuda]

prints one JSON line per seed with each compared number beside its
limit, at the cell's own sizes; no run of the program is involved.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BELOW = {"float32": "bfloat16", "float64": "float32"}
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)


def control(c, seed: int, dtype, device, work=None) -> tuple:
    """The control's readings of cell c (run.load_cell's) on one seed, and
    the driver's detail of them ({} where it has none); its inputs go
    under `work` (default: TMPDIR's monortm-benchmark-control)."""
    from benchmark.run import driver_of
    work = Path(work or Path(tempfile.gettempdir())
                / "monortm-benchmark-control") / c.name
    shutil.rmtree(work, ignore_errors=True)
    _, drv = driver_of(c, seed, device, work)
    try:
        drv.inputs()
        return drv.control(device, dtype), getattr(drv, "detail", {})
    finally:
        drv.cleanup()


def main(argv=None) -> int:
    import torch

    from benchmark.run import judge, load_cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    c = load_cell(a.workload)
    dtype = BELOW[c.cfg["precision"]]
    for s in a.seeds.split(","):
        gaps, detail = control(c, int(s), getattr(torch, dtype), a.device)
        ok, rows = judge(gaps, c.limits)
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "dtype": dtype, "correct": ok,
                          "checks": {k: {"value": str(v), "limit": lim}
                                     for k, v, lim in rows},
                          "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
