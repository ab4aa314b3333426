"""A configuration's run directories, written from a seed.

`write_pool(config, seed, n_dirs, n_prof, root)` draws the line catalog
and n_dirs x n_prof distinct profiles from the seed and writes one
MONORTM.IN and one TAPE3, shared, and a MONORTM_PROF.IN per directory.
Every seed gives the same sizes; only the values move.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.gen.files import tape5_text, write_profiles, write_tape3
from benchmark.gen.lines import synthetic_lines
from benchmark.gen.profiles import profiles


def write_pool(cfg: dict, seed: int, n_dirs: int, n_prof: int,
               root) -> dict:
    """Write the pool; returns dict(tape5, tape3, profs [paths], lines
    (the TAPE3 records), profiles [per directory, lists of dicts])."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng([seed, 0x6D6F6E6F])
    raw = synthetic_lines(cfg["lines"], int(rng.integers(2 ** 63)))
    write_tape3(root / "TAPE3", raw)
    (root / "MONORTM.IN").write_text(tape5_text(cfg["grid"], cfg["name"]))
    profs, per_dir = [], []
    for i in range(n_dirs):
        ps = profiles(cfg["profile"], n_prof, rng)
        path = root / f"MONORTM_PROF.{i}.IN"
        write_profiles(path, ps)
        profs.append(path)
        per_dir.append(ps)
    return dict(tape5=root / "MONORTM.IN", tape3=root / "TAPE3",
                profs=profs, lines=raw, profiles=per_dir)
