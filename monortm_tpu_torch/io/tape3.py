"""Raw TAPE3 line records (a copy of `monortm_tpu.io.tape3.RawLines`).

The port builds its catalogs from `RawLines` (`lines.group`); the TAPE3
reader and writer stay in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RawLines:
    """Raw line records in file order (pre-grouping)."""
    vnu: np.ndarray        # f8
    sp: np.ndarray         # f4
    alfa: np.ndarray
    epp: np.ndarray
    mol: np.ndarray        # i4 (for coupling rows this holds r4 payload bits)
    hwhm: np.ndarray
    tmpalf: np.ndarray
    pshift: np.ndarray
    iflg: np.ndarray       # i4
    brd_mol_flg: np.ndarray   # [n, 7] i4
    brd_mol_hw: np.ndarray    # [n, 7] f4
    brd_mol_tmp: np.ndarray   # [n, 7] f4
    brd_mol_shft: np.ndarray  # [n, 7] f4
    speed_dep: np.ndarray

    def __len__(self):
        return len(self.vnu)
