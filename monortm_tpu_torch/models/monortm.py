"""Forward model: layered state -> radiance / brightness temperature.

Port of `monortm_tpu.models.monortm` (the reference driver's per-profile
pipeline, monortm.f90:357-588): MODM optical depths -> RTM.  Built once
per run on one device (with `mesh`, one rank's block of a mesh); `forward`
is a function of a (batched) state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from monortm_tpu_torch.lines import PackedCatalog
from monortm_tpu_torch.models.od import (DENSE_LINE_TILE, DENSE_WN_TILE,
                                         ODModel, ODResult)
from monortm_tpu_torch.models.rt import RTResult, rtm
from monortm_tpu_torch.ops.continuum import ContinuumFactors
from monortm_tpu_torch.ops.lineshape import LineConfig
from monortm_tpu_torch.types import LayerState
from monortm_tpu_torch.utils.trace import traced


@dataclasses.dataclass
class ForwardResult:
    rt: RTResult
    od: ODResult
    emis: Any
    refl: Any


class MonoRTM:
    """Configured forward model for one spectral setup, on one device (the
    CUDA card unless `device` names another, e.g. "cpu"), in float32 or
    float64 (`dtype`; float64 takes the dense line engine).  With `mesh`
    (`parallel.sharding.Mesh`) it computes this rank's (prof, wn) block:
    the state is its profile block and the results its columns.

    `tb` and `forward` are differentiable in every float field of the
    state: the retrieval adjoint is torch.autograd on `tb`, as
    jax.value_and_grad is on the JAX side; the line sum's backward is the
    adjoint kernel on the card and the plain adjoint on the CPU.

    The keywords' names against the JAX `MonoRTM`'s (as `ODModel`'s):

        JAX                                port
        wn_tile / line_tile                dense_wn_tile / dense_line_tile
        pallas_wn_tile / pallas_line_tile  wn_tile / line_tile
        use_pallas                         kernels

    `wn_tile` / `line_tile` are the kernel plan's tiles, `dense_wn_tile` /
    `dense_line_tile` the dense engine's; `kernels=False` builds no kernel
    plan and runs the dense engine alone.
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
        self.wn = np.asarray(wn, np.float64)
        self.dtype = dtype
        self.od_model = ODModel(wn, dvset, catalog, nmol=nmol,
                                factors=factors, line_cfg=line_cfg,
                                device=device, dtype=dtype, wn_tile=wn_tile,
                                line_tile=line_tile,
                                dense_wn_tile=dense_wn_tile,
                                dense_line_tile=dense_line_tile,
                                kernels=kernels, mesh=mesh)
        self.device = self.od_model.device

    def engine_split(self, state: LayerState):
        """(engine, lor_layers) for `state`, computed on the model's device
        (see ODModel.engine_split)."""
        return self.od_model.engine_split(state)

    def forward(self, state: LayerState, tsfc, emis, refl, irt: int,
                engine: str = None, lor_layers=None) -> ForwardResult:
        """Complete forward computation for one (batched) profile set.

        engine: an `ODModel` engine, or None for the model's default
        ("full" in float32, "dense" in float64).
        tsfc: a float or a [...] tensor of surface temperatures; emis/refl:
        [W] or [..., W] boundary spectra (tensors on the model's device,
        on the full grid) or numbers; irt: 1 up / 2 limb / 3 down.
        """
        om = self.od_model
        od = om(state, engine=engine, lor_layers=lor_layers)

        def rt(od_total, t, tz, tsfc, emis, refl):
            t_ = om.wn_entry(t.to(self.dtype))
            tz = om.wn_entry(tz.to(self.dtype))
            return rtm(od_total, t_[..., None, :], tz[..., None, :], om.wn_t,
                       tsfc, om.local_wn(emis), om.local_wn(refl), irt)

        res = traced("rt", rt, od.od_total, state.t, state.tz, tsfc, emis,
                     refl)
        return ForwardResult(rt=res, od=od, emis=emis, refl=refl)

    def tb(self, state: LayerState, tsfc, emis, refl, irt: int,
           engine: str = None, lor_layers=None):
        """Brightness temperatures only."""
        return self.forward(state, tsfc, emis, refl, irt, engine=engine,
                            lor_layers=lor_layers).rt.tb
