"""The continuum and cloud stage on CUDA float32 tensors (csrc/continuum.cu).

`pack` lays out a `ContinuumPlan` once for the kernels, on the plan's
device: every sub-continuum's kind, species, window table columns (its
float64 tables cast to float32 once), stage-1 XINT targets, taps and
weights and the reverse map of those taps by window point; the stage-2
taps and weights of every wavenumber and their reverse map by ABSRB
point; the grid in float32, Rayleigh's ABSRB grid and base.  The arrays
are one int32 and one float32 tensor and a host layout of offsets
(LAYOUT), so a call passes three pointers for the plan.

`ContinuumKernel` is the wrapper (`models.od.ODModel` calls it for CUDA
float32 states; others take the eager `ContinuumPlan.__call__` and
`ops.cloud.od_clw`): a `torch.autograd.Function` whose forward is one
call of the forward's entry point (two kernels: the ABSRB points, then
the wavenumbers) and whose backward is one call of the adjoint's (one
kernel), counted in `.launches` and `.bwd_launches`.  It takes layer rows
of any leading shape and returns the six species' ODs and the cloud's OD
on the plan's whole grid, [..., W] each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from monortm_tpu_torch.data import loader
from monortm_tpu_torch.ops.linesum_kernel import _Library, _check_f32, _stream

# sub-continuum kinds (csrc/continuum_math.cuh, Kind) and the table columns
# each reads, in the order of its `cols` block
KINDS = ("h2o_self", "h2o_frgn", "co2_frgn", "o3_chap", "o3_hh", "o3_uv",
         "o2_fund", "o2_inf1", "o2_inf2", "o2_aband", "o2_vis", "o2_herz",
         "o2_fuv", "n2_rt", "n2_fund", "n2_overtone")
COLUMNS = {"h2o_self": ("tab", "s260"), "h2o_frgn": ("tab", "fscal"),
           "co2_frgn": ("tab", "cfac", "e"), "o3_chap": ("x", "y", "z"),
           "o3_hh": ("tab", "ct1", "ct2"), "o3_uv": ("c0",),
           "o2_fund": ("tab", "xo2t", "vj"), "o2_inf1": ("c0",),
           "o2_inf2": ("c0",), "o2_aband": ("c0",), "o2_vis": ("c0",),
           "o2_herz": ("c0",), "o2_fuv": ("c0",),
           "n2_rt": ("tab", "c220", "sf296", "sf220"),
           "n2_fund": ("tab", "x228", "a_h2o", "vj"), "n2_overtone": ("c0",)}
# each kind's ContinuumFactors field, by the name's first part
FACTORS = {"h2o_self": "xself", "h2o_frgn": "xfrgn", "co2": "xco2c",
           "o3": "xo3cn", "o2": "xo2cn", "n2": "xn2cn"}
# the species of the outputs, in the kernels' order (ops.continuum.SPECIES)
# and the cloud's
OUTPUTS = ("h2o", "co2", "o3", "o2", "n2", "rayleigh", "cloud")
# the host layout (csrc/continuum.cu, Layout): offsets of the int32
# arrays, of the float32 arrays, then the sizes
INT_ARRAYS = ("meta", "s1_src", "s1_rptr", "s1_rev", "s2_src", "s2_rptr",
              "s2_rev")
FLT_ARRAYS = ("fac", "cols", "s1_w", "s2_w", "wn", "wnscale", "ray_v",
              "ray_base")
SIZES = ("n_subs", "n_wn", "nptabs", "nmol", "has_ray", "n_win")
LAYOUT = INT_ARRAYS + FLT_ARRAYS + SIZES
# the ABSRB species (+ Rayleigh) and the molecule columns of a row
N_SPECIES, N_WK = 6, 39
# threads per block of the forward's kernels; CUDA's limit on gridDim.y
ABS_THREADS, COL_THREADS, MAX_GRID_Y = 128, 256, 65535


def _taps_by_point(src: np.ndarray, n_points: int):
    """The reverse map of XINT taps: for entries with padded source index
    `src` (taps src-1..src+2 read points src-3+i), each point's (entry *
    4 + tap) values, entries ascending; returned as row pointers
    [n_points + 1] into the values and the values."""
    n = len(src)
    code = np.arange(4 * n)
    pt = np.repeat(np.asarray(src, np.int64), 4) - 3 + code % 4
    keep = (pt >= 0) & (pt < n_points)
    code, pt = code[keep], pt[keep]
    order = np.argsort(pt, kind="stable")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(pt, minlength=n_points))])
    return ptr, code[order]


def pack(plan) -> dict:
    """`plan` (a `ContinuumPlan`) laid out for the kernels on its device
    (see the module docstring): {"ints", "flts", "layout", "teff", "n_wn",
    "nptabs"}.  The float64 tables and weights are cast to float32 on the
    host (numpy rounds to nearest as the device's cast does) and uploaded
    in one copy; float32(wn / 1e4) is formed on the device, as the eager
    stage forms it."""
    nmol = plan.nmol
    if not 1 <= nmol <= N_WK:
        raise ValueError(f"continuum kernel: nmol {nmol} outside 1..{N_WK}")
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32).reshape(-1)
    ints = {k: [] for k in INT_ARRAYS}
    flts = {k: [] for k in FLT_ARRAYS}
    col = ent = rev = win = n_rev = 0
    for sub in plan.subs:
        keys = COLUMNS[sub.name]
        nptc = int(sub.static[keys[0]].shape[0])
        t = np.asarray(sub.plan.target_idx, np.int64)
        t0 = int(t[0]) if len(t) else 0
        if not np.array_equal(t, t0 + np.arange(len(t))):
            raise ValueError(f"continuum kernel: {sub.name}'s stage-1 "
                             "targets are not one run of ABSRB points")
        ptr, code = _taps_by_point(sub.plan.src_idx, nptc)
        factor = getattr(plan.factors, FACTORS.get(sub.name)
                         or FACTORS[sub.name.split("_")[0]])
        ints["meta"].append([KINDS.index(sub.name),
                             ("h2o", "co2", "o3", "o2", "n2").index(
                                 sub.species), nptc, col, t0, len(t), ent,
                             rev, win])
        ints["s1_src"].append(sub.plan.src_idx)
        ints["s1_rptr"].append(ptr + n_rev)
        ints["s1_rev"].append(code + 4 * ent)
        flts["fac"].append(f32([factor]))
        flts["cols"] += [f32(sub.static[k]) for k in keys]
        flts["s1_w"].append(f32(sub.plan.weights))
        col += nptc * len(keys)
        ent += len(t)
        rev += nptc + 1
        win += nptc
        n_rev += len(code)
    # stage 2: every wavenumber's taps, -1 where no ABSRB point reaches it
    n_wn, nptabs = len(plan.wn), plan.nptabs
    tgt = np.asarray(plan.stage2.target_idx, np.int64)
    if len(np.unique(tgt)) != len(tgt):
        raise ValueError("continuum kernel: stage-2 targets repeat")
    src2 = np.full(n_wn, -1, np.int64)
    src2[tgt] = plan.stage2.src_idx
    w2 = np.zeros((n_wn, 4), np.float32)
    w2[tgt] = plan.stage2.weights
    ptr2, code2 = _taps_by_point(plan.stage2.src_idx, nptabs)
    ints["s2_src"].append(src2)
    ints["s2_rptr"].append(ptr2)
    ints["s2_rev"].append(tgt[code2 >> 2] * 4 + (code2 & 3))
    flts["s2_w"].append(w2.reshape(-1))
    flts["wn"].append(f32(plan.wn))
    has_ray = plan.rayleigh_base is not None
    if has_ray:
        v, base = (a.cpu().numpy() for a in plan.rayleigh_base)
        flts["wnscale"].append(np.zeros(n_wn, np.float32))   # below
        flts["ray_v"].append(f32(v))
        flts["ray_base"].append(f32(base))
    sizes = {"n_subs": len(plan.subs), "n_wn": n_wn, "nptabs": nptabs,
             "nmol": nmol, "has_ray": int(has_ray), "n_win": win}
    layout, i_parts, f_parts, n_i, n_f = [], [], [], 0, 0
    for k in INT_ARRAYS:
        a = (np.concatenate([np.asarray(x, np.int64).reshape(-1)
                             for x in ints[k]]) if ints[k]
             else np.zeros(0, np.int64))
        if a.size and (a.min() < -1 or a.max() >= 2**31):
            raise ValueError(f"continuum kernel: {k} outside int32")
        layout.append(n_i)
        i_parts.append(a.astype(np.int32))
        n_i += a.size
    for k in FLT_ARRAYS:
        a = np.concatenate(flts[k]) if flts[k] else np.zeros(0, np.float32)
        layout.append(n_f)
        f_parts.append(a)
        n_f += a.size
    layout += [sizes[k] for k in SIZES]
    dev = plan.device
    flt = torch.as_tensor(np.concatenate(f_parts), device=dev)
    if has_ray:
        at = layout[LAYOUT.index("wnscale")]
        flt[at:at + n_wn] = (plan.wn_t / 1.0e4).to(torch.float32)
    return {"ints": torch.as_tensor(np.concatenate(i_parts), device=dev),
            "flts": flt, "layout": np.asarray(layout, np.int64),
            "teff": float(loader.mt_ckd()["co2_t_eff"]),
            "n_wn": n_wn, "nptabs": nptabs}


class ContinuumKernel:
    """The continuum and cloud of CUDA float32 layer rows (csrc/continuum.cu)
    and its launch counts.

    Call with a `ContinuumPlan` on a card and the state's p, t, wbroad,
    clw [...] and wk [..., 39] (float32, one card; the layers on the last
    axis, or flat rows): returns ({species: [..., W]} for
    ops.continuum.SPECIES, the cloud's OD [..., W]) on the plan's grid,
    differentiable in the five inputs.  `.launches` counts calls of the
    forward's entry point (two kernels each), `.bwd_launches` of the
    adjoint's (one kernel)."""

    name = "continuum"

    def __init__(self):
        self.launches = 0
        self.bwd_launches = 0

    def __call__(self, plan, p, t, wk, wbroad, clw):
        pk = plan.kernel_pack
        if pk is None:
            raise ValueError("continuum kernel: the plan is not on a CUDA "
                             "device")
        outs = _Continuum.apply(self, pk, p, t, wk, wbroad, clw)
        return dict(zip(OUTPUTS[:-1], outs[:-1])), outs[-1]

    @staticmethod
    def _check(pk, p, t, wk, wbrod, clw):
        dev = pk["flts"].device
        R = p.shape[0]
        _check_f32(dev, p=p, t=t, wk=wk, wbrod=wbrod, clw=clw)
        for k, v, shape in (("p", p, (R,)), ("t", t, (R,)),
                            ("wbrod", wbrod, (R,)), ("clw", clw, (R,)),
                            ("wk", wk, (R, N_WK))):
            if v.shape != shape:
                raise ValueError(f"continuum {k}: shape {tuple(v.shape)} != "
                                 f"{shape}")
        if -(-pk["n_wn"] // COL_THREADS) > MAX_GRID_Y \
                or -(-N_SPECIES * pk["nptabs"] // ABS_THREADS) > MAX_GRID_Y:
            raise ValueError(f"continuum kernel: {pk['n_wn']} wavenumbers or "
                             f"{pk['nptabs']} ABSRB points exceed the grid")
        return dev, R

    def _plan_args(self, pk):
        return (pk["ints"].data_ptr(), pk["flts"].data_ptr(),
                pk["layout"].ctypes.data, pk["teff"])

    def launch(self, pk, p, t, wk, wbrod, clw, lead=None):
        """The forward on flat rows: the seven outputs [R, W] (lead + (W,)
        where `lead` is the rows' shape) and the ABSRB scratch [R, 6,
        nptabs] the adjoint reads."""
        dev, R = self._check(pk, p, t, wk, wbrod, clw)
        e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        outs = [e(*(lead or (R,)), pk["n_wn"]) for _ in OUTPUTS]
        absrb = e(R, N_SPECIES, pk["nptabs"])
        rc = _Library.get("continuum")(
            *self._plan_args(pk), p.data_ptr(), t.data_ptr(), wk.data_ptr(),
            wbrod.data_ptr(), clw.data_ptr(), R, absrb.data_ptr(),
            *(o.data_ptr() for o in outs), _stream(dev))
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"continuum kernel launch failed: CUDA error "
                               f"{rc}")
        return tuple(outs), absrb

    def launch_bwd(self, pk, p, t, wk, wbrod, clw, absrb, g):
        """The adjoint for the cotangents g of the seven outputs (None for
        zero): the gradients of p, t, wk, wbrod and clw."""
        dev, R = self._check(pk, p, t, wk, wbrod, clw)
        for k, v in zip(OUTPUTS, g):
            if v is not None:
                _check_f32(dev, **{f"d{k}": v})
                if v.numel() != R * pk["n_wn"] or v.shape[-1] != pk["n_wn"]:
                    raise ValueError(f"continuum d{k}: shape "
                                     f"{tuple(v.shape)} is not {R} rows of "
                                     f"{pk['n_wn']}")
        e = lambda *shape, dtype=torch.float32: torch.empty(
            shape, dtype=dtype, device=dev)
        rf = e(R, pk["n_wn"])
        gab = e(R, N_SPECIES, pk["nptabs"], dtype=torch.float64)
        grads = e(R), e(R), e(R, N_WK), e(R), e(R)
        ptr = lambda v: 0 if v is None else v.data_ptr()
        rc = _Library.get("continuum_bwd")(
            *self._plan_args(pk), p.data_ptr(), t.data_ptr(), wk.data_ptr(),
            wbrod.data_ptr(), clw.data_ptr(), R, absrb.data_ptr(),
            *(ptr(v) for v in g), rf.data_ptr(), gab.data_ptr(),
            *(v.data_ptr() for v in grads), _stream(dev))
        self.bwd_launches += 1
        if rc != 0:
            raise RuntimeError(f"continuum adjoint kernel launch failed: "
                               f"CUDA error {rc}")
        return grads

    @staticmethod
    def registers() -> dict:
        """Registers per thread of the forward's two kernels and of the
        adjoint (needs a CUDA device)."""
        out = (ctypes.c_int * 3)()
        rc = _Library.get("continuum_info")(out)
        if rc != 0:
            raise RuntimeError(f"continuum kernel info failed: CUDA error "
                               f"{rc}")
        return dict(zip(("absrb", "cols", "bwd"), out))


class _Continuum(torch.autograd.Function):
    """The forward kernels, the adjoint kernel backward.  The rows come
    and the outputs go in the state's shape ([..., L], wk [..., L, 39];
    [..., L, W]): flattened here, so that neither way adds a node or a
    copy per output.  The OD sum hands the seven outputs one cotangent,
    made contiguous once."""

    @staticmethod
    def forward(ctx, kernel, pk, p, t, wk, wbrod, clw):
        lead = tuple(p.shape)
        flat = lambda a, trail=(): a.reshape((-1,) + trail).contiguous()
        rows = (flat(p), flat(t), flat(wk, (N_WK,)), flat(wbrod), flat(clw))
        outs, absrb = kernel.launch(pk, *rows, lead=lead)
        ctx.set_materialize_grads(False)
        ctx.kernel, ctx.pk, ctx.lead = kernel, pk, lead
        ctx.save_for_backward(*rows, absrb)
        return outs

    @staticmethod
    def backward(ctx, *g):
        if all(v is None for v in g):
            return (None,) * 7
        made = {}

        def rows(v):
            key = (v.data_ptr(), v.shape, v.stride())
            if key not in made:
                made[key] = v.contiguous().reshape(-1, v.shape[-1])
            return made[key]

        g = tuple(None if v is None else rows(v) for v in g)
        gp, gt, gwk, gwb, gclw = ctx.kernel.launch_bwd(ctx.pk,
                                                       *ctx.saved_tensors, g)
        lead = ctx.lead
        return (None, None, gp.reshape(lead), gt.reshape(lead),
                gwk.reshape(lead + (N_WK,)), gwb.reshape(lead),
                gclw.reshape(lead))
