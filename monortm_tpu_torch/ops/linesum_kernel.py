"""Build, bind and launch the CUDA line-sum kernels (`csrc/`).

Two sources, each a shared library with a plain C entry point: the
forward sum `linesum.cu` and its adjoint `linesum_bwd.cu`; both include
the device math of `linesum_math.cuh`.  They are compiled at first use
with `nvcc`, one process per source started together, into `build/` at
the repository root, under names keyed by a hash of the sources, the
header and the flags, and loaded with ctypes.  Importing this module
needs neither nvcc nor a GPU.

`LineSumKernel` is the wrapper of one instantiation (VOIGT true/false):
CPU tensors go to the plain PyTorch versions given to it; CUDA tensors
launch the kernels (or raise — there is no fallback).  Each instance
counts its own forward launches in `.launches` and its adjoint launches
in `.bwd_launches`: calls of the C entry point, so the VOIGT=true
adjoint, whose entry point launches two kernels (the sweep over the
Lorentz lanes and the pass over the SD-Voigt lanes it deferred), counts
one.  The sum is a `torch.autograd.Function` whose backward is the
adjoint kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"forward": CSRC / "linesum.cu", "backward": CSRC / "linesum_bwd.cu"}
HEADERS = (CSRC / "linesum_math.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# streamed per-(layer, line) and per-line operands and the per-line flags,
# as in linesum_pallas; the kernel takes the flags as one bit each
PER_LN = ("shift", "stild", "hw", "ad", "k3v", "ya", "yb")
PER_L = ("nu_hi", "nu_lo", "sdep")
FLAGS = ("o2", "co2", "cpl", "xf1", "xf15", "valid")
FLAG_BITS = {k: 1 << b for b, k in enumerate(FLAGS)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "line-sum kernels need the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    blob = src.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{key[:16]}.so"


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose hash is not built yet, one nvcc each,
    all started together, and return {name: shared library path}."""
    libs = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if verbose else ()),
                   "-o", tmp, str(SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {SOURCES[name].name} failed "
                              f"({proc.returncode}):\n{out}")
            else:
                if verbose:
                    print(f"{SOURCES[name].name}:\n{out}")
                os.replace(tmp, libs[name])    # atomic: all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return libs


# monortm_linesum_forward: voigt, the candidate map and its sizes, 14
# operand pointers, 5 sizes, the output, the stream
FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                + [ctypes.c_void_p] * 2)
# monortm_linesum_{forward,backward}_info: voigt, nt, wt, n_mol, int out[6]
INFO_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
# monortm_linesum_backward: voigt, the reverse map and its sizes, 15
# operand pointers, 5 sizes, 7 cotangents, the deferral scratch, the stream
BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                + [ctypes.c_void_p] * 9)


class _Library:
    """The loaded entry points (loaded once, at first launch)."""

    fns: dict = {}

    @classmethod
    def get(cls, name: str):
        if not cls.fns:
            libs = build()
            cls.fns = {**entry_points(ctypes.CDLL(str(libs["forward"]))),
                       **entry_points(ctypes.CDLL(str(libs["backward"])))}
        return cls.fns[name]


def entry_points(lib: ctypes.CDLL) -> dict:
    """The entry points a built library exports, typed, by role."""
    sigs = {"forward": ("monortm_linesum_forward", FWD_ARGTYPES),
            "forward_info": ("monortm_linesum_forward_info", INFO_ARGTYPES),
            "backward": ("monortm_linesum_backward", BWD_ARGTYPES),
            "backward_info": ("monortm_linesum_backward_info",
                              INFO_ARGTYPES),
            "backward_started": ("monortm_linesum_backward_kernels_started",
                                 [ctypes.c_int])}
    fns = {}
    for role, (sym, argtypes) in sigs.items():
        if hasattr(lib, sym):
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[role] = fn
    return fns


def _check_f32(dev, **tensors):
    for k, v in tensors.items():
        if v.device != dev or v.dtype != torch.float32 \
                or not v.is_contiguous():
            raise ValueError(f"line-sum operand {k}: need a contiguous "
                             f"float32 tensor on {dev}, got {v.dtype} on "
                             f"{v.device}")


def _line_operands(pre, mol, nt: int):
    """Checks shared by both kernels; returns (L, N, flag bits, 0-based
    molecule) for the launch."""
    dev = pre["stild"].device
    L, n = pre["stild"].shape
    _check_f32(dev, **{k: pre[k] for k in PER_LN + PER_L})
    for k in PER_LN:
        if pre[k].shape != (L, n):
            raise ValueError(f"{k}: shape {tuple(pre[k].shape)} != {(L, n)}")
    for k in PER_L:
        if pre[k].shape != (n,):
            raise ValueError(f"{k}: shape {tuple(pre[k].shape)} != {(n,)}")
    if mol.shape != (n,) or mol.device != dev:
        raise ValueError(f"mol: need [{n}] on {dev}")
    if n % nt or not 0 < nt <= 1024 or nt % 32:
        raise ValueError(f"unsupported line tile nt={nt} for {n} lines")
    bits = torch.zeros(n, dtype=torch.int32, device=dev)
    for k, b in FLAG_BITS.items():
        bits |= (pre["flags"][k] > 0.5).to(torch.int32) * b
    return L, n, bits, (mol - 1).to(torch.int32).contiguous()


def _check_maps(dev, names, m, valid, rows: int | None = None):
    """A (map, validity) pair of int32 [rows, slots] tensors."""
    for name, v in zip(names, (m, valid)):
        if v.device != dev or v.dtype != torch.int32 \
                or not v.is_contiguous() or v.ndim != 2 \
                or v.shape != valid.shape \
                or (rows is not None and v.shape[0] != rows):
            raise ValueError(f"{name}: need contiguous int32 [{rows or 'rows'}"
                             f", slots] tensors of one shape on {dev}")


def _check_wn(dev, wn_hi, wn_lo, n_wt: int, wt: int):
    _check_f32(dev, wn_hi=wn_hi, wn_lo=wn_lo)
    if wn_hi.shape != (n_wt * wt,) or wn_lo.shape != (n_wt * wt,):
        raise ValueError(f"wn_hi/wn_lo: need [{n_wt * wt}] for {n_wt} "
                         f"tiles of {wt}")
    if not 0 < wt <= 1024 or wt % 32:
        raise ValueError(f"unsupported wavenumber tile wt={wt}")


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


class LineSumKernel:
    """One instantiation of the kernels (VOIGT true or false) with their
    plain PyTorch versions and launch counts.

    Call with the `ops.linesum.precompute` operands and the plan:
    pre (dict), mol [N] int (1-based molecule id), wn_hi/wn_lo [Wp] f32,
    cand_map/cand_valid [n_wt, n_cand] int32, nt, wt, n_mol, the optional
    CO2 chi hook (plain versions only) and the plan's reverse map
    rev = (rev_map, rev_valid), which the adjoint kernel needs.  Returns
    sf [L, Wp, n_mol] f32, differentiable in the seven PER_LN operands.
    """

    def __init__(self, name: str, voigt: bool, plain, plain_bwd):
        self.name = name
        self.voigt = voigt
        self.plain = plain
        self.plain_bwd = plain_bwd
        self.launches = 0
        self.bwd_launches = 0
        self.deferred = None

    def __call__(self, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                 nt: int, wt: int, n_mol: int, chi_fn=None, rev=None):
        per_ln = tuple(pre[k] for k in PER_LN)
        return _LineSum.apply(self, pre, mol, wn_hi, wn_lo, cand_map,
                              cand_valid, nt, wt, n_mol, chi_fn, rev,
                              *per_ln)

    def launch(self, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
               nt: int, wt: int, n_mol: int):
        """The forward CUDA launch: checks every operand, allocates the
        output, launches on the current stream and raises if the launch
        failed."""
        dev = pre["stild"].device
        L, n, bits, mol0 = _line_operands(pre, mol, nt)
        _check_maps(dev, ("cand_map", "cand_valid"), cand_map, cand_valid)
        n_wt, n_cand = cand_map.shape
        _check_wn(dev, wn_hi, wn_lo, n_wt, wt)
        out = torch.empty((L, n_wt * wt, n_mol), dtype=torch.float32,
                          device=dev)
        ptr = lambda v: v.data_ptr()
        rc = _Library.get("forward")(
            int(self.voigt), ptr(cand_map), ptr(cand_valid), n_wt, n_cand,
            ptr(wn_hi), ptr(wn_lo), *(ptr(pre[k]) for k in PER_L),
            ptr(bits), ptr(mol0), *(ptr(pre[k]) for k in PER_LN),
            L, n, nt, wt, n_mol, ptr(out), _stream(dev))
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"{self.name} line-sum kernel launch failed: "
                               f"CUDA error {rc}")
        return out

    def launch_bwd(self, pre, mol, wn_hi, wn_lo, rev_map, rev_valid,
                   nt: int, wt: int, n_mol: int, g):
        """The adjoint CUDA launch for a cotangent g [L, Wp, n_mol]:
        returns the seven cotangents in PER_LN order (None for ad and k3v
        with VOIGT=false, whose sum reads neither).  With VOIGT=true the
        call's deferral words stay in `.deferred` (int32 [L, N], a bit per
        reverse-map slot in which the line has SD-Voigt lanes) until the
        next call."""
        dev = pre["stild"].device
        L, n, bits, mol0 = _line_operands(pre, mol, nt)
        k_tiles = n // nt
        _check_maps(dev, ("rev_map", "rev_valid"), rev_map, rev_valid,
                    k_tiles)
        n_rev = rev_map.shape[1]
        _check_f32(dev, g=g)
        if g.ndim != 3 or g.shape[0] != L or g.shape[2] != n_mol \
                or g.shape[1] % wt:
            raise ValueError(f"g: need [{L}, n_wt*{wt}, {n_mol}], got "
                             f"{tuple(g.shape)}")
        n_wt = g.shape[1] // wt
        _check_wn(dev, wn_hi, wn_lo, n_wt, wt)
        wrt = [k for k in PER_LN if self.voigt or k not in ("ad", "k3v")]
        outs = {k: torch.empty((L, n), dtype=torch.float32, device=dev)
                for k in wrt}
        self.deferred = (torch.empty((L, n), dtype=torch.int32, device=dev)
                         if self.voigt else None)
        ptr = lambda v: 0 if v is None else v.data_ptr()
        rc = _Library.get("backward")(
            int(self.voigt), ptr(rev_map), ptr(rev_valid), k_tiles, n_rev,
            n_wt, ptr(wn_hi), ptr(wn_lo), *(ptr(pre[k]) for k in PER_L),
            ptr(bits), ptr(mol0), *(ptr(pre[k]) for k in PER_LN), ptr(g),
            L, n, nt, wt, n_mol, *(ptr(outs.get(k)) for k in PER_LN),
            ptr(self.deferred), _stream(dev))
        self.bwd_launches += 1
        if rc != 0:
            raise RuntimeError(f"{self.name} line-sum adjoint kernel launch "
                               f"failed: CUDA error {rc}")
        return tuple(outs.get(k) for k in PER_LN)

    def fwd_info(self, nt: int, wt: int, n_mol: int) -> dict:
        """How the forward kernel of this instantiation was built and fits
        an SM at these tile sizes (needs a CUDA device): threads per
        block, registers per thread, resident blocks per SM, static shared
        memory, wavenumbers per thread and blocks per wavenumber tile."""
        out = (ctypes.c_int * 6)()
        rc = _Library.get("forward_info")(int(self.voigt), nt, wt, n_mol,
                                          out)
        if rc != 0:
            raise RuntimeError(f"{self.name} forward kernel info failed: "
                               f"CUDA error {rc}")
        return dict(zip(("threads", "registers", "blocks_per_sm",
                         "smem_bytes", "wn_per_thread", "blocks_per_tile"),
                        out))

    def bwd_kernels_started(self) -> int:
        """The kernels the adjoint's entry point has started for this
        instantiation in this process, as the library itself counts them:
        beside `.bwd_launches` it says how many kernels one call starts."""
        return _Library.get("backward_started")(int(self.voigt))

    def bwd_info(self, nt: int, wt: int, n_mol: int) -> dict:
        """How the adjoint kernels of this instantiation were built and
        fit an SM at these tile sizes (needs a CUDA device): threads per
        block, registers per thread, resident blocks per SM and dynamic
        shared memory of the sweep; registers and blocks per SM of the
        deferred pass (VOIGT=true)."""
        out = (ctypes.c_int * 6)()
        rc = _Library.get("backward_info")(int(self.voigt), nt, wt, n_mol,
                                           out)
        if rc != 0:
            raise RuntimeError(f"{self.name} adjoint kernel info failed: "
                               f"CUDA error {rc}")
        info = dict(zip(("threads", "registers", "blocks_per_sm",
                         "smem_bytes"), out[:4]))
        if self.voigt:
            info["deferred"] = {"registers": out[4], "blocks_per_sm": out[5]}
        return info


def reverse_map(cand_map: np.ndarray, cand_valid: np.ndarray,
                k_tiles: int):
    """Transpose of the candidate map: for each catalog line tile, the wn
    tiles that list it as a candidate, in ascending order, packed left,
    with a validity mask (host numpy; `linesum_pallas._reverse_map`).
    The adjoint kernel walks one row of it per block."""
    cm = np.asarray(cand_map)
    cv = np.asarray(cand_valid)
    lists: list[list[int]] = [[] for _ in range(k_tiles)]
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            if cv[i, j]:
                lists[cm[i, j]].append(i)
    n_rev = max(max((len(x) for x in lists), default=1), 1)
    rmap = np.zeros((k_tiles, n_rev), np.int32)
    rvalid = np.zeros((k_tiles, n_rev), np.int32)
    for kk, x in enumerate(lists):
        rmap[kk, :len(x)] = x
        rvalid[kk, :len(x)] = 1
    return rmap, rvalid


def _device_kind(kernel, dev):
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{kernel.name} line sum: no kernel for device "
                           f"{dev}")
    return dev.type


class _LineSum(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain version (CPU); the
    backward through the adjoint kernel (CUDA) or the plain adjoint
    (CPU)."""

    @staticmethod
    def forward(ctx, kernel, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                nt, wt, n_mol, chi_fn, rev, *per_ln):
        dev = pre["stild"].device
        ctx.kernel = kernel
        ctx.plan = (mol, wn_hi, wn_lo, cand_map, cand_valid, nt, wt, n_mol,
                    chi_fn, rev)
        ctx.static = {k: pre[k] for k in PER_L}
        ctx.static["flags"] = pre["flags"]
        ctx.save_for_backward(*per_ln)
        if _device_kind(kernel, dev) == "cpu":
            return kernel.plain(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                                nt, wt, n_mol, chi_fn)
        if chi_fn is not None:
            # a Python callable cannot enter the kernel (lineshape.py:43-51)
            raise NotImplementedError(
                "LineConfig.chi_fn is not supported by the CUDA line-sum "
                "kernel; run with chi_fn=None or on CPU tensors")
        return kernel.launch(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                             nt, wt, n_mol)

    @staticmethod
    def backward(ctx, g):
        kernel = ctx.kernel
        mol, wn_hi, wn_lo, cand_map, cand_valid, nt, wt, n_mol, chi_fn, \
            rev = ctx.plan
        pre = dict(zip(PER_LN, ctx.saved_tensors))
        pre.update(ctx.static)
        g = g.contiguous()
        if _device_kind(kernel, g.device) == "cpu":
            grads = kernel.plain_bwd(pre, mol, wn_hi, wn_lo, cand_map,
                                     cand_valid, nt, wt, n_mol, g, chi_fn)
        else:
            if rev is None:
                raise ValueError(f"{kernel.name} line-sum adjoint: the "
                                 "kernel needs the plan's reverse map "
                                 "(rev=(rev_map, rev_valid))")
            grads = kernel.launch_bwd(pre, mol, wn_hi, wn_lo, *rev, nt, wt,
                                      n_mol, g)
        return (None,) * 12 + tuple(grads)
