"""Build, bind and launch the CUDA line-sum kernel (`csrc/linesum.cu`).

The kernel is compiled at first use with `nvcc` into `build/` at the
repository root, under a name keyed by a hash of the source and the
flags, and loaded with ctypes through its plain C entry point.  Importing
this module needs neither nvcc nor a GPU.

`LineSumKernel` is the wrapper: CPU tensors go to the plain PyTorch
version given to it; CUDA tensors launch the kernel (or raise — there is
no fallback).  Each instance counts its own kernel launches in
`.launches`.  It is a `torch.autograd.Function` whose backward raises: the
adjoint kernel is not ported yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "linesum.cu"
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
                           "line-sum kernel needs the CUDA toolkit")
    return str(path)


def build(verbose: bool = False) -> Path:
    """Compile the kernel (if this source/flag hash is not built yet) and
    return the shared library's path."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"linesum-{key[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, lib)           # atomic: a reader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


class _Library:
    """The loaded shared library (loaded once, at first launch)."""

    handle = None

    @classmethod
    def get(cls):
        if cls.handle is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.monortm_linesum_forward
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = ([I, P, P, I, I] + [P] * 14 + [I] * 5 + [P, P])
            fn.restype = I
            cls.handle = fn
        return cls.handle


class LineSumKernel:
    """One instantiation of the kernel (VOIGT true or false) with its plain
    PyTorch version and its launch count.

    Call with the `ops.linesum.precompute` operands and the plan:
    pre (dict), mol [N] int (1-based molecule id), wn_hi/wn_lo [Wp] f32,
    cand_map/cand_valid [n_wt, n_cand] int32, nt, wt, n_mol, and the
    optional CO2 chi hook (plain version only).  Returns sf [L, Wp, n_mol]
    f32.
    """

    def __init__(self, name: str, voigt: bool, plain):
        self.name = name
        self.voigt = voigt
        self.plain = plain
        self.launches = 0

    def __call__(self, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                 nt: int, wt: int, n_mol: int, chi_fn=None):
        per_ln = tuple(pre[k] for k in PER_LN)
        return _LineSum.apply(self, pre, mol, wn_hi, wn_lo, cand_map,
                              cand_valid, nt, wt, n_mol, chi_fn, *per_ln)

    def launch(self, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
               nt: int, wt: int, n_mol: int):
        """The CUDA launch: checks every operand, allocates the output,
        launches on the current stream and raises if the launch failed."""
        dev = pre["stild"].device
        L, n = pre["stild"].shape
        n_wt, n_cand = cand_map.shape
        f32 = {k: pre[k] for k in PER_LN + PER_L}
        f32.update(wn_hi=wn_hi, wn_lo=wn_lo)
        for k, v in f32.items():
            if v.device != dev or v.dtype != torch.float32 \
                    or not v.is_contiguous():
                raise ValueError(f"line-sum operand {k}: need a contiguous "
                                 f"float32 tensor on {dev}, got {v.dtype} "
                                 f"on {v.device}")
        for k in PER_LN:
            if pre[k].shape != (L, n):
                raise ValueError(f"{k}: shape {tuple(pre[k].shape)} != "
                                 f"{(L, n)}")
        for k in PER_L:
            if pre[k].shape != (n,):
                raise ValueError(f"{k}: shape {tuple(pre[k].shape)} != {(n,)}")
        for k, v in (("cand_map", cand_map), ("cand_valid", cand_valid)):
            if v.device != dev or v.dtype != torch.int32 \
                    or not v.is_contiguous() or v.shape != (n_wt, n_cand):
                raise ValueError(f"{k}: need contiguous int32 "
                                 f"[{n_wt}, {n_cand}] on {dev}")
        if wn_hi.shape != (n_wt * wt,) or wn_lo.shape != (n_wt * wt,):
            raise ValueError(f"wn_hi/wn_lo: need [{n_wt * wt}] for {n_wt} "
                             f"tiles of {wt}")
        if n % nt or not 0 < wt <= 1024 or wt % 32:
            raise ValueError(f"unsupported tiles nt={nt} wt={wt} for "
                             f"{n} lines")
        if mol.shape != (n,) or mol.device != dev:
            raise ValueError(f"mol: need [{n}] on {dev}")

        bits = torch.zeros(n, dtype=torch.int32, device=dev)
        for k, b in FLAG_BITS.items():
            bits |= (pre["flags"][k] > 0.5).to(torch.int32) * b
        mol0 = (mol - 1).to(torch.int32).contiguous()
        out = torch.empty((L, n_wt * wt, n_mol), dtype=torch.float32,
                          device=dev)
        fn = _Library.get()
        ptr = lambda v: v.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(int(self.voigt), ptr(cand_map), ptr(cand_valid), n_wt,
                    n_cand, ptr(wn_hi), ptr(wn_lo),
                    *(ptr(pre[k]) for k in PER_L), ptr(bits), ptr(mol0),
                    *(ptr(pre[k]) for k in PER_LN),
                    L, n, nt, wt, n_mol, ptr(out), stream)
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"{self.name} line-sum kernel launch failed: "
                               f"CUDA error {rc}")
        return out


class _LineSum(torch.autograd.Function):
    """Forward through the kernel (CUDA) or the plain version (CPU)."""

    @staticmethod
    def forward(ctx, kernel, pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                nt, wt, n_mol, chi_fn, *per_ln):
        dev = pre["stild"].device
        if dev.type == "cpu":
            return kernel.plain(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                                nt, wt, n_mol, chi_fn)
        if dev.type != "cuda":
            raise RuntimeError(f"{kernel.name} line sum: no kernel for "
                               f"device {dev}")
        if chi_fn is not None:
            # a Python callable cannot enter the kernel (lineshape.py:43-51)
            raise NotImplementedError(
                "LineConfig.chi_fn is not supported by the CUDA line-sum "
                "kernel; run with chi_fn=None or on CPU tensors")
        return kernel.launch(pre, mol, wn_hi, wn_lo, cand_map, cand_valid,
                             nt, wt, n_mol)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "line-sum adjoint not yet ported (B2: linesum_pallas._bwd_kernel)")

