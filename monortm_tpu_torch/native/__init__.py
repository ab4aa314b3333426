"""ctypes binding of the port's native host helper (`monortm_native.cpp`).

A byte-for-byte copy of the JAX package's C++ source with the four entry
points of its binding: `group_resolve_lines` (GET_LNFL regrouping and the
LINES walk of `lines.group` -> `lines.resolve`), `alayer_integrate`
(ALAYER over one interval), `rfpath_integrate` (the whole RFPATH loop) and
`amerge_walk` (AMERGE's merge walk).  It is compiled at first use with
`g++` and the JAX package's flags (CXX_FLAGS) into `build/` at the
repository root, under a name keyed by a hash of the source and the
flags, and loaded with ctypes.  There is no silent fallback: a failed
build or load raises.  `lines.load_catalog` and `atmos.layering` take the
helper unless MONORTM_TPU_TORCH_NATIVE=0 is set (`enabled`); then they
take their Python walks, which stay the helper's oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "monortm_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
SWITCH = "MONORTM_TPU_TORCH_NATIVE"

_LIB = None
_LOCK = threading.Lock()


class _RawLinesC(ctypes.Structure):
    _fields_ = [
        ("vnu", ctypes.c_void_p), ("sp", ctypes.c_void_p),
        ("alfa", ctypes.c_void_p), ("epp", ctypes.c_void_p),
        ("mol", ctypes.c_void_p), ("hwhm", ctypes.c_void_p),
        ("tmpalf", ctypes.c_void_p), ("pshift", ctypes.c_void_p),
        ("iflg", ctypes.c_void_p), ("speed_dep", ctypes.c_void_p),
        ("n", ctypes.c_int64),
    ]


class _ResolvedC(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mol", "nu0", "s0", "e", "alpf", "alps", "tdep", "pshift", "iso",
        "sdep", "xg", "a1", "b1", "a2", "b2", "self_mix")]


_D, _P, _I, _L = (ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int64)
_SIGNATURES = {
    "group_resolve_lines": (_L, [ctypes.POINTER(_RawLinesC),
                                 ctypes.POINTER(_ResolvedC)]),
    "alayer_integrate": (_D, [_D] * 6 + [_P, _P, _L, _P, _P] + [_D] * 6
                         + [_I] + [_P] * 5),
    "rfpath_integrate": (None, [_P] * 5 + [_L, _L] + [_D] * 6
                         + [_I, _D, _I, _L] + [_P] * 6),
    "amerge_walk": (_L, [_P] * 4 + [_L, _P, _L, _D, _D] + [_P] * 8),
}


def enabled() -> bool:
    """Whether the helper is on: unless MONORTM_TPU_TORCH_NATIVE=0."""
    return os.environ.get(SWITCH, "1") != "0"


def lib_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{SOURCE.stem}-{key[:16]}.so"


def build() -> Path:
    """Compile the source with g++ unless its hash is built already, and
    return the shared library's path; raises when g++ is missing or
    fails."""
    path = lib_path()
    if path.exists():
        return path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(
            f"{CXX} not found on PATH: the native host helper "
            f"({SOURCE.name}) is built with it; set {SWITCH}=0 to take the "
            f"Python walks instead")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} {SOURCE.name} failed "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)    # atomic: all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _lib():
    """The loaded library with its entry points typed (built and loaded
    once per process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the native host helper built "
                                   f"by {CXX} ({path}) failed: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
    return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def group_resolve_lines(raw):
    """GET_LNFL regrouping + LINES walk of `raw` (a RawLines without IBRD
    data); returns a `lines.ResolvedLines`."""
    from monortm_tpu_torch.lines import ResolvedLines

    lib = _lib()
    n = len(raw)
    c = lambda a, dt: np.ascontiguousarray(a, dtype=dt)
    vnu = c(raw.vnu, np.float64)
    sp = c(raw.sp, np.float32)
    alfa = c(raw.alfa, np.float32)
    epp = c(raw.epp, np.float32)
    mol = c(raw.mol, np.int32)
    hwhm = c(raw.hwhm, np.float32)
    tmpalf = c(raw.tmpalf, np.float32)
    pshift = c(raw.pshift, np.float32)
    iflg = c(raw.iflg, np.int32)
    sdep = c(raw.speed_dep, np.float32)

    rc = _RawLinesC(_ptr(vnu).value, _ptr(sp).value, _ptr(alfa).value,
                    _ptr(epp).value, _ptr(mol).value, _ptr(hwhm).value,
                    _ptr(tmpalf).value, _ptr(pshift).value,
                    _ptr(iflg).value, _ptr(sdep).value, n)

    o = {k: np.zeros(n, np.float64) for k in
         ("nu0", "s0", "e", "alpf", "alps", "tdep", "pshift", "sdep", "xg")}
    o["mol"] = np.zeros(n, np.int64)
    o["iso"] = np.zeros(n, np.int64)
    for k in ("a1", "b1", "a2", "b2"):
        o[k] = np.zeros((n, 4), np.float64)
    o["self_mix"] = np.zeros(n, np.uint8)

    res = _ResolvedC(*[_ptr(o[f]).value for f, _ in _ResolvedC._fields_])
    cnt = lib.group_resolve_lines(ctypes.byref(rc), ctypes.byref(res))
    if cnt < 0:
        raise ValueError("unrecognised line-coupling flag in TAPE3")
    cnt = int(cnt)
    return ResolvedLines(
        mol=o["mol"][:cnt], nu0=o["nu0"][:cnt], s0=o["s0"][:cnt],
        e=o["e"][:cnt], alpf=o["alpf"][:cnt], alps=o["alps"][:cnt],
        tdep=o["tdep"][:cnt], pshift=o["pshift"][:cnt],
        iso=o["iso"][:cnt], sdep=o["sdep"][:cnt], xg=o["xg"][:cnt],
        a1=o["a1"][:cnt], b1=o["b1"][:cnt], a2=o["a2"][:cnt],
        b2=o["b2"][:cnt], self_mix=o["self_mix"][:cnt].astype(bool),
        brd_flg=np.zeros((cnt, 7), np.int64),
        brd_hw=np.zeros((cnt, 7)), brd_tmp=np.zeros((cnt, 7)),
        brd_shft=np.zeros((cnt, 7)),
    )


def alayer_integrate(z1, z2, pa, pb, ta, tb, dena, denb, nmol, sinai,
                     cosai, cpath, sh, gamma, re, deltas, gcair, iamt,
                     sums, j):
    """ALAYER for one interval; updates sums in place and returns (sinai,
    cosai, s, bend)."""
    lib = _lib()
    sin_io = ctypes.c_double(sinai)
    cos_io = ctypes.c_double(cosai)
    bend = ctypes.c_double(0.0)
    pps = ctypes.c_double(sums["ppsum"][j])
    tps = ctypes.c_double(sums["tpsum"][j])
    rps = ctypes.c_double(sums["rhopsm"][j])
    amtp = np.ascontiguousarray(sums["amtp"][:nmol, j], np.float64)
    dena = np.ascontiguousarray(dena[:nmol], np.float64)
    denb = np.ascontiguousarray(denb[:nmol], np.float64)
    s = lib.alayer_integrate(
        z1, z2, pa, pb, ta, tb, _ptr(dena), _ptr(denb), nmol,
        ctypes.byref(sin_io), ctypes.byref(cos_io), cpath, sh, gamma, re,
        deltas, gcair, iamt,
        ctypes.byref(pps), ctypes.byref(tps), ctypes.byref(rps),
        _ptr(amtp), ctypes.byref(bend))
    sums["ppsum"][j] = pps.value
    sums["tpsum"][j] = tps.value
    sums["rhopsm"][j] = rps.value
    sums["amtp"][:nmol, j] = amtp
    return sin_io.value, cos_io.value, s, bend.value


def rfpath_integrate(zpth, pp, tp, rfndx, denp, nmol, sinai, cosai, cpath,
                     re, deltas, gcair, iamt, theta, len1, iphmid):
    """The full-path RFPATH loop; returns (sums dict, scalars dict).

    denp: [MXMOL, ipmax]; only the first nmol rows are integrated.
    """
    lib = _lib()
    zpth = np.ascontiguousarray(zpth, np.float64)
    pp = np.ascontiguousarray(pp, np.float64)
    tp = np.ascontiguousarray(tp, np.float64)
    rfndx = np.ascontiguousarray(rfndx, np.float64)
    ipmax = len(zpth)
    denp_t = np.ascontiguousarray(denp[:nmol, :ipmax].T, np.float64)
    ppsum = np.zeros(ipmax - 1)
    tpsum = np.zeros(ipmax - 1)
    rhopsm = np.zeros(ipmax - 1)
    sp = np.zeros(ipmax - 1)
    amtp_t = np.zeros((ipmax - 1, nmol))
    out = np.zeros(6)
    lib.rfpath_integrate(
        _ptr(zpth), _ptr(pp), _ptr(tp), _ptr(rfndx), _ptr(denp_t),
        nmol, ipmax, sinai, cosai, cpath, re, deltas, gcair, iamt,
        theta, len1, iphmid,
        _ptr(ppsum), _ptr(tpsum), _ptr(rhopsm), _ptr(amtp_t), _ptr(sp),
        _ptr(out))
    sums = {"ppsum": ppsum, "tpsum": tpsum, "rhopsm": rhopsm, "sp": sp}
    sums["amtp_nmol"] = amtp_t.T
    return sums, {"s": out[0], "beta": out[1], "bendng": out[2],
                  "phi_j": out[3], "sinai": out[4], "cosai": out[5]}


def amerge_walk(zmdl, pm, tm, rfndx, zout, hmin, hmid, tol):
    """AMERGE's merge walk (lblatm.f90:5190-5285).

    Returns (zpth, pp, tp, rf, src_im, src_jm, src_a, iphmid, hmid):
    src_im[i] is the model level index of path point i, or -1 for an
    interpolated point, whose (jm, a) are in src_jm / src_a; the caller
    gathers density columns from these as the Python walk does.  Raises
    IndexError when the model grid runs out below the remaining zout
    points and ValueError when the profile does not reach hmin, as the
    Python walk does.
    """
    lib = _lib()
    zmdl = np.ascontiguousarray(zmdl, np.float64)
    pm = np.ascontiguousarray(pm, np.float64)
    tm = np.ascontiguousarray(tm, np.float64)
    rfndx = np.ascontiguousarray(rfndx, np.float64)
    zout = np.ascontiguousarray(zout, np.float64)
    immax = len(zmdl)
    cap = immax + len(zout) + 2
    zpth = np.empty(cap)
    pp = np.empty(cap)
    tp = np.empty(cap)
    rf = np.empty(cap)
    src_im = np.empty(cap, np.int64)
    src_jm = np.empty(cap, np.int64)
    src_a = np.empty(cap)
    scal = np.array([0.0, hmid])
    n = lib.amerge_walk(
        _ptr(zmdl), _ptr(pm), _ptr(tm), _ptr(rfndx), immax,
        _ptr(zout), len(zout), hmin, tol,
        _ptr(zpth), _ptr(pp), _ptr(tp), _ptr(rf),
        _ptr(src_im), _ptr(src_jm), _ptr(src_a), _ptr(scal))
    if n == -2:
        raise IndexError("AMERGE: model grid exhausted below path top")
    if n < 0:
        raise ValueError("AMERGE: profile does not extend up to HMIN")
    n = int(n)
    return (zpth[:n], pp[:n], tp[:n], rf[:n], src_im[:n], src_jm[:n],
            src_a[:n], int(scal[0]), scal[1])
