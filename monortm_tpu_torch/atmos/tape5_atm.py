"""LBLATM control records (3.1-3.6) parser + ATMPTH driver.

Turns the records following MONORTM.IN record 1.4 into layered Profile
objects via the path engine.  Replicates ATMPTH's record handling
(lblatm.f90:575-1260) including pressure-grid boundary conversion and the
user-profile (MODEL=0) reader NSMDL/RDUNIT (lblatm.f90:3044-3401).

A copy of `monortm_tpu.atmos.tape5_atm`, whose layering worker pools
(`_Pool`) start their processes without torch: this module and what it
imports are numpy, the native helper and the data tables, and the
workers are forked from a `forkserver` that has preloaded this module
alone, so that no worker inherits the parent's CUDA context or threads,
nor imports the parent's `__main__` (see `_Popen`).  The server outlives
a run: the first pool of a process pays its start, later pools fork.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import (context, forkserver, popen_forkserver,
                             reduction, spawn, util)

import numpy as np

from monortm_tpu_torch.atmos import layering as lay
from monortm_tpu_torch.io.profin import Profile
from monortm_tpu_torch.host_types import HostState, ProfileMeta


def _f(s: str) -> float:
    s = s.strip()
    if not s:
        return 0.0
    try:
        return float(s)
    except ValueError:      # Fortran d-exponents
        return float(s.replace("d", "e").replace("D", "E"))


def _i(s: str) -> int:
    s = s.strip()
    return int(s) if s else 0


class AtmRecordReader:
    def __init__(self, lines: list[str]):
        self.lines = lines
        self.pos = 0

    def next(self) -> str:
        line = self.lines[self.pos]
        self.pos += 1
        return line


def _fw_floats(lines: list[str], width: int, nfields: int) -> np.ndarray:
    """Fixed-width float fields for a batch of lines -> [n, nfields].

    Vectorized over lines (np.char); blank fields are 0.0 and Fortran
    d/D exponents are honoured — identical semantics to `_f`.
    """
    total = width * nfields
    # S-dtype conversion truncates long lines and null-pads short ones;
    # null-padded tail fields extract as b"" exactly like space-padded
    # ones after strip, so no per-line ljust loop is needed
    a = np.asarray(lines, dtype=f"S{total}")
    f = a.view(f"S{width}").reshape(len(lines), nfields)
    f = np.char.strip(f)
    f = np.where(f == b"", b"0", f)
    try:
        return f.astype(np.float64)
    except ValueError:
        f = np.char.replace(np.char.replace(f, b"D", b"E"), b"d", b"e")
        return f.astype(np.float64)


def parse_user_profile(rd: AtmRecordReader, nmol: int, immax_b: int,
                       ref_lat: float, re: float) -> lay.ModelProfile:
    """NSMDL + RDUNIT loop (lblatm.f90:3044-3401).

    Levels with uniform unit codes (the overwhelmingly common case — one
    radiosonde format per file) take a fully vectorized path over the
    level axis; mixed-unit profiles fall back to the per-level scalar
    walk, which remains the semantic oracle (tests/test_atmos.py)."""
    immax = abs(immax_b)
    nrows = -(-nmol // 8)
    # records alternate 3.5 / (nrows x 3.6) with fixed stride: slice
    # instead of looping rd.next()
    step = 1 + nrows
    blk = rd.lines[rd.pos:rd.pos + immax * step]
    rd.pos += immax * step
    l35 = [ln.ljust(80) for ln in blk[0::step]]
    l36 = [blk[i * step + 1:(i + 1) * step] for i in range(immax)]

    # group levels by unit-code signature (jcharp/jchart/jlong/jchar):
    # each group takes the fully vectorized path.  Real files have 1-3
    # groups (e.g. radiosonde levels + model-default extension levels).
    keys = np.asarray([ln[35:37] + ln[38:39] + ln[40:40 + nmol]
                       for ln in l35])
    uniq, inv = np.unique(keys, return_inverse=True)
    groups = {str(u): np.nonzero(inv == i)[0].tolist()
              for i, u in enumerate(uniq)}

    zmdl = np.zeros(immax)
    pm = np.zeros(immax)
    tm = np.zeros(immax)
    denm = np.zeros((lay.MXMOL, immax))

    zpt_all = _fw_floats(l35, 10, 3)
    zmdl[:] = zpt_all[:, 0]

    for key, idx in groups.items():
        r0 = l35[idx[0]]
        junitp = lay.jou(r0[35:36])
        junitt = lay.jou(r0[36:37])
        jlong = r0[38:39]
        junit = {k + 1: lay.jou(r0[40 + k]) for k in range(nmol)}

        idx = np.asarray(idx)
        z = zmdl[idx]
        p = zpt_all[idx, 1]
        t = zpt_all[idx, 2]
        fmt_w = 15 if jlong == "L" else 10
        flat36 = [ln for i in idx for ln in l36[i]]
        wmol = _fw_floats(flat36, fmt_w, 8).reshape(len(idx),
                                                    nrows * 8)[:, :nmol]
        wmol = np.ascontiguousarray(wmol)

        p = lay.check_pt(p, junitp, 1)
        t = np.asarray(lay.check_pt(t, junitt, 2), np.float64)

        # model-atmosphere defaults (DEFALT / DEFALT_P), vectorized
        if immax_b < 0:
            t_d, wmol_d = lay.default_interp_p_vec(p, junitt, junit, nmol)
        else:
            p_d, t_d, wmol_d = lay.default_interp_z_vec(z, junitp, junitt,
                                                        junit, nmol)
            if junitp <= 6 and p_d is not None:
                p = p_d
        if junitt <= 6 and t_d is not None:
            t = t_d
        for k, v in wmol_d.items():
            wmol[:, k - 1] = v
            junit[k] = 10

        denm[:, idx] = lay.convert_units_vec(p, t, junit, wmol, nmol)
        pm[idx] = np.asarray(p, np.float64)
        tm[idx] = t

    denw = denm[0].copy()
    if immax_b < 0:
        zmdl = lay.cmpalt(pm, tm, denw, zmdl[0], ref_lat, re)
    if np.any(np.diff(zmdl) <= 0):
        raise ValueError("input altitudes not in ascending order")
    return lay.ModelProfile(zmdl=zmdl, pm=pm, tm=tm, denm=denm, denw=denw,
                            hmod="")


def _parse_user_profile_scalar(l35, l36, nmol, immax_b, ref_lat,
                               re) -> lay.ModelProfile:
    """Per-level RDUNIT walk (mixed-unit profiles; also the oracle the
    vectorized path is tested against)."""
    immax = abs(immax_b)
    zmdl = np.zeros(immax)
    pm = np.zeros(immax)
    tm = np.zeros(immax)
    denm = np.zeros((lay.MXMOL, immax))
    for im in range(immax):
        # record 3.5: (3E10.3,5X,2A1,1X,A1,1X,39A1)
        r = l35[im]
        zm = _f(r[0:10])
        p = _f(r[10:20])
        t = _f(r[20:30])
        jcharp = r[35:36]
        jchart = r[36:37]
        jlong = r[38:39]
        junitp = lay.jou(jcharp)
        junitt = lay.jou(jchart)
        # only molecules 1..nmol are consumed downstream
        junit = {k + 1: lay.jou(r[40 + k]) for k in range(nmol)}

        # record 3.6: wmol
        wmol = {}
        fmt_w, per_row = (15, 8) if jlong == "L" else (10, 8)
        got = 0
        for rrow in l36[im]:
            rrow = rrow.ljust(per_row * fmt_w)
            for kk in range(per_row):
                if got >= nmol:
                    break
                wmol[got + 1] = _f(rrow[kk * fmt_w:(kk + 1) * fmt_w])
                got += 1

        p = lay.check_pt(p, junitp, 1)
        t = lay.check_pt(t, junitt, 2)

        # model-atmosphere defaults (DEFALT / DEFALT_P)
        if immax_b < 0:
            t_d, wmol_d = lay._default_interp_p(p, junitt, junit, nmol)
            if junitt <= 6 and t_d is not None:
                t = t_d
        else:
            p_d, t_d, wmol_d = lay._default_interp_z(zm, junitp, junitt,
                                                     junit, nmol)
            if junitp <= 6 and p_d is not None:
                p = p_d
            if junitt <= 6 and t_d is not None:
                t = t_d
        for k, v in wmol_d.items():
            wmol[k] = v
            junit[k] = 10

        denm[:, im] = lay.convert_units(p, t, junit, wmol, nmol)
        zmdl[im] = zm
        pm[im] = p
        tm[im] = t

    denw = denm[0].copy()
    if immax_b < 0:
        zmdl = lay.cmpalt(pm, tm, denw, zmdl[0], ref_lat, re)
    if np.any(np.diff(zmdl) <= 0):
        raise ValueError("input altitudes not in ascending order")
    return lay.ModelProfile(zmdl=zmdl, pm=pm, tm=tm, denm=denm, denw=denw,
                            hmod="")


def _pbnd_to_zbnd(pbnd, prof: lay.ModelProfile, ref_lat, re):
    """Pressure boundaries -> altitudes: blended ln(p) interpolation +
    hydrostatics (ATMPTH, lblatm.f90:898-966)."""
    out_z = np.zeros(len(pbnd))
    out_t = np.zeros(len(pbnd))
    istart = 1
    for ip, pb in enumerate(pbnd):
        lip = prof.immax - 1
        for k in range(istart, prof.immax):
            if pb > prof.pm[k]:
                lip = k
                break
        if pb == prof.pm[lip - 1]:
            out_z[ip] = prof.zmdl[lip - 1]
            out_t[ip] = prof.tm[lip - 1]
        elif pb == prof.pm[lip]:
            out_z[ip] = prof.zmdl[lip]
            out_t[ip] = prof.tm[lip]
        else:
            hip = (prof.zmdl[lip] - prof.zmdl[lip - 1]) / \
                math.log(prof.pm[lip] / prof.pm[lip - 1])
            zint = prof.zmdl[lip - 1] + hip * math.log(pb / prof.pm[lip - 1])
            tip = (prof.tm[lip] - prof.tm[lip - 1]) / \
                math.log(prof.pm[lip] / prof.pm[lip - 1])
            ttmp2 = prof.tm[lip - 1] + tip * math.log(pb / prof.pm[lip - 1])
            wvip = (prof.denw[lip] - prof.denw[lip - 1]) / \
                math.log(prof.pm[lip] / prof.pm[lip - 1])
            wvtmp2 = prof.denw[lip - 1] + wvip * math.log(
                pb / prof.pm[lip - 1])
            ztmp = lay.cmpalt(
                np.asarray([prof.pm[lip - 1], pb]),
                np.asarray([prof.tm[lip - 1], ttmp2]),
                np.asarray([prof.denw[lip - 1], wvtmp2]),
                prof.zmdl[lip - 1], ref_lat, re)
            ratp = math.log(pb / prof.pm[lip - 1]) / \
                math.log(prof.pm[lip] / prof.pm[lip - 1])
            a = ratp**3
            out_z[ip] = a * zint + (1 - a) * ztmp[1]
            out_t[ip] = ttmp2
        istart = lip
    return out_z, out_t


def atmpth(rest: list[str], v1: float, v2: float, ixsect: int = 0,
           fscdxs_dir=None) -> Profile:
    """One LBLATM invocation over the record block following record 1.4.

    Returns a Profile whose state mirrors the /PATHD/ COMMON the driver
    consumes (monortm.f90:229-230).
    """
    rd = AtmRecordReader(rest)

    # record 3.1: (7I5,I2,1X,I2,4F10.3,A10)
    r = rd.next().ljust(90)
    model = _i(r[0:5])
    itype = _i(r[5:10])
    ibmax_b = _i(r[10:15])
    n_zero = _i(r[15:20])
    noprnt = _i(r[20:25])
    nmol = _i(r[25:30])
    ipunch = _i(r[30:35])
    ifxtyp = _i(r[35:37])          # I2 at cols 36-37 (lblatm.f90:581)
    re = _f(r[40:50])
    hspace = _f(r[50:60])
    xvbar = _f(r[60:70])
    dumrd = _f(r[70:80])
    sref = r[80:90].strip()
    ref_lat = float(sref) if sref else 45.0
    if dumrd != 0.0:
        raise ValueError("co2mx option retired (lblatm.f90:594-600)")

    if nmol == 0:
        nmol = lay.KMXNOM
    if itype < 1 or itype > 3 or model < 0 or model > 6:
        raise ValueError("card 3.1 out of range")
    ibmax = abs(ibmax_b)
    if re == 0.0:
        re = 6371.23
        if model == 1:
            re = 6378.39
        if model in (4, 5):
            re = 6356.91
    if hspace == 0.0:
        hspace = 100.0
    if xvbar <= 0.0:
        xvbar = (v1 + v2) / 2.0
        if v2 < v1:
            xvbar = v1

    if itype == 1:
        # horizontal path (lblatm.f90:664-803)
        r = rd.next().ljust(40)
        h1 = _f(r[0:10])
        range_ = _f(r[30:40])
        if model == 0:
            prof = parse_user_profile(rd, nmol, _i(rd.next()[:5]) or 1,
                                      ref_lat, re)
        else:
            prof = lay.load_model_atmosphere(model, nmol, hspace)
        # interpolate densities to h1
        im = prof.immax - 1
        for k in range(1, prof.immax):
            if h1 < prof.zmdl[k]:
                im = k
                break
        a = (h1 - prof.zmdl[im - 1]) / (prof.zmdl[im] - prof.zmdl[im - 1])
        ph = lay.expint(prof.pm[im - 1], prof.pm[im], a)
        th = prof.tm[im - 1] + (prof.tm[im] - prof.tm[im - 1]) * a
        rhobar = lay.cst.ALOSMT * ph * lay.TZERO / (lay.PZERO * th)
        den = np.array([lay.expint(prof.denm[k, im - 1], prof.denm[k, im], a)
                        for k in range(lay.MXMOL)])
        amount = den * range_ * 1.0e5
        amtair = rhobar * range_ * 1.0e5
        wn2l = amtair - amount[:nmol].sum()
        state = HostState(
            p=np.asarray([ph]), t=np.asarray([th]),
            tz=np.asarray([th, th]), wkl=amount[None, :],
            wbrodl=np.asarray([wn2l]), clw=np.zeros(1))
        meta = ProfileMeta(nmol=nmol, angle=0.0, h1=h1, h2=h1,
                           altz=np.asarray([-range_, h1]),
                           pz=np.asarray([ph, ph]))
        return Profile(state=state, meta=meta, hmod=prof.hmod)

    # slant path: record 3.2 (5F10.4,I5,5X,F10.4)
    r = rd.next().ljust(70)
    h1 = _f(r[0:10])
    h2 = _f(r[10:20])
    angle = _f(r[20:30])
    range_ = _f(r[30:40])
    beta = _f(r[40:50])
    len_ = _i(r[50:55])
    hobs = _f(r[60:70])

    avtrat, tdiff1, tdiff2, altd1, altd2 = 1.5, 5.0, 8.0, 0.0, 100.0
    zbnd = pbnd = None
    if ibmax == 0:
        r = rd.next().ljust(50)
        avtrat = _f(r[0:10]) or 1.5
        tdiff1 = _f(r[10:20]) or 5.0
        tdiff2 = _f(r[20:30]) or 8.0
        altd1 = _f(r[30:40])
        altd2 = _f(r[40:50])
        if altd2 <= 0 or altd2 <= altd1:
            altd1, altd2 = 0.0, 100.0
        if avtrat <= 1.0 or tdiff1 <= 0.0 or tdiff2 <= 0.0:
            raise ValueError("AVTRAT/TDIFF out of range")
    else:
        vals = []
        while len(vals) < ibmax:
            r = rd.next().ljust(80)
            for k in range(8):
                if len(vals) >= ibmax:
                    break
                vals.append(_f(r[k * 10:(k + 1) * 10]))
        if ibmax_b < 0:
            pbnd = np.asarray(vals)
            if np.any(np.diff(pbnd) >= 0):
                raise ValueError("PBND not descending")
        else:
            zbnd = np.asarray(vals)
            if np.any(np.diff(zbnd) <= 0):
                raise ValueError("ZBND not ascending")

    # model atmosphere
    if model == 0:
        r = rd.next().ljust(30)
        immax_b = _i(r[0:5])
        hmod = r[5:29].strip()
        prof = parse_user_profile(rd, nmol, immax_b, ref_lat, re)
        prof.hmod = hmod
    else:
        prof = lay.load_model_atmosphere(model, nmol, hspace)

    # pressure-grid boundaries -> altitude grid (lblatm.f90:898-1087)
    tbnd = None
    if ibmax_b < 0:
        zbnd, tbnd = _pbnd_to_zbnd(pbnd, prof, ref_lat, re)
        h1, _ = _pbnd_to_zbnd(np.asarray([h1]), prof, ref_lat, re)[0], None
        h1 = float(np.atleast_1d(h1)[0])
        h2 = float(_pbnd_to_zbnd(np.asarray([h2]), prof, ref_lat, re)[0][0])
        if h1 < 0 or h2 < 0:
            raise ValueError("computed altitude of H1/H2 negative")
    if zbnd is not None and len(zbnd) >= 1 and zbnd[0] < prof.zmdl[0]:
        if abs(zbnd[0] - prof.zmdl[0]) <= 0.0001:
            zbnd = zbnd.copy()
            zbnd[0] = prof.zmdl[0]
        else:
            raise ValueError("boundaries outside of atmosphere")

    engine = lay.PathEngine(prof, xvbar, re, nmol)
    geo = engine.fscgeo(h1, h2, angle, range_, beta, itype, len_, hobs)

    if ibmax == 0:
        hmax = max(geo["h1"], geo["h2"])
        zbnd, pbnd_a, tbnd_a = engine.autlay(geo["hmin"], hmax, xvbar,
                                             avtrat, tdiff1, tdiff2,
                                             altd1, altd2)

    trace = engine.rfpath(geo["h1"], geo["h2"], geo["angle"], geo["phi"],
                          geo["len"], geo["hmin"], 1, zbnd)
    res = engine.fpack(trace, geo["h1"], geo["h2"], geo["len"], n_zero,
                       iemit=1)

    # ITYL DV-ratio codes + IFIXTYPE file round-trip (lblatm.f90:1292-1339)
    ityl = None
    if ifxtyp in (1, 2):
        wtotl = res.amount[:nmol].sum(axis=0) + res.wn2l
        ityl = lay.fixtyp_layers(res.pbar, res.tbar, wtotl,
                                 res.amount[0], xvbar, iemit=1)
        if ifxtyp == 2:
            with open("IFIXTYPE", "w") as fh:
                for v in ityl:
                    fh.write(f"{int(v):3d}\n")
    elif ifxtyp == -2:
        vals = [int(x) for x in open("IFIXTYPE").read().split()]
        ityl = np.asarray(vals[:len(res.pbar)], np.int64)

    xamnt = xsname = None
    if ixsect >= 1 and fscdxs_dir is not None:
        xamnt, xsname = xamnts(rd, prof, engine, geo, zbnd, nmol,
                               v1 - 25.0, v2 + 25.0, fscdxs_dir)
        xamnt = xamnt[:, :len(res.pbar)]

    nlay = len(res.pbar)
    state = HostState(
        p=res.pbar, t=res.tbar, tz=res.tz,
        wkl=res.amount[:39].T.copy(), wbrodl=res.wn2l,
        clw=np.zeros(nlay))
    meta = ProfileMeta(nmol=nmol, angle=geo["angle"], h1=geo["h1"],
                       h2=geo["h2"], altz=res.altz, pz=res.pz)
    path = {"range": float(trace["range"]), "beta": float(trace["beta"]),
            "bendng": float(trace["bendng"]), "phi": float(trace["phi"]),
            "hmin": float(geo["hmin"]), "len": int(geo["len"]),
            "airtot": float(trace["sums"]["rhopsm"].sum() * 1.0e5)}
    return Profile(state=state, meta=meta, hmod=prof.hmod,
                   xamnt=xamnt, xsname=xsname, ityl=ityl, path=path,
                   ipunch=ipunch)


def _atmpth_block(args):
    rest, v1, v2, ixsect, fdir = args
    return atmpth(rest, v1, v2, ixsect=ixsect, fscdxs_dir=fdir)


def _worker_report():
    """(this process's id, whether it has imported torch)."""
    return os.getpid(), "torch" in sys.modules


def _pooled_block(args):
    """A pool task: one block's Profile and its worker's report."""
    return _atmpth_block(args), _worker_report()


def _worker_start(reports, environ):
    """A pool worker's initializer: take the environment the parent had
    when it made the pool (a forked worker has the server's, of the
    first pool), then report on the worker's start."""
    os.environ.clear()
    os.environ.update(environ)
    reports.put(_worker_report())


class _Popen(popen_forkserver.Popen):
    """The forkserver's Popen, less the parent's `__main__`: a child told
    of it runs the parent's main module again (as `__mp_main__`), and
    with it that module's imports, torch among them (the CLI's console
    script, a benchmark driver).  The pool's tasks name functions of this
    module only, which the server has preloaded."""

    def _launch(self, process_obj):
        # popen_forkserver.Popen._launch (Python 3.12), with the keys that
        # make the child import `__main__` taken out of its preparation data
        prep = spawn.get_preparation_data(process_obj._name)
        prep.pop("init_main_from_name", None)
        prep.pop("init_main_from_path", None)
        buf = io.BytesIO()
        context.set_spawning_popen(self)
        try:
            reduction.dump(prep, buf)
            reduction.dump(process_obj, buf)
        finally:
            context.set_spawning_popen(None)
        self.sentinel, w = forkserver.connect_to_new_process(self._fds)
        # a duplicate of the data pipe's write end: the child's sentinel
        # of its parent
        parent_w = os.dup(w)
        self.finalizer = util.Finalize(self, util.close_fds,
                                       (parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = forkserver.read_signed(self.sentinel)


class _Process(context.ForkServerProcess):
    @staticmethod
    def _Popen(process_obj):
        return _Popen(process_obj)


class _Context(context.ForkServerContext):
    Process = _Process


class _Pool:
    """A process pool for the layering whose workers start without torch
    (the module's docstring), and which counts the workers that ran
    without it.  Never `fork`: the parent may hold a CUDA context and
    run threads."""

    def __init__(self, workers: int):
        ctx = _Context()
        ctx.set_forkserver_preload([__name__])
        self._starts = ctx.SimpleQueue()
        self._reports = []
        self._ex = ProcessPoolExecutor(
            workers, mp_context=ctx, initializer=_worker_start,
            initargs=(self._starts, dict(os.environ)))

    def map(self, args, chunksize: int):
        """The Profiles of the blocks `args`, in order."""
        for prof, rep in self._ex.map(_pooled_block, args,
                                      chunksize=chunksize):
            self._reports.append(rep)
            yield prof

    def shutdown(self, wait: bool = True, cancel_futures: bool = False):
        self._ex.shutdown(wait=wait, cancel_futures=cancel_futures)

    def without_torch(self) -> int:
        """The worker processes that had no torch at their start nor in
        any of their tasks; read after shutdown(wait=True)."""
        while not self._starts.empty():
            self._reports.append(self._starts.get())
        self._starts.close()
        with_torch = {pid for pid, loaded in self._reports if loaded}
        return len({pid for pid, _ in self._reports} - with_torch)


def layering_workers(n_blocks: int, workers: int | None = None) -> int:
    """The processes that layer n_blocks profiles: `workers`, by default
    a pool from 64 blocks on 2 or more cores, of at most 16 (the pool's
    start hides behind the pipeline's own prep of the first profiles;
    measured a win at 2 cores / 500 profiles), or 1, the caller's own,
    where a pool would get fewer than two profiles a worker."""
    if workers is None:
        ncpu = len(os.sched_getaffinity(0)) \
            if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
        workers = 1 if (n_blocks < 64 or ncpu < 2) else min(ncpu, 16)
    return 1 if workers <= 1 or n_blocks < 2 * workers else workers


def profiles_from_tape5_iter(filein, cfg, workers: int | None = None,
                             pool_stage=None, report=None):
    """The '$'-stacked IATM=1 profiles of a MONORTM.IN file, in input
    order as they are layered (by the caller, or for large stacked runs
    by a pool of `layering_workers` processes), so that the pipeline
    starts device work on early profiles while later ones are layered.

    pool_stage: a callable returning a context manager that is held from
    the pool's creation until its first profile is back (pipeline.run's
    `layering.pool` stage); report: a callable given, after the last
    profile, the number of the pool's worker processes that ran without
    torch (`_Pool.without_torch`); both unused when no pool starts."""
    from pathlib import Path
    from monortm_tpu_torch.io.tape5 import Tape5Reader
    rd = Tape5Reader(filein)
    blocks = []
    while not rd.at_end():
        blocks.append(rd.read_block())
    fdir = Path(filein).parent
    args = [(blk.rest, blk.v1, blk.v2, blk.ixsect, fdir) for blk in blocks]
    workers = layering_workers(len(args), workers)
    if workers == 1:
        for a in args:
            yield _atmpth_block(a)
        return
    chunk = max(1, min(16, len(args) // (4 * workers)))
    pool = None
    try:
        with (pool_stage or contextlib.nullcontext)():
            pool = _Pool(workers)
            done = pool.map(args, chunk)
            first = next(done)
        yield first
        yield from done
        pool.shutdown(wait=True)
        if report is not None:
            report(pool.without_torch())
    finally:
        # abandoned mid-stream (consumer error): cancel the eagerly
        # submitted layering tasks instead of blocking the interpreter
        # exit on the full 10k-profile backlog
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def xamnts(rd: AtmRecordReader, prof: lay.ModelProfile,
           engine: "lay.PathEngine", geo: dict, zbnd, nmol: int,
           xv1: float, xv2: float, fscdxs_dir):
    """Cross-section layer amounts for IATM=1 (XAMNTS, lblatm.f90:6160-6660).

    Reads records 3.7/3.7.1 (+3.8 for user profiles), builds xsec density
    profiles on the ZMDL grid, re-runs the ray trace with those densities
    and condenses the amounts onto the output layers (n_zero forced to 1 —
    no 0.1% zeroing for cross-sections).
    """
    from monortm_tpu_torch.io.fscdxs import read_fscdxs
    from monortm_tpu_torch.data import loader

    r = rd.next().ljust(15)
    ixmols = _i(r[0:5])
    iprfl = _i(r[5:10])
    # record 3.7.1: names, 8A10 per row
    names = []
    while len(names) < ixmols:
        row = rd.next()
        names += [row[i * 10:(i + 1) * 10].strip() for i in range(8)
                  if row[i * 10:(i + 1) * 10].strip()]
    names = names[:ixmols]
    idx = read_fscdxs(fscdxs_dir / "FSCDXS", names, xv1, xv2)

    t = loader._load("mlatm")
    if iprfl > 0:
        # standard AMOLX profiles (ppmv) on the altx grid
        zx = t["altx"]
        denx = np.stack([t["amolx"][i - 1] for i in idx.indices])
    else:
        # records 3.8: LAYX, IZORP, XTITLE then per-level z/p + values
        r = rd.next().ljust(60)
        layx = _i(r[0:5])
        izorp = _i(r[5:10])
        zx = np.zeros(layx)
        denx = np.zeros((ixmols, layx))
        jchars = []
        for l in range(layx):
            r = rd.next().ljust(60)
            zx[l] = _f(r[0:10])
            jchars.append(r[15:15 + ixmols])
            r = rd.next().ljust(80)
            for k in range(ixmols):
                denx[k, l] = _f(r[k * 10:(k + 1) * 10])
        if izorp == 1:
            zx, _ = _pbnd_to_zbnd(zx, prof, 45.0, engine.re)
        # JCHAR digits 1-6 default to the standard profile (XTRACT)
        for l in range(layx):
            for k in range(ixmols):
                c = jchars[l][k] if k < len(jchars[l]) else " "
                if c in "123456":
                    denx[k, l] = np.interp(zx[l], t["altx"],
                                           t["amolx"][idx.indices[k] - 1])

    # interpolate (exponential) onto ZMDL and convert ppmv -> density
    # (XINTRP, lblatm.f90:6994-7082)
    denm_x = np.zeros((lay.MXMOL, prof.immax))
    for li in range(prof.immax):
        z = prof.zmdl[li]
        lx = int(np.searchsorted(zx, z))
        lx = min(max(lx, 1), len(zx) - 1)
        a = (z - zx[lx - 1]) / (zx[lx] - zx[lx - 1])
        dryair = lay.cst.ALOSMT * (prof.pm[li] / lay.PZERO) / \
            (prof.tm[li] / lay.TZERO)
        for k in range(ixmols):
            v = lay.expint(denx[k, lx - 1], denx[k, lx], a)
            denm_x[k, li] = dryair * v * 1.0e-6

    # ray trace with the xsec densities on the same geometry
    prof_x = lay.ModelProfile(zmdl=prof.zmdl, pm=prof.pm, tm=prof.tm,
                              denm=denm_x, denw=prof.denw, hmod=prof.hmod)
    eng_x = lay.PathEngine(prof_x, 1.0, engine.re, ixmols)
    eng_x.zmax = engine.zmax
    trace = eng_x.rfpath(geo["h1"], geo["h2"], geo["angle"], geo["phi"],
                         geo["len"], geo["hmin"], 1, zbnd)
    # condense amounts onto output layers (lblatm.f90:6420-6450)
    zpth = trace["zpth"]
    zout = list(trace["zout"])
    amtp = trace["sums"]["amtp"]
    nlay = len(zout) - 1
    xamnt = np.zeros((ixmols, nlay))
    iout = 0
    for ip in range(len(zpth) - 1):
        xamnt[:, iout] += amtp[:ixmols, ip]
        if zpth[ip + 1] == zout[iout + 1]:
            iout += 1
    return xamnt, names
