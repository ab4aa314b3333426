"""End-to-end run pipeline: MONORTM.IN (+ MONORTM_PROF.IN, TAPE3) ->
MONORTM.OUT, mirroring the reference driver loop (monortm.f90:316-588).

A port of `monortm_tpu.pipeline.run` (the CUDA card unless the caller
asks for the CPU; on a mesh, a card per rank).  The host half is the
JAX package's numpy code, copied: parsing, layering, profile scaling,
the MONORTM.LOG echo and tables, chunking of equal-shape profiles and
the writer.  The device half, per chunk of profiles stacked into one
[B, nlay] state:

- the line engine: in float32 by default the engine split
  (`ODModel.engine_split`, on the model's device, margin 0): layers whose
  every line is in the Lorentz regime take the line sum's VOIGT=false
  instantiation, the rest VOIGT=true; in float64 (or on request) the
  dense engine, eager PyTorch over fixed-shape blocks;
- the OD model (line-sum kernels, continuum, cloud) and the layer sums of
  everything the writer prints, in a fixed sequential order, so that only
  [B, W] and [B, W, M] arrays cross to the host unless IOD=1 / NetCDF
  asks for per-layer ones;
- the RT layer recurrences (`rt_parts`); the O(W) boundary combine and
  Planck inversions then run in host numpy (`combine_boundary_np`).

A producer thread parses, layers and preps profiles (numpy only) while
the consumer thread, which makes every CUDA call, runs the device work;
the device work of chunk N+1 is enqueued before chunk N is pulled.
Nothing moves to the CPU behind the caller's back: a run on "cuda"
without a card raises, and a kernel that fails to build or launch fails
the run.

Cross-sections (IXSECT >= 1) are host numpy, as in the JAX package: the
`xsec-prep` stage computes every profile's cross-section OD up front
(`ops.xsec.xsec_od`, a thread pool over profiles), and the device adds it
to the total.

Meshes (`mesh=`, the JAX package's, pipeline.py:345-356): in a
torch.distributed run (`parallel.distributed`) every rank runs this
function on the same inputs.  "auto" puts the ranks on a (prof, wn) mesh
with the JAX choice of prof shards (`_auto_mesh`); one rank means one
device.  Each chunk is padded to whole prof shards by repeating its last
profile; each rank uploads its profile block, the model computes its
(prof, wn[, line]) block, the engine split is taken over the whole
chunk (`ODModel.engine_split`), and the pulled results are all-gathered
so that every rank holds them.  Only rank 0 writes files and prints the
profile lines.  MONORTM.OUT then has the bytes of the single-device run
wherever the chunks take the same engine split.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from monortm_tpu_torch import __version__
from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.atmos.tape5_atm import (layering_workers,
                                                profiles_from_tape5,
                                                profiles_from_tape5_iter)
from monortm_tpu_torch.convert import state_from_numpy
from monortm_tpu_torch.data.loader import HMOLC
from monortm_tpu_torch.io import emis as emis_io
from monortm_tpu_torch.io.cldod import cloud_od_on_grid
from monortm_tpu_torch.io.fscdxs import read_fscdxs, read_xs_file
from monortm_tpu_torch.io.output import (OutputWriter, ProfileOutput,
                                         write_netcdf)
from monortm_tpu_torch.io.profin import read_profiles
from monortm_tpu_torch.io.tape3 import read_tape3_header
from monortm_tpu_torch.io.tape5 import Tape5Reader, count_profiles
from monortm_tpu_torch.io.tape7 import write_tape7
from monortm_tpu_torch.lines import load_catalog
from monortm_tpu_torch.models.monortm import ForwardResult, MonoRTM
from monortm_tpu_torch.models.od import (DENSE_LINE_TILE, DENSE_WN_TILE,
                                         ODResult, dense_block_bytes)
from monortm_tpu_torch.models.rt import RTParts, RTResult
from monortm_tpu_torch.models.rt import combine_boundary_np, rt_parts
from monortm_tpu_torch.models.rt import lsum as _lsum
from monortm_tpu_torch.ops.lineshape import LineConfig
from monortm_tpu_torch.ops.xsec import xsec_od
from monortm_tpu_torch.parallel import distributed
from monortm_tpu_torch.parallel.sharding import Mesh
from monortm_tpu_torch.types import HostState, irt_from_angle
from monortm_tpu_torch.utils.trace import StageTimer, profile_trace


def profil_scal(wkl: np.ndarray, wbrodl: np.ndarray, nmol: int,
                hmol_scal: str, xmol_scal: np.ndarray,
                nmol_scal: int) -> np.ndarray:
    """Profile scaling (profil_scal_sub, monortm_sub.F90:937-1044).

    wkl: [nlay, 39] column densities -> returns scaled copy.
    """
    wkl = np.array(wkl, np.float64)
    wmt = wkl.sum(axis=0)
    wsum_brod = float(np.sum(wbrodl))
    wsum_drair = (0.0 if nmol >= 22 else wsum_brod) + wmt[1:nmol].sum()

    for m in range(nmol_scal):
        hm = hmol_scal[m] if m < len(hmol_scal) else " "
        xm = float(xmol_scal[m]) if m < len(xmol_scal) else 1.0
        if hm == " ":
            fac = 1.0
        elif hm == "0":
            fac = 0.0
        elif hm == "1":
            fac = xm
        elif hm in "Cc":
            fac = xm / wmt[m]
        elif hm in "Mm":
            if wsum_drair <= 0:
                raise ValueError("mixing ratio failure: wsum_drair = 0")
            fac = xm / (wmt[m] / wsum_drair)
        elif hm in "Pp":
            if m != 0:
                raise ValueError("PWV scaling only valid for H2O")
            fac = (xm / cst.PWV_CM_PER_MOLEC_CM2) / wmt[0]
        elif hm in "Dd":
            fac = (xm * cst.DOBSON_TO_MOLEC_CM2) / wmt[m]
        else:
            raise ValueError(f"unknown scaling code {hm!r}")
        wkl[:, m] *= fac
    return wkl


def integr(wkl: np.ndarray, clw: np.ndarray):
    """Column PWV [cm] and CLW [mm] (INTEGR, monortm_sub.F90:831-845)."""
    pwv = float(np.sum(wkl[:, 0])) * cst.PWV_CM_PER_MOLEC_CM2
    return pwv, float(np.sum(clw))


# the reference's hand-centred 8-char labels (DATA HMOLC,
# lblatm.f90:179-188), printed through A10 edits in the LOG tables
_HMOLC8 = (
    "  H2O   ", "  CO2   ", "   O3   ", "  N2O   ", "   CO   ",
    "  CH4   ", "   O2   ", "   NO   ", "  SO2   ", "  NO2   ",
    "  NH3   ", " HNO3   ", "   OH   ", "   HF   ", "  HCL   ",
    "  HBR   ", "   HI   ", "  CLO   ", "  OCS   ", " H2CO   ",
    " HOCL   ", "   N2   ", "  HCN   ", " CH3CL  ", " H2O2   ",
    " C2H2   ", " C2H6   ", "  PH3   ", " COF2   ", "  SF6   ",
    "  H2S   ", " HCOOH  ", "  HO2   ", "   O+   ", " ClONO2 ",
    "   NO+  ", "  HOBr  ", " C2H4   ", " CH3OH  ")


def _fort_hmolid(m: int) -> str:
    """HMOLC(m) through an A10 edit (2 leading blanks)."""
    return "  " + _HMOLC8[m]


def _log_layer_table(log, p, t, wkl, wbrodl, nmol):
    """Per-layer column-amount + mixing-ratio tables into MONORTM.LOG,
    byte-matching the reference's IFORM=1 format statements
    974/980/985/976/979 (monortm_sub.F90:1052-1209; lblatm.f90:1219-1244
    logs the same layout for IATM=1 paths).

    Deviation (documented): in the molecules-8+ mixing-ratio block the
    reference divides by a stale WDRAIR from the previous loop (the
    variable is not recomputed per layer, monortm_sub.F90:1160-1185);
    here the per-layer dry-air density is used for every block.
    """
    p = np.asarray(p, np.float64)
    t = np.asarray(t, np.float64)
    wkl = np.asarray(wkl, np.float64)
    wbrodl = np.asarray(wbrodl, np.float64)
    nlay = len(p)
    holn2 = "  OTHER "

    wmt = wkl.sum(axis=0)
    wtot = wkl[:, :7].sum(axis=1) + wbrodl
    pwtd = float((p * wtot).sum() / wtot.sum())
    twtd = float((t * wtot).sum() / wtot.sum())

    def hdr974(names):
        log.write("0" + " " * 53
                  + "MOLECULAR AMOUNTS (MOL/CM**2) BY LAYER \n")
        log.write(" " * 13 + "P(MB)" + " " * 6 + "T(K)" + " " * 5
                  + "".join(f"{n:>10s}" + " " * 5 for n in names) + "\n")

    def row980(lbl, pv, tv, vals):
        # C-level %-formatting: this table is the host-prep hot spot at
        # many-profile scale
        log.write("0%3d%15.7f%9.2f  " % (lbl, pv, tv)
                  + ("%15.7E" * len(vals)) % tuple(vals) + "\n")

    # molecular amounts, 8 columns per block (974/980/985): block 1 is
    # mols 1-7 + OTHER, later blocks mols 8-15, 16-23, ... (MLO=8,8)
    for mlo in [0] + list(range(7, nmol, 8)):
        mhi = min(mlo + 8, nmol)
        if mlo == 0:
            names = [_fort_hmolid(m)[2:] for m in range(7)] + [holn2]
            cols = lambda k: list(wkl[k, :7]) + [wbrodl[k]]
            tot = list(wmt[:7]) + [float(wbrodl.sum())]
        else:
            log.write("\n" * 5)          # format 970 (////)
            names = [_fort_hmolid(m)[2:] for m in range(mlo, mhi)]
            cols = lambda k: list(wkl[k, mlo:mhi])
            tot = list(wmt[mlo:mhi])
        hdr974(names)
        for k in range(nlay):
            row980(k + 1, p[k], t[k], cols(k))
        if nlay > 1:
            log.write("0" + " " * 54
                      + "ACCUMULATED MOLECULAR AMOUNTS FOR TOTAL PATH\n")
            row980(nlay, pwtd, twtd, tot)

    # mixing ratios vs dry air (976/980/979)
    wdrair = wbrodl + wkl[:, 1:nmol].sum(axis=1)

    def hdr976(names):
        log.write("\n1" + " " * 54
                  + "----------------------------------\n")
        log.write("0" + " " * 60 + "MIXING RATIOS BY LAYER \n")
        log.write(" " * 10 + "P(MB)" + " " * 6 + "T(K)" + " " * 5
                  + "".join(f"{n:>10s}" + " " * 5 for n in names) + "\n")

    for mlo in [0] + list(range(7, nmol, 8)):
        mhi = min(mlo + 8, nmol)
        if mlo == 0:
            names = [_fort_hmolid(m)[2:] for m in range(7)] + [holn2]
            cols = lambda k: list(wkl[k, :7] / wdrair[k]) + [wbrodl[k]]
        else:
            if nlay < 5:
                log.write("\n" * 5)      # format 970
            names = [_fort_hmolid(m)[2:] for m in range(mlo, mhi)]
            cols = lambda k: list(wkl[k, mlo:mhi] / wdrair[k])
        hdr976(names)
        for k in range(nlay):
            if wdrair[k] == 0.0:
                log.write("\n0  MIXING RATIO IS UNDEFINED. "
                          "DRYAIR DENSITY=0.0\n")
            else:
                row980(k + 1, p[k], t[k], cols(k))


@dataclasses.dataclass
class RunResult:
    wn: np.ndarray
    tb: list          # per profile [W]
    rad: list
    results: list     # per profile io.output.ProfileOutput
    # per chunk: (profiles, engine, the layers the all-Lorentz kernel
    # took)
    engines: list = dataclasses.field(default_factory=list)


def _index_tree(x, i):
    """Per-profile numpy view into one batched output container."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _index_tree(v, i) for k, v in x.items()}
    return np.asarray(x)[i]


def _slice_result(res, i):
    """Profile i's view of a batched ForwardResult (host numpy)."""
    od = ODResult(od_total=_index_tree(res.od.od_total, i),
                  od_by_mol=_index_tree(res.od.od_by_mol, i),
                  oc=_index_tree(res.od.oc, i),
                  od_clw=_index_tree(res.od.od_clw, i),
                  od_xsec=_index_tree(res.od.od_xsec, i))
    rt = RTResult(*(_index_tree(v, i) for v in res.rt))
    return ForwardResult(rt=rt, od=od, emis=res.emis, refl=res.refl)


def _device_budget_bytes(device: torch.device) -> float:
    """Memory for one chunk's device work: 75% of what the card has free
    (`torch.cuda.mem_get_info`), a fixed 2 GB on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return 0.75 * float(free)
    return 2.0e9


def _profile_bytes(nwn: int, nlay: int, nmol: int, n_lines: int,
                   itemsize: int = 4, dense: bool = False) -> int:
    """Device bytes `_max_batch` budgets per profile: the [W, M, L] line
    OD and the [W, L] totals and continua (the JAX package's estimate) at
    `itemsize` bytes, plus for the kernels the prologue's per-(layer,
    line) operands, ~64 arrays live at once (the dense engine's block is
    a fixed cost instead)."""
    per = nwn * nlay * (nmol + 6) * itemsize * 2
    if not dense:
        per += nlay * n_lines * itemsize * 64
    return per


def _max_batch(nwn: int, nlay: int, nmol: int, n_lines: int,
               budget_bytes: float, itemsize: int = 4,
               dense: bool = False, n_prof_shards: int = 1,
               wn_tile: int = DENSE_WN_TILE,
               line_tile: int = DENSE_LINE_TILE) -> int:
    """Cap the profile batch of a chunk so that its device work fits.

    Per profile `_profile_bytes`; the dense engine also holds one block
    of fixed shape (`models.od.dense_block_bytes` at its tiles `wn_tile`
    x `line_tile`), whatever the batch.
    This cap is what bounds a chunk on the card: the port keeps no limit
    on line-sum evaluations per call, since a CUDA launch has no
    execution time limit, and the kernels' wrapper launches any number
    of layer rows.  The budget is per rank; a mesh's prof axis splits the
    batch, so the cap scales with it and is rounded down to whole prof
    shards (the JAX package's n_prof_shards)."""
    per = _profile_bytes(nwn, nlay, nmol, n_lines, itemsize, dense)
    fixed = (dense_block_bytes(n_lines, itemsize, wn_tile, line_tile)
             if dense else 0)
    b = int(max(1, min(1024, n_prof_shards * (budget_bytes - fixed)
                       // max(1, per))))
    if b > n_prof_shards:
        b -= b % n_prof_shards
    return b


def _auto_mesh_shape(n: int, nprof: int):
    """The (prof, wn) shape of `_auto_mesh` over n ranks, None for one: as
    much profile parallelism as the workload allows (the largest divisor
    of n not above nprof), the rest of the ranks on the wavenumber axis
    (monortm_tpu/pipeline.py:252-268)."""
    if n <= 1:
        return None
    n_prof = max(d for d in range(1, n + 1)
                 if n % d == 0 and d <= max(1, nprof))
    return {"prof": n_prof, "wn": n // n_prof}


def _auto_mesh(nprof: int):
    """A (prof, wn) mesh over every rank of the torch.distributed world,
    shaped by `_auto_mesh_shape`; None for one rank."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = _auto_mesh_shape(n, nprof)
    return None if shape is None else Mesh(shape)


# the line-sum kernel plan's tiles, lines and wavenumbers (the JAX
# package's pallas_line_tile / pallas_wn_tile, not the tiles of its dense
# engine, `run`'s line_tile / wn_tile); the catalog is packed to the same
# line tile
LINE_TILE, WN_TILE = 256, 128


# the JAX package's engine names, each the port's engine of that meaning
ENGINE_ALIASES = {"xla": "dense", "pallas": "full"}
ENGINES = ("auto", "dense", "full", "hybrid", *ENGINE_ALIASES)


def run(filein="MONORTM.IN", fileprof="MONORTM_PROF.IN", hfile="TAPE3",
        fileout="MONORTM.OUT", outdir=".", *, device="cuda",
        dtype: torch.dtype = torch.float32, engine: str = "auto",
        wn_tile: int = DENSE_WN_TILE, line_tile: int = DENSE_LINE_TILE,
        emis_dir=None, netcdf: bool = False, profile_dir=None,
        workers=None, mesh="auto") -> RunResult:
    """Run the full MONORTM.IN -> MONORTM.OUT pipeline on one device or,
    in a torch.distributed run, on a mesh of ranks.

    device: "cuda" (the default; raises without a card) or "cpu", where
    the line sums take their plain PyTorch versions.  dtype: float32 or
    float64.  engine: "auto" (float32: both line-sum kernels through the
    per-chunk engine split; float64: "dense"), "dense" or its JAX name
    "xla" (the dense engine), "full" or its JAX name "pallas" (the
    VOIGT=true kernel alone) or "hybrid" (the kernels through the split);
    an alias runs, logs and reports as the port's name.  The kernels are
    float32, so "full"/"pallas" and "hybrid" at float64 raise, where the
    JAX package quietly takes its dense engine instead: that fallback
    would hide the kernel the caller named.  wn_tile / line_tile (the
    JAX package's, with its defaults): the dense engine's block of
    wavenumbers and lines; the kernels keep their own plan (LINE_TILE,
    WN_TILE).  emis_dir: the directory of the EMISSION /
    REFLECTION files (default: the "in" directory beside MONORTM.IN).
    workers: host processes for IATM=1 layering
    (atmos.tape5_atm.profiles_from_tape5_iter; a streamed run with a
    pool times its start as the stage `layering.pool`, inside
    `profiles+layering`, and MONORTM.LOG's LAYERING line counts the
    profiles, processes and chunks).  profile_dir: write a
    torch.profiler trace there.  mesh: "auto" (every rank of a
    torch.distributed run on a (prof, wn) mesh, `_auto_mesh`; one device
    otherwise), None (one device per process) or a
    `parallel.sharding.Mesh` over the world's ranks; `device` is then this
    rank's.
    """
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64: {dtype}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}: {engine!r}")
    if min(wn_tile, line_tile) < 1:
        raise ValueError(f"wn_tile and line_tile must be positive: "
                         f"{wn_tile}, {line_tile}")
    asked, engine = engine, ENGINE_ALIASES.get(engine, engine)
    if engine == "auto":
        engine = "hybrid" if dtype == torch.float32 else "dense"
    if engine != "dense" and dtype != torch.float32:
        raise ValueError(f"engine {asked!r} runs the float32 line-sum "
                         f"kernels; a {dtype} run takes engine='dense'")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    filein = Path(filein)
    Path(outdir).mkdir(parents=True, exist_ok=True)
    timer = StageTimer()
    with timer.stage("tape5-parse"):
        iatm, ixsect, nprof = count_profiles(filein, fileprof)
        rd = Tape5Reader(filein)
        cfg = rd.read_block()
    wn = cfg.wn
    if cfg.nwn == 0:
        raise ValueError("no wavenumbers configured")

    # packed to the kernel plan's line tile whatever line_tile is (the JAX
    # package packs to min(line_tile, 4096), monortm_tpu/pipeline.py:315):
    # both engines' tiles drop the padding lines (valid=0), so the pack
    # tile changes no value
    with timer.stage("line-catalog"):
        catalog = load_catalog(hfile, float(wn[0]), float(wn[-1]),
                               tile=LINE_TILE)

    # boundary spectra (EMISS_REFLEC, monortm_sub.F90:506-516)
    ed = Path(emis_dir) if emis_dir else filein.parent / "in"
    emis = emis_io.boundary_spectrum(
        wn, cfg.bndemi, ed / "EMISSION" if cfg.bndemi[0] < 0 else None)
    refl = emis_io.boundary_spectrum(
        wn, cfg.bndrfl, ed / "REFLECTION" if cfg.bndrfl[0] < 0 else None)

    # profiles: IATM=0 parses the layer file (fast); IATM=1 streams the
    # LBLATM-equivalent layering out of the producer (a worker pool when
    # there are many profiles) so the device starts on early profiles
    # while later ones are still being layered, except in an IXSECT run,
    # whose thread-pooled xsec pre-pass needs the full list
    profiles = None
    if iatm == 0:
        with timer.stage("profiles+layering"):
            profiles = read_profiles(fileprof, ixsect=ixsect)
    elif cfg.ixsect >= 1:
        n_layering = layering_workers(nprof, workers, streaming=False)
        with timer.stage("profiles+layering"):
            profiles = profiles_from_tape5(filein, cfg, workers=workers)
    else:
        n_layering = layering_workers(nprof, workers)

    # the (prof, wn[, line]) mesh (every rank makes its process groups
    # here, in one order); only rank 0 writes files
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a Mesh: {mesh!r}")
        mesh = _auto_mesh(len(profiles) if profiles is not None
                          else nprof)
    if mesh is not None and mesh.size() == 1:
        mesh = None
    n_prof_shards = mesh.shape["prof"] if mesh is not None else 1
    is_main = not dist.is_initialized() or dist.get_rank() == 0

    # TAPE7 (IPUNCH=1 on record 3.1, lblatm.f90:1264-1340): the layering
    # output in MONORTM_PROF.IN-compatible form, collected by the
    # producer and written before the last device work
    punched: list = []

    model_cache: dict[int, MonoRTM] = {}
    out = RunResult(wn=wn, tb=[], rad=[], results=[])
    writer = OutputWriter(Path(outdir) / fileout if is_main else os.devnull)

    # MONORTM.LOG (unit IPR=66 in the reference, monortm.f90:322-325):
    # control-record echo, line-file stats, per-profile notes
    log = open(Path(outdir) / "MONORTM.LOG" if is_main else os.devnull, "w")
    log.write(" HIRAC    CNTNM    EMISS     PLOT     IATM      IOD"
              "    XSECT     ISPD     IBRD\n")
    log.write(f"{cfg.ihirac:5d}{cfg.icntnm:9d}{cfg.iemit:9d}"
              f"{cfg.iplot:9d}{cfg.iatm:9d}{cfg.iod:9d}{cfg.ixsect:9d}"
              f"{cfg.ispd:9d}{cfg.ibrd:9d}\n")
    log.write(f"0 TBOUND   = {cfg.tbound:12.4f}     BOUNDARY EMISSIVITY"
              f"   = {cfg.bndemi[0]:11.3E}{cfg.bndemi[1]:11.3E}"
              f"{cfg.bndemi[2]:11.3E}\n")
    # CHECKINPUTS-style echoes (monortm_sub.F90:163-253)
    for w in cfg.warnings:
        print("----------------------------------------")
        print(w)
        log.write(f" {w}\n")
    # PRCNTM-equivalent continuum info (contnm.f90:1170)
    f = cfg.factors
    log.write(" MT_CKD 3.5 CONTINUUM (ICNTNM={:d}): XSELF={:.3f} "
              "XFRGN={:.3f} XCO2C={:.3f} XO3CN={:.3f} XO2CN={:.3f} "
              "XN2CN={:.3f} XRAYL={:.3f}\n".format(
                  cfg.icntnm, f.xself, f.xfrgn, f.xco2c, f.xo3cn,
                  f.xo2cn, f.xn2cn, f.xrayl))
    log.write("   LINE FILE INFORMATION\n")
    mol_counts = collections.Counter(
        int(m) for m, v in zip(catalog.mol, catalog.valid) if v)
    for m in sorted(mol_counts):
        log.write(f"    {HMOLC[m-1]:>6s} = {mol_counts[m]:6d}\n")
    log.write(f"0 TOTAL NUMBER OF LINES ={catalog.n_lines:8d}\n")

    # ---- host prep per profile (scaling, columns, xsec OD) ----------
    cld_file = filein.parent / "in_lblrtm_cld"

    # cross-section OD prep is the one per-profile host stage with real
    # compute (file reads + pressure convolutions); fan it out across a
    # thread pool up front — the index/spectra caches are shared
    # (monortm.f90:492-532 runs this serially per profile)
    xsec_results: dict[int, Any] = {}
    xs_profiles = ([i for i, prof in enumerate(profiles)
                    if prof.xamnt is not None]
                   if profiles is not None and cfg.ixsect >= 1 else [])
    if xs_profiles:
        fdir = filein.parent
        idx_cache: dict[tuple, Any] = {}
        spectra: dict[str, Any] = {}

        def _prep_xsec(i):
            prof = profiles[i]
            key = tuple(prof.xsname)
            if key not in idx_cache:
                idx_cache[key] = read_fscdxs(fdir / "FSCDXS", prof.xsname,
                                             float(wn.min()),
                                             float(wn.max()))
            idx = idx_cache[key]
            for regs in idx.regions.values():
                for reg in regs:
                    for f in reg.files:
                        if f not in spectra:
                            spectra[f] = read_xs_file(fdir / "xs" / f)
            st = prof.state
            return i, xsec_od(idx, spectra, wn, st.p, st.t, prof.xamnt)

        with timer.stage("xsec-prep"):
            # warm the caches serially on the first profile, then fan out
            xsec_results.update([_prep_xsec(xs_profiles[0])])
            rest = xs_profiles[1:]
            if rest:
                with ThreadPoolExecutor(min(8, len(rest))) as ex:
                    xsec_results.update(ex.map(_prep_xsec, rest))

    prepped: list = []

    def prep_profile(npr0, prof):
        """Per-profile host prep (LOG tables, scaling, columns, xsec
        OD) — the reference's per-profile preamble (monortm.f90:369-551).
        Called by the producer in input order."""
        st, meta = prof.state, prof.meta
        wkl = st.wkl
        log.write(f"1 PROFILE {npr0}\n")
        if getattr(prof, "path", None):
            # LBLATM path summary (lblatm.f90:1243-1244, format 968)
            pa = prof.path
            log.write(
                f" PATH: MODEL={prof.hmod or '(user)':24s} "
                f"H1={meta.h1:10.3f} H2={meta.h2:10.3f} "
                f"ANGLE={meta.angle:10.3f} RANGE={pa['range']:10.3f} "
                f"BETA={pa['beta']:10.3f} PHI={pa['phi']:10.3f} "
                f"HMIN={pa['hmin']:10.3f} BENDING={pa['bendng']:10.5f} "
                f"LEN={pa['len']:d} "
                f"AIRTOT={pa['airtot']:11.4E}\n")
        _log_layer_table(log, st.p, st.t, wkl, st.wbrodl, meta.nmol)
        if cfg.nmol_scal > 0:
            wkl = profil_scal(wkl, st.wbrodl, meta.nmol,
                              cfg.hmol_scal, cfg.xmol_scal,
                              cfg.nmol_scal)
            log.write(" PROFILE SCALING (profil_scal_sub): HMOL_SCAL="
                      f"{cfg.hmol_scal[:cfg.nmol_scal]!r} XMOL_SCAL="
                      + " ".join(f"{x:.5E}" for x in
                                 cfg.xmol_scal[:cfg.nmol_scal]) + "\n")
            _log_layer_table(log, st.p, st.t, wkl, st.wbrodl, meta.nmol)
        pwv, clw_col = integr(wkl, st.clw)

        # cross-section molecules (IATM=0 layer amounts;
        # monortm.f90:492-532 + MONORTM_XSEC_SUB), prepared above
        od_xsec = xsec_results.get(npr0 - 1)

        # optional TES cloud OD file (see io/cldod.py), added to the
        # cross-section OD, which the device adds to the total
        if cld_file.exists():
            extra = cloud_od_on_grid(cld_file, wn, st.t.shape[-1])
            od_xsec = extra if od_xsec is None else od_xsec + extra

        irt = irt_from_angle(meta.angle)
        tbound = cfg.tbound
        if tbound < 0.0:       # FPACK: use TZ(0) (lblatm.f90:5952)
            tbound = float(np.asarray(st.tz)[0])
        return dict(st=st, meta=meta, wkl=wkl, pwv=pwv,
                    clw_col=clw_col, od_xsec=od_xsec,
                    irt=irt, tbound=tbound)

    npdt = np.float64 if dtype == torch.float64 else np.float32
    results: dict[int, Any] = {}
    keep_layers = cfg.iod == 1 or netcdf
    host_bytes = [0]
    # the chunk cap's budget, read on this (the consumer's) thread; on a
    # mesh a card's memory is split among the ranks that share it, and
    # every rank takes the smallest budget, so that all chunk alike
    budget = _device_budget_bytes(device)
    if mesh is not None:
        sharing = distributed.rank_devices(device).count(str(device))
        budget = float(distributed.all_reduce(
            torch.tensor(budget / sharing, dtype=torch.float64),
            mesh.group(*mesh.shape), "min"))
    n_cat = len(catalog.mol)

    def pull(x, wn_sizes=None, wn_dim=1):
        """Device -> host with transfer-byte accounting (the LOG line
        proves the default path never hauls a per-layer array).  On a
        mesh the rank's (prof, wn) block is all-gathered, so that every
        rank holds the whole chunk."""
        if x is None:
            return None
        if mesh is None:
            a = x.cpu().numpy()
        else:
            a = distributed.gather_to_host(x, mesh, wn_dim, wn_sizes)
        host_bytes[0] += a.nbytes
        return a

    def ensure_model(nmol):
        """Build (once, on the consumer thread) the model of an nmol
        group."""
        if nmol not in model_cache:
            with timer.stage("model-build"):
                model_cache[nmol] = MonoRTM(
                    wn, cfg.dvset, catalog, nmol=nmol,
                    factors=cfg.factors,
                    line_cfg=LineConfig(ibrd=cfg.ibrd), device=device,
                    dtype=dtype, wn_tile=WN_TILE, line_tile=LINE_TILE,
                    dense_wn_tile=wn_tile, dense_line_tile=line_tile,
                    kernels=engine != "dense", mesh=mesh)
        return model_cache[nmol]

    def produce():
        """The producer: profiles (possibly streaming out of the
        layering worker pool) -> per-profile prep -> same-shape chunk
        buffers (one [B, nlay] forward per chunk; the reference runs
        profile by profile, monortm.f90:357) -> host-stacked work items,
        yielded in deterministic order.  Host work only."""
        buffers: dict[tuple, list[int]] = {}
        bmax_of: dict[tuple, int] = {}

        def emit(key):
            nlay, irt_, nmol, has_x = key
            return host_prep(dict(nlay=nlay, irt=irt_, nmol=nmol,
                                  has_x=has_x, chunk=buffers.pop(key)))

        if profiles is not None:
            src = iter(profiles)
        else:
            src = profiles_from_tape5_iter(
                filein, cfg, workers=workers,
                pool_stage=lambda: timer.stage("layering.pool"))
        npr0 = 0
        while True:
            if profiles is None:
                with timer.stage("profiles+layering"):
                    prof = next(src, None)
            else:
                prof = next(src, None)
            if prof is None:
                break
            npr0 += 1
            with timer.stage("host-prep"):
                pr = prep_profile(npr0, prof)
            prepped.append(pr)
            if getattr(prof, "ipunch", 0) == 1:
                punched.append(prof)
            key = (pr["st"].t.shape[-1], pr["irt"], pr["meta"].nmol,
                   pr["od_xsec"] is not None)
            buffers.setdefault(key, []).append(len(prepped) - 1)
            if key not in bmax_of:
                bmax_of[key] = _max_batch(
                    len(wn), key[0], key[2], n_cat, budget,
                    itemsize=np.dtype(npdt).itemsize,
                    dense=engine == "dense", n_prof_shards=n_prof_shards,
                    wn_tile=wn_tile, line_tile=line_tile)
            if len(buffers[key]) >= bmax_of[key]:
                yield emit(key)
        # layering is complete here: write the TAPE7 checkpoint artifact
        # BEFORE the remaining device work so a mid-compute failure
        # cannot lose the layering output (the reference writes it from
        # LBLATM, lblatm.f90:1264-1340)
        if punched and is_main:
            write_tape7(Path(outdir) / "TAPE7", punched, xid=cfg.xid)
        for key in list(buffers):         # flush partial buffers
            yield emit(key)

    def host_prep(item):
        """Stack the chunk's host arrays in the compute dtype (numpy, on
        the producer thread, while the device runs the previous chunk).
        On a mesh the chunk is padded to whole prof shards by repeating
        its last profile (whose outputs are dropped), and the rank stacks
        its own profile block."""
        prs = [prepped[i] for i in item["chunk"]]
        prs += [prs[-1]] * ((-len(prs)) % n_prof_shards)
        with timer.stage("host-stack"):
            nstack = lambda f, ps: np.stack([f(p) for p in ps]).astype(npdt)
            item["tsfc"] = nstack(lambda p: np.asarray([p["tbound"]]), prs)
            if mesh is not None:
                start, count = distributed.host_local_batch(len(prs), mesh)
                prs = prs[start:start + count]
            item["host"] = HostState(
                p=nstack(lambda p: p["st"].p, prs),
                t=nstack(lambda p: p["st"].t, prs),
                tz=nstack(lambda p: p["st"].tz, prs),
                wkl=nstack(lambda p: p["wkl"], prs),
                wbrodl=nstack(lambda p: p["st"].wbrodl, prs),
                clw=nstack(lambda p: p["st"].clw, prs))
            if item["has_x"]:
                item["ox"] = nstack(lambda p: p["od_xsec"], prs)
        return item

    def dispatch(item):
        """Upload the chunk, choose its engines and enqueue its device
        work; the synchronous pull happens in finalize() after the next
        chunk has been dispatched."""
        model = ensure_model(item["nmol"])
        with timer.stage("host->device"):
            state = state_from_numpy(item.pop("host"), device, dtype)
            ox = item.pop("ox", None)
            if ox is not None:
                ox = torch.as_tensor(ox, device=device)
        # the per-layer zeta > 0.99 predicate on the model's device at
        # margin 0; its verdict (one bool per layer) is a host sync
        eng, lor = engine, ()
        if engine == "hybrid":
            with timer.stage("engine-predicate"):
                eng, lor = model.engine_split(state)
        out.engines.append((len(item["chunk"]), eng,
                            tuple(range(item["nlay"])) if eng == "lorentz"
                            else tuple(lor)))
        with timer.stage("device-dispatch"), torch.no_grad():
            od = model.od_model(state, engine=eng, lor_layers=lor,
                                od_xsec=ox)
            # layer reductions on the device: the [B, W, M, L] array
            # stays there and only the [B, W, M] sums cross to the host
            # unless IOD=1 / NetCDF asks for per-layer arrays
            red = dict(otot=_lsum(od.od_total), by_mol=_lsum(od.od_by_mol),
                       oc={k: _lsum(v, -2) for k, v in od.oc.items()})
            if od.od_xsec is not None:
                red["odx"] = _lsum(od.od_xsec, -2)
            parts = rt_parts(od.od_total, state.t[..., None, :],
                             state.tz[..., None, :], model.od_model.wn_t)
        item.update(parts=parts, red=red,
                    odt=od.od_total if keep_layers else None,
                    odfull=od if netcdf else None,
                    wn_sizes=model.od_model.wn_sizes)
        return item

    def finalize(item):
        """Synchronous device->host pull, the O(W) numpy boundary
        combine and result storage."""
        with timer.stage("device->host"):
            ws = item["wn_sizes"]
            parts_h = RTParts(*(pull(v, ws) for v in item["parts"]))
            red_h = {k: ({s: pull(a, ws) for s, a in v.items()}
                         if isinstance(v, dict) else pull(v, ws))
                     for k, v in item["red"].items()}
            odt_h = pull(item["odt"], ws)
            od = item["odfull"]
            od_h = None if od is None else ODResult(
                od_total=pull(od.od_total, ws),
                od_by_mol=pull(od.od_by_mol, ws),
                oc={k: pull(v, ws, 2) for k, v in od.oc.items()},
                od_clw=pull(od.od_clw, ws, 2),
                od_xsec=pull(od.od_xsec, ws, 2))
        rad_h, tb_h, tmr_h = combine_boundary_np(
            wn, parts_h.rup, parts_h.rdn, parts_h.trtot,
            parts_h.radtmr, item["tsfc"], emis, refl, item["irt"],
            dtype=npdt)
        full_h = None
        if od_h is not None:
            full_h = ForwardResult(
                rt=RTResult(rad=rad_h, tb=tb_h, rup=parts_h.rup,
                            rdn=parts_h.rdn, trtot=parts_h.trtot,
                            tmr=tmr_h),
                od=od_h, emis=emis, refl=refl)
        for bi, i in enumerate(item["chunk"]):
            results[i] = ProfileOutput(
                tb=tb_h[bi], tmr=tmr_h[bi], rad=rad_h[bi],
                trtot=parts_h.trtot[bi], rup=parts_h.rup[bi],
                rdn=parts_h.rdn[bi], emis=emis, refl=refl,
                otot=red_h["otot"][bi],
                by_mol=red_h["by_mol"][bi],
                oc={k: v[bi] for k, v in red_h["oc"].items()},
                odx=(red_h["odx"][bi] if "odx" in red_h else None),
                od_layers=(odt_h[bi] if odt_h is not None else None),
                full=(_slice_result(full_h, bi)
                      if full_h is not None else None))

    # ---- software pipeline over chunks: the producer thread layers and
    # preps chunk N+1 while the device runs chunk N, and the synchronous
    # pull of chunk N happens only after chunk N+1 has been dispatched
    with profile_trace(profile_dir):
        q: Any = queue.Queue(maxsize=2)
        stop = threading.Event()

        def _put(x):
            """Bounded put that gives up if the consumer died."""
            while not stop.is_set():
                try:
                    q.put(x, timeout=1.0)
                    return
                except queue.Full:
                    continue

        def feeder():
            try:
                for it in produce():
                    _put(it)
                    if stop.is_set():
                        return
                _put(("done", None))
            except BaseException as e:    # re-raised in the consumer
                _put(("err", e))

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        try:
            pending = None
            while True:
                with timer.stage("queue-wait"):
                    nxt = q.get()
                if isinstance(nxt, tuple):
                    if nxt[0] == "err":
                        raise nxt[1]
                    break
                dev = dispatch(nxt)
                if pending is not None:
                    finalize(pending)
                pending = dev
            if pending is not None:
                finalize(pending)
        finally:
            # unblock and retire the producer even when dispatch or
            # finalize raised
            stop.set()
            th.join(timeout=30.0)

    results = [results[i] for i in range(len(prepped))]

    # ---- write outputs in input order --------------------------------
    with writer:
        for i, (pr, res) in enumerate(zip(prepped, results)):
            npr = i + 1
            st, meta = pr["st"], pr["meta"]
            with timer.stage("output"):
                writer.write_profile(npr, wn, res, st, meta, pr["pwv"],
                                     pr["clw_col"], pr["tbound"],
                                     meta.angle)
            if cfg.iod == 1 and is_main:
                writer.write_layer_ods(npr, wn, res.od_layers, outdir)
            if netcdf and is_main:  # USENETCDF (monortm_sub.F90:698-778)
                write_netcdf(Path(outdir) / f"MONORTM.{npr:05d}.nc", npr,
                             wn, res.full, st, meta, pr["pwv"],
                             pr["clw_col"], pr["tbound"], meta.angle)

            out.tb.append(np.asarray(res.tb))
            out.rad.append(np.asarray(res.rad))
            out.results.append(res)
            log.write(f"PROFILE {npr:5d}: NLAYRS={st.t.shape[-1]:4d} "
                      f"ANGLE={meta.angle:8.3f} IRT={pr['irt']} "
                      f"PWV={pr['pwv']:8.4f} CLW={pr['clw_col']:8.4f}\n")
            if is_main:
                print(f"PROCESSING PROFILE NUMBER: {npr:5d}")
    # version-stamp tail (monortm.f90:591-619, format 1000): same layout,
    # the port's module identities in the A15 fields
    try:
        hvrspec = read_tape3_header(hfile)[:15]
    except (OSError, EOFError):
        hvrspec = "(no TAPE3 hdr)"
    _v = __version__
    a15 = lambda s: f"{s[:15]:<15s}"
    log.write("\n--------------------------------------\n")
    log.write("Modules and versions used in this calculation:\n\n")
    log.write(a15("Release  5.6") + "\n\n")
    log.write(f"     spectral file :     {a15(hvrspec)}\n")
    log.write(f"     monortm.f     :     {a15('pipeline ' + _v)}          "
              f"modm.f           :      {a15('models.od ' + _v)}\n")
    log.write(f"     monortm_sub.f :     {a15('io.output ' + _v)}          "
              f"lblatm_monortm.f :      {a15('atmos ' + _v)}\n")
    log.write(f"     package       :     monortm_tpu_torch {_v} (torch "
              f"{torch.__version__}, {device})\n")
    log.write(f" HOST PULL: {host_bytes[0]} bytes device->host "
              f"(per-layer arrays pulled: {keep_layers})\n")
    if mesh is not None:
        shape = " x ".join(f"{k} {v}" for k, v in mesh.shape.items())
        log.write(f" MESH: {shape} over {mesh.size()} ranks, backend "
                  f"{dist.get_backend()}\n")
    for n, eng, lor in out.engines:
        log.write(f" ENGINE SPLIT: {n} profile(s): {eng}, {len(lor)} "
                  f"all-Lorentz layer(s)\n")
    if iatm == 1:
        log.write(f" LAYERING: {len(prepped)} profile(s) over {n_layering} "
                  f"worker process(es), {len(out.engines)} chunk(s)\n")
    log.write(timer.report())
    log.close()
    return out

