"""MONORTM.OUT writer (STOREOUT equivalent, monortm_sub.F90:519-787).

Produces byte-compatible column layout: header + one row per wavenumber
with brightness temperature, mean radiating temperature, radiance,
transmittance, columns, boundary values, total OD and per-molecule
integrated ODs.  Also provides an npz writer covering the reference's
optional NetCDF output fields (monortm_sub.F90:698-778) without requiring
a NetCDF library.

A copy of `monortm_tpu.io.output`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np

from monortm_tpu_torch import constants as cst
from monortm_tpu_torch.data.loader import HMOLC


@dataclasses.dataclass
class ProfileOutput:
    """Host-side per-profile results, pre-reduced on device.

    Everything STOREOUT prints is O(W) or O(W x M): the layer reductions
    (total OD, per-molecule line OD, continuum OD sums) happen on the
    device inside the OD jit, so the default pipeline only transfers
    these small arrays (monortm_sub.F90:649-656 does the same sums on
    host because the Fortran has no device).  Per-layer arrays are
    attached only when a consumer needs them (IOD=1 layer files,
    NetCDF output).
    """
    tb: Any               # [W] brightness temperature
    tmr: Any              # [W] mean radiating temperature
    rad: Any              # [W] radiance
    trtot: Any            # [W] total transmittance
    rup: Any              # [W] upwelling path radiance
    rdn: Any              # [W] downwelling path radiance
    emis: Any             # [W]
    refl: Any             # [W]
    otot: Any             # [W]      total OD summed over layers
    by_mol: Any           # [W, M]   line OD per molecule, layer-summed
    oc: Any               # {species: [W]} continuum OD, layer-summed
    odx: Any = None       # [W] cross-section OD, layer-summed (or None)
    od_layers: Any = None  # [W, L] per-layer total OD (IOD=1 / NetCDF)
    full: Any = None      # ForwardResult with per-layer fields (NetCDF)


def _active_molecules(wkl: np.ndarray, wbrodl: np.ndarray, nmol: int):
    """Molecule selection for the output columns (monortm_sub.F90:601-614)."""
    wkl = np.array(wkl, np.float64)
    if nmol < 22:
        wkl[:, 21] = wbrodl
    wk_tot = wkl.sum(axis=0)
    ids = [im for im in range(39) if wk_tot[im] > 0]
    return ids


class OutputWriter:
    def __init__(self, path: str | Path, mode: str = "w"):
        self.fh = open(path, mode)
        self._ids = None

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_profile(self, npr: int, wn, po: ProfileOutput, state, meta,
                      pwv, clw_col, tsfc, angle):
        """One profile block (header written for every profile, as the
        reference does).  po: ProfileOutput (device-reduced host arrays);
        state/meta: profile inputs."""
        wn = np.asarray(wn)
        nwn = len(wn)

        if self._ids is None:
            self._ids = _active_molecules(np.asarray(state.wkl),
                                          np.asarray(state.wbrodl), meta.nmol)
        ids = self._ids

        giga = wn[0] < 100.0
        wnunits = "FREQ(GHz)" if giga else "FREQ(cm-1)"
        freq = wn * cst.CLIGHT / 1e9 if giga else wn

        f = self.fh
        f.write("MONORTM RESULTS:\n")
        f.write("----------------\n")
        f.write(f"NWN :{nwn:8d}" + " " * 101
                + "Molecular Optical Depths -->\n")
        cmol = [HMOLC[i].center(8) for i in ids]
        # header row: (a5,a10,2a11,a22,a8,2a8,3a8,a9,36a12)
        hdr = ("PROF ".ljust(5) + wnunits.ljust(10) + "BT(K) ".rjust(11)
               + "TMR(K)".rjust(11) + "  RAD(W/cm2_ster_cm-1)".rjust(22)
               + "TRANS".rjust(8) + "PWV".rjust(8) + "CLW".rjust(8)
               + "TBOUND".rjust(8) + "EMIS".rjust(8) + "REFL".rjust(8)
               + "ANGLE".rjust(9)
               + "TOTAL_OD".rjust(12)
               + "".join(c.rjust(12) for c in cmol) + "XSEC_OD".rjust(12))
        f.write(hdr + "\n")

        # integrated per-molecule OD: lines + continuum, reduced over
        # layers on device (monortm_sub.F90:649-656)
        cont_of = {0: "h2o", 1: "co2", 2: "o3", 6: "o2", 21: "n2"}
        otot = np.asarray(po.otot)                    # [W]
        odx = (np.asarray(po.odx) if po.odx is not None
               else np.zeros(nwn))
        bm = np.asarray(po.by_mol)                    # [W, M]
        tb = np.asarray(po.tb)
        tmr = np.asarray(po.tmr)
        rad = np.asarray(po.rad)
        trt = np.asarray(po.trtot)
        emis = np.asarray(po.emis)
        refl = np.asarray(po.refl)

        by_mol = np.zeros((len(ids), nwn))
        for k, im in enumerate(ids):
            # molecules beyond the profile's nmol (e.g. N2 implied by
            # WBRODL) have no line OD slot — continuum only
            if im < bm.shape[1]:
                by_mol[k] = bm[:, im]
            if im in cont_of:
                by_mol[k] += np.asarray(po.oc[cont_of[im]])

        for iw in range(nwn):
            # row format 21 (monortm_sub.F90:781-782)
            row = (f"{npr:5d}{freq[iw]:10.3f}{tb[iw]:11.5f}{tmr[iw]:11.5f}"
                   f"{rad[iw]:21.9E}{trt[iw]:9.5f}{pwv:8.4f}{clw_col:8.4f}"
                   f"{tsfc:8.2f}{emis[iw]:8.2f}{refl[iw]:8.2f}{angle:9.3f}"
                   f"{otot[iw]:12.4E}"
                   + "".join(f"{by_mol[k, iw]:12.4E}" for k in range(len(ids)))
                   + f"{odx[iw]:12.4E}")
            f.write(row + "\n")

    def write_layer_ods(self, npr: int, wn, od_total, outdir="."):
        """Optional per-layer OD files (IOD=1, monortm_sub.F90:677-694)."""
        wn = np.asarray(wn)
        giga = wn[0] < 100.0
        freq = wn * cst.CLIGHT / 1e9 if giga else wn
        wnunits = "FREQ(GHz)" if giga else "FREQ(cm-1)"
        od = np.asarray(od_total)
        for j in range(od.shape[-1]):
            name = Path(outdir) / f"ODmono_prf{npr:04d}_lay{j+1:04d}"
            with open(name, "w") as fh:
                fh.write(f"NWN :{len(wn):8d}\n")
                fh.write(f"{wnunits:>10s}{' LAYER_OD':>10s}\n")
                for iw in range(len(wn)):
                    fh.write(f"{freq[iw]:10.3f}{od[iw, j]:12.4E}\n")


def write_netcdf(path, npr, wn, res, state, meta, pwv, clw_col, tsfc,
                 angle):
    """MONORTM.NNNNN.nc writer (USENETCDF path, monortm_sub.F90:698-778).

    Same dimensions and variable names as the reference: FREQUENCY /
    MOLECULE / LAYERS / STRING_LENGTH dims; per-wn vectors (BT, RAD,
    TRANS, PWV, CLW, SFCT, EMIS, REFL, ANGLE, TMR, TOTAL_OD, XSEC_OD),
    TOTAL_OD_BY_MOLECULE [mol, wn], LAYER_OPTICAL_DEPTH [wn, lay] and
    LAYER_OPTICAL_DEPTH_BY_MOLECULE [wn, mol, lay] (= lines + continuum,
    the reference's O_BY_MOL + OC).  Written as classic NetCDF-3 via
    scipy (no external netcdf library in the image).
    """
    from scipy.io import netcdf_file

    wn = np.asarray(wn, np.float64)
    nwn = len(wn)
    rt = res.rt
    ids = _active_molecules(np.asarray(state.wkl),
                            np.asarray(state.wbrodl), meta.nmol)
    od_by_mol = np.asarray(res.od.od_by_mol)          # [W, M, L]
    od_total = np.asarray(res.od.od_total)            # [W, L]
    oc = {k: np.asarray(v) for k, v in res.od.oc.items()}
    cont_of = {0: "h2o", 1: "co2", 2: "o3", 6: "o2", 21: "n2"}
    nlay = od_total.shape[-1]
    kount = len(ids)

    by_mol_layer = np.zeros((nwn, kount, nlay), np.float32)
    for k, im in enumerate(ids):
        lay = (od_by_mol[:, im, :] if im < od_by_mol.shape[1]
               else np.zeros((nwn, nlay)))
        if im in cont_of:
            lay = lay + oc[cont_of[im]].T             # oc: [L, W]
        by_mol_layer[:, k, :] = lay
    tot_by_mol = by_mol_layer.sum(axis=-1).T          # [mol, wn]
    odx = (np.asarray(res.od.od_xsec).sum(axis=0)
           if res.od.od_xsec is not None else np.zeros(nwn))

    with netcdf_file(str(path), "w") as nc:
        nc.createDimension("FREQUENCY", nwn)
        nc.createDimension("MOLECULE", kount)
        nc.createDimension("LAYERS", nlay)
        nc.createDimension("STRING_LENGTH", 8)

        def vec(name, data, dt="d"):
            v = nc.createVariable(name, dt, ("FREQUENCY",))
            v[:] = np.asarray(data, np.float64 if dt == "d" else np.float32)

        v = nc.createVariable("FREQUENCY", "d", ("FREQUENCY",))
        v[:] = wn
        v.units = b"cm-1       "
        vec("BT", rt.tb)
        vec("RAD", rt.rad)
        vec("TRANS", rt.trtot)
        vec("PWV", np.full(nwn, pwv))
        vec("CLW", np.full(nwn, clw_col))
        vec("SFCT", np.full(nwn, tsfc))
        vec("EMIS", res.emis)
        vec("REFL", res.refl)
        vec("ANGLE", np.full(nwn, angle))
        vec("TMR", rt.tmr)
        vec("TOTAL_OD", od_total.sum(axis=-1))
        v = nc.createVariable("TOTAL_OD_BY_MOLECULE", "d",
                              ("MOLECULE", "FREQUENCY"))
        v[:] = tot_by_mol
        vec("XSEC_OD", odx)
        v = nc.createVariable("MOLECULE", "c",
                              ("MOLECULE", "STRING_LENGTH"))
        for k, im in enumerate(ids):
            v[k, :] = np.frombuffer(HMOLC[im].ljust(8)[:8].encode(),
                                    dtype="S1")
        v = nc.createVariable("LAYER_OPTICAL_DEPTH", "d",
                              ("FREQUENCY", "LAYERS"))
        v[:] = od_total
        v = nc.createVariable("LAYER_OPTICAL_DEPTH_BY_MOLECULE", "f",
                              ("FREQUENCY", "MOLECULE", "LAYERS"))
        v[:] = by_mol_layer


def write_npz(path, wn, res, state, meta, pwv, clw_col, tsfc, angle):
    """Structured archive with the reference NetCDF fields
    (monortm_sub.F90:729-772): per-wn results + per-layer OD by molecule."""
    rt = res.rt
    np.savez_compressed(
        path,
        frequency=np.asarray(wn),
        bt=np.asarray(rt.tb), rad=np.asarray(rt.rad),
        trans=np.asarray(rt.trtot), tmr=np.asarray(rt.tmr),
        pwv=pwv, clw=clw_col, sfct=tsfc, angle=angle,
        emis=np.asarray(res.emis), refl=np.asarray(res.refl),
        total_od=np.asarray(res.od.od_total).sum(-1),
        layer_od=np.asarray(res.od.od_total),
        layer_od_by_molecule=np.asarray(res.od.od_by_mol),
    )
