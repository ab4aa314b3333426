"""The port's host copies against their JAX originals, by behaviour.

`monortm_tpu_torch` carries its own copies of the JAX package's numpy
host modules (io.tape5, io.profin, io.tape3, io.tape7, io.output,
io.emis, io.cldod, io.fscdxs, lines.load_catalog, atmos.*,
ContinuumFactors.from_icntnm, models.rt.combine_boundary_np).  Each is
run here beside its original on the same inputs: parsed fields and
arrays equal, written files byte for byte equal.  The layering runs in
both packages through a native C++ helper built from the same source by
default, and through their Python walks with the helpers switched off:
either way the arrays are equal.
"""

import dataclasses

import numpy as np
import pytest

from monortm_tpu import lines as j_lines
from monortm_tpu import native as j_native
from monortm_tpu.atmos.tape5_atm import atmpth as j_atmpth
from monortm_tpu.io import cldod as j_cldod
from monortm_tpu.io import emis as j_emis
from monortm_tpu.io import fscdxs as j_fscdxs
from monortm_tpu.io import output as j_output
from monortm_tpu.io import profin as j_profin
from monortm_tpu.io import tape3 as j_tape3
from monortm_tpu.io import tape5 as j_tape5
from monortm_tpu.io.tape7 import write_tape7 as j_write_tape7
from monortm_tpu.models.rt import combine_boundary_np as j_combine
from monortm_tpu.ops.continuum import ContinuumFactors as JFactors
from monortm_tpu.testing import make_minimal_rundir as j_make_rundir
from monortm_tpu_torch import lines
from monortm_tpu_torch.atmos.tape5_atm import atmpth
from monortm_tpu_torch.io import cldod, emis, fscdxs, output, profin, tape3
from monortm_tpu_torch.io import tape5
from monortm_tpu_torch.io.tape7 import write_tape7
from monortm_tpu_torch.models.rt import combine_boundary_np
from monortm_tpu_torch.ops.continuum import ContinuumFactors
from monortm_tpu_torch.testing import make_minimal_rundir, synthetic_catalog_mw

STATE_FIELDS = ("p", "t", "tz", "wkl", "wbrodl", "clw")

# records 3.1-3.3 of an IATM=1 run: US standard atmosphere, 0-30 km,
# looking up from the ground, automatic layering, 22 molecules, TAPE7 on
# (tests/test_atmos.py CASE1_REST)
CASE1_REST = [
    "    6    2    0    1    1   22    1",
    "     0.000    30.000       0.000",
    "     0.000     3.000     3.000     0.000     0.000",
    "-1",
]

# MODEL=0 on a pressure grid, H2O in RH% (tests/test_atmos.py)
USER_REST = [
    "    0    2    4    1    0    7    1",
    "     0.008     3.000     0.000",
    "     0.008     1.000     2.000     3.000",
    "    4 TEST",
    "     0.008  1011.900   245.450     AA   H666666",
    "7.4000e+01     0.000  0.000000  0.000000  0.000000  0.000000      0.00",
    "     1.000   897.000   240.000     AA   H666666",
    "6.0000e+01     0.000  0.000000  0.000000  0.000000  0.000000      0.00",
    "     2.000   795.000   236.000     AA   H666666",
    "5.0000e+01     0.000  0.000000  0.000000  0.000000  0.000000      0.00",
    "     3.000   701.200   230.000     AA   H666666",
    "4.0000e+01     0.000  0.000000  0.000000  0.000000  0.000000      0.00",
]


def rec12(icntnm=1, iatm=0, iod=0, ixsect=0) -> str:
    """Record 1.2 (4X,I1,9X,I1,9X,I1,14X,I1,9X,I1,14X,I1,4X,I1)."""
    r = [" "] * 70
    for pos, v in ((4, 1), (14, icntnm), (24, 1), (39, 1), (49, iatm),
                   (64, iod), (69, ixsect)):
        r[pos] = str(v)
    return "".join(r)


def rec13(v1, v2, dvset, nmol_scal=0) -> str:
    """Record 1.3 (8E10.3,4X,I1,5X,E10.3,I5)."""
    vals = (v1, v2, 0.0, dvset, 0.0, 0.0, 0.0, 0.0)
    return ("".join(f"{v:10.3E}" for v in vals) + "    0" + " " * 5
            + f"{0.0:10.3E}{nmol_scal:5d}")


REC14 = "     0.    1.0       0.000E+00 0.000E+00 0.000E+00 0.000E+00 0.000E+00"


def iatm1_tape5(v1=0.2, v2=1.2, dvset=0.1, rest=CASE1_REST, icntnm=1,
                iod=0, ixsect=0) -> str:
    """An IATM=1 MONORTM.IN: one '$' block over [v1, v2] with `rest` as
    its records 3.x."""
    return "\n".join(
        ["* synthetic IATM=1 case", "$ IATM=1 test",
         rec12(icntnm=icntnm, iatm=1, iod=iod, ixsect=ixsect),
         rec13(v1, v2, dvset), REC14, *rest, "%%%%"]) + "\n"


def stacked_iatm1_tape5(n, rest=CASE1_REST, **kw) -> str:
    """n '$'-stacked IATM=1 blocks (iatm1_tape5's, `kw` passed on), block
    k looking up from the ground to 20 + k km, so that their layer counts
    differ."""
    blocks = []
    for k in range(n):
        r = [rest[0], f"{0.0:10.3f}{20.0 + k:10.3f}{0.0:10.3f}", *rest[2:]]
        blocks += iatm1_tape5(rest=r, **kw).splitlines()[1:-1]
    return "\n".join(["* stacked IATM=1 case", *blocks, "%%%%"]) + "\n"


def _tape5_cases():
    from monortm_tpu_torch.testing import _MIN_TAPE5
    icntnm6 = "\n".join(
        ["$ ICNTNM=6", rec12(icntnm=6),
         "1.0 0.5 1.0 0.9 1.0 0.8 0.0",
         rec13(0.5, 2.5, 0.25), REC14, "%%%%"]) + "\n"
    scaled = "\n".join(
        ["$ scaled", rec12(), rec13(-1.0, 3.0, 0.0, nmol_scal=9),
         "P1     M D",
         "".join(f"{x:15.7E}" for x in (1.5, 1.1, 0.0, 0.0, 0.0, 0.0, 0.0)),
         "".join(f"{x:15.7E}" for x in (1.9e-1, 300.0)),
         "3", "0.5", "1.25", "2.75", REC14, "%%%%"]) + "\n"
    return {"minimal": _MIN_TAPE5, "icntnm6": icntnm6, "scaled": scaled,
            "iatm1": iatm1_tape5()}


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchio")
    make_minimal_rundir(d, nprof=3)
    return d


def _same_config(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "factors":
            assert dataclasses.astuple(x) == dataclasses.astuple(y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("case", ["minimal", "icntnm6", "scaled", "iatm1"])
def test_tape5_config_equal(case, rundir, tmp_path):
    path = tmp_path / "MONORTM.IN"
    path.write_text(_tape5_cases()[case])
    prof = rundir / "MONORTM_PROF.IN"
    assert tape5.count_profiles(path, prof) == \
        j_tape5.count_profiles(path, prof)
    mine, ref = tape5.Tape5Reader(path), j_tape5.Tape5Reader(path)
    a, b = mine.read_block(), ref.read_block()
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    _same_config(a, b)
    assert mine.at_end() == ref.at_end() and mine.pos == ref.pos
    if case == "scaled":
        assert a.nmol_scal == 9 and a.nwn == 3
    if case == "icntnm6":
        assert a.factors.xrayl == 0.0 and a.nwn == 9


def _same_profile(a, b):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(a.state, f),
                                      getattr(b.state, f), err_msg=f)
    for f in ("nmol", "angle", "h1", "h2"):
        assert getattr(a.meta, f) == getattr(b.meta, f), f
    for f in ("altz", "pz"):
        np.testing.assert_array_equal(getattr(a.meta, f),
                                      getattr(b.meta, f), err_msg=f)
    assert a.meta.irt == b.meta.irt
    for f in ("secnt0", "hmod", "xsname", "path", "ipunch"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("xamnt", "ityl"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_read_profiles_equal(rundir, tmp_path):
    path = rundir / "MONORTM_PROF.IN"
    mine, ref = profin.read_profiles(path), j_profin.read_profiles(path)
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        _same_profile(a, b)
    # a TAPE7 (IFORM=1, '$' header) read back as MONORTM_PROF.IN
    t7 = tmp_path / "TAPE7"
    write_tape7(t7, [atmpth(CASE1_REST, 0.2, 1.2)], xid="case 1")
    mine, ref = profin.read_profiles(t7), j_profin.read_profiles(t7)
    assert len(mine) == len(ref) == 1
    _same_profile(mine[0], ref[0])


def _raw_equal(a, b):
    for f in dataclasses.fields(j_tape3.RawLines):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(x, y, err_msg=f.name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f.name


@pytest.mark.parametrize("v1,v2", [(0.2, 60.0), (5.0, 9.0), (80.0, 90.0)])
def test_tape3_read_and_catalog_equal(v1, v2, tmp_path, monkeypatch):
    raw = synthetic_catalog_mw(n_h2o=600, n_o2=80, seed=4, raw_lines=True)
    path = tmp_path / "TAPE3"
    tape3.write_tape3(path, raw)          # three 250-line panels and more
    assert tape3.read_tape3_header(path) == j_tape3.read_tape3_header(path)
    _raw_equal(tape3.read_tape3(path, v1, v2),
               j_tape3.read_tape3(path, v1, v2))
    fields = [f.name for f in dataclasses.fields(j_lines.PackedCatalog)]
    assert fields == [f.name for f in dataclasses.fields(lines.PackedCatalog)]
    # the JAX package's native group+resolve, then its Python path
    for native_on in (True, False):
        if not native_on:
            monkeypatch.setattr(j_native, "_LIB", False)
        a = lines.load_catalog(path, v1, v2, tile=256)
        b = j_lines.load_catalog(path, v1, v2, tile=256)
        assert isinstance(a, lines.PackedCatalog)
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f


@pytest.mark.parametrize("n_h2o", [0, 64, 700])
def test_write_tape3_bytes_equal(n_h2o, tmp_path):
    raw = synthetic_catalog_mw(n_h2o=n_h2o, n_o2=16, raw_lines=True)
    tape3.write_tape3(tmp_path / "mine", raw)
    j_tape3.write_tape3(tmp_path / "ref", raw)
    assert (tmp_path / "mine").read_bytes() == (tmp_path / "ref").read_bytes()


def test_minimal_rundir_bytes_equal(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    make_minimal_rundir(tmp_path / "a", nprof=2)
    j_make_rundir(tmp_path / "b", nprof=2)
    for name in ("MONORTM.IN", "MONORTM_PROF.IN", "TAPE3"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name


def test_write_tape7_bytes_equal(rundir, tmp_path):
    profs = [atmpth(CASE1_REST, 0.2, 1.2), atmpth(USER_REST, 0.5, 1.0)]
    profs += profin.read_profiles(rundir / "MONORTM_PROF.IN")
    write_tape7(tmp_path / "mine", profs, xid="synthetic")
    j_write_tape7(tmp_path / "ref", profs, xid="synthetic")
    assert (tmp_path / "mine").read_bytes() == (tmp_path / "ref").read_bytes()


def _profile_output(mod, rng, nwn, nmol, nlay):
    r = lambda *s: rng.uniform(0.1, 1.0, s).astype(np.float32)
    return mod.ProfileOutput(
        tb=200.0 + 100.0 * r(nwn), tmr=250.0 + 30.0 * r(nwn),
        rad=1e-12 * r(nwn), trtot=r(nwn), rup=r(nwn), rdn=r(nwn),
        emis=np.full(nwn, 0.95), refl=np.full(nwn, 0.05),
        otot=r(nwn), by_mol=r(nwn, nmol),
        oc={k: 1e-3 * r(nwn) for k in ("h2o", "co2", "o3", "o2", "n2",
                                       "rayleigh")},
        odx=None, od_layers=r(nwn, nlay))


@pytest.mark.parametrize("wn0", [0.3, 150.0])
def test_output_writer_bytes_equal(wn0, rundir, tmp_path):
    """One ProfileOutput through both writers: MONORTM.OUT (GHz and cm-1
    columns) and the IOD=1 layer files."""
    prof = profin.read_profiles(rundir / "MONORTM_PROF.IN")[0]
    nwn, nlay = 6, prof.state.t.shape[-1]
    wn = wn0 + 0.37 * np.arange(nwn)
    outs = [_profile_output(m, np.random.default_rng(7), nwn,
                            prof.meta.nmol, nlay) for m in (output, j_output)]
    for mod, po, name in ((output, outs[0], "mine"),
                          (j_output, outs[1], "ref")):
        (tmp_path / name).mkdir()
        with mod.OutputWriter(tmp_path / name / "MONORTM.OUT") as w:
            for npr in (1, 2):
                w.write_profile(npr, wn, po, prof.state, prof.meta, 0.65,
                                0.03, 288.2, 0.0)
            w.write_layer_ods(2, wn, po.od_layers, tmp_path / name)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "mine").iterdir())
    assert len(names) == 1 + nlay
    for n in names:
        assert (tmp_path / "mine" / n).read_bytes() == \
            (tmp_path / "ref" / n).read_bytes(), n


@pytest.mark.parametrize("icntnm", range(7))
def test_from_icntnm_equal(icntnm):
    vals = (0.5, 1.0, 0.25, 1.0, 0.75, 1.0, 0.0) if icntnm == 6 else None
    a = ContinuumFactors.from_icntnm(icntnm, vals)
    b = JFactors.from_icntnm(icntnm, vals)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    with pytest.raises(ValueError):
        ContinuumFactors.from_icntnm(7)


@pytest.mark.parametrize("irt", [1, 2, 3])
def test_combine_boundary_np_equal(irt):
    rng = np.random.default_rng(irt)
    wn = np.linspace(0.3, 55.0, 64)
    rup, rdn, radtmr = (1e-11 * rng.uniform(0.1, 1.0, (3, 64)).astype(
        np.float32) for _ in range(3))
    trtot = rng.uniform(0.5, 1.0, (3, 64)).astype(np.float32)
    tsfc = np.full((3, 1), 288.0, np.float32)
    emis_v, refl_v = np.full(64, 0.9), np.full(64, 0.1)
    a = combine_boundary_np(wn, rup, rdn, trtot, radtmr, tsfc, emis_v,
                            refl_v, irt, dtype=np.float32)
    b = j_combine(wn, rup, rdn, trtot, radtmr, tsfc, emis_v, refl_v, irt,
                  dtype=np.float32)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype == np.float32
    with pytest.raises(ValueError):
        combine_boundary_np(wn, rup, rdn, trtot, radtmr, tsfc, emis_v,
                            refl_v, 4)


@pytest.mark.parametrize("case", ["case1", "user"])
def test_atmpth_equal(case, monkeypatch):
    rest, v1, v2 = ((CASE1_REST, 0.2, 1.2) if case == "case1"
                    else (USER_REST, 0.5, 1.0))
    # the default paths, each package's native helper: equal
    assert j_native.available()
    _same_profile(atmpth(rest, v1, v2), j_atmpth(rest, v1, v2))
    # both helpers off, the Python walks: equal
    monkeypatch.setenv("MONORTM_TPU_TORCH_NATIVE", "0")
    monkeypatch.setattr(j_native, "_LIB", False)
    _same_profile(atmpth(rest, v1, v2), j_atmpth(rest, v1, v2))


def test_boundary_spectrum_and_cloud_file_equal(tmp_path):
    wn = np.linspace(1.0, 3.0, 9)
    for coeffs in ((0.9, 0.0, 0.0), (0.5, 0.01, -0.001)):
        np.testing.assert_array_equal(emis.boundary_spectrum(wn, coeffs),
                                      j_emis.boundary_spectrum(wn, coeffs))
    spec = tmp_path / "EMISSION"
    spec.write_text(f"{0.5:10.3E}{4.0:10.3E}{0.25:10.3E}     {15:5d}\n"
                    + "".join(f"{0.9 - 0.01 * k:15.7E}\n" for k in range(15)))
    np.testing.assert_array_equal(
        emis.boundary_spectrum(wn, (-1.0, 0.0, 0.0), spec),
        j_emis.boundary_spectrum(wn, (-1.0, 0.0, 0.0), spec))
    cld = tmp_path / "in_lblrtm_cld"
    cld.write_text("3\n0.5 2.0 3.5\n2\n1 900.0\n0.1 0.2 0.3\n"
                   "2 800.0\n0.05 0.0 0.01\n")
    np.testing.assert_array_equal(cldod.cloud_od_on_grid(cld, wn, 2),
                                  j_cldod.cloud_od_on_grid(cld, wn, 2))


def test_fscdxs_index_equal(tmp_path):
    text = "\n".join([
        " hdr", " hdr2",
        f"{'CCL4':<10s}{780.0:10.4f}{820.0:10.4f}{0.1:10.8f}{2:5d}"
        + " " * 5 + f"{91:5d}N" + " " * 4 + f"{'CCL4_T1':<10s}"
        + f"{'CCL4_T2':<10s}",
        f"{'F11':<10s}{700.0:10.4f}{900.0:10.4f}{0.1:10.8f}{1:5d}"
        + " " * 5 + f"{91:5d}N" + " " * 4 + f"{'F11_T1':<10s}",
        "%"]) + "\n"
    (tmp_path / "FSCDXS").write_text(text)
    a = fscdxs.read_fscdxs(tmp_path / "FSCDXS", ["CCL4", "CFCL3"], 790, 810)
    b = j_fscdxs.read_fscdxs(tmp_path / "FSCDXS", ["CCL4", "CFCL3"], 790,
                             810)
    assert (a.names, a.indices) == (b.names, b.indices)
    assert {k: [dataclasses.astuple(r) for r in v]
            for k, v in a.regions.items()} == \
        {k: [dataclasses.astuple(r) for r in v] for k, v in b.regions.items()}
