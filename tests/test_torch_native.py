"""The port's native host helper (`monortm_tpu_torch.native`).

It is built here with g++ from the port's own copy of the C++ source.
On the inputs of tests/test_native_parity.py (the model atmosphere 6 path
engine, the plain, tolerance-edge and dense `zbnd` lists, the synthetic
TAPE3 rows with and without the -5 coupling quirk):

- each of its four functions is bitwise equal to the JAX package's loaded
  library (`monortm_tpu.native`);
- against the port's Python walks, its oracle: AMERGE bitwise,
  group + resolve field by field, the path sums (RFPATH, and ALAYER
  interval by interval) within rtol 1e-12, as the native walk sums in
  another order;
- MONORTM_TPU_TORCH_NATIVE=0 takes the Python walks, and a missing or
  failing compiler raises naming it: there is no silent fallback.
"""

import ctypes
import math

import numpy as np
import pytest

from monortm_tpu import native as j_native
from monortm_tpu.atmos import layering as j_lay
from monortm_tpu_torch import lines, native
from monortm_tpu_torch.atmos import layering as lay
from monortm_tpu_torch.atmos.tape5_atm import atmpth
from monortm_tpu_torch.io.tape3 import RawLines, write_tape3
from tests.test_lines import synthetic_raw
from tests.test_torch_io import CASE1_REST

ZBND = [
    # plain boundaries between model levels
    [0.0, 0.7, 1.4, 2.1, 5.0, 12.0, 20.0],
    # within 5e-4 km of model levels (1, 2, 25 km): the snap cascade
    [0.0, 0.99995, 2.00004, 3.0003, 24.99961, 25.0, 30.0],
    # denser than the model levels near the surface
    [0.0, 0.1, 0.2, 0.3, 0.5, 1.0, 1.00049, 2.0, 10.0],
]
AMERGE = ("zpth", "pp", "tp", "rf", "denp", "zout", "iphmid", "h1", "h2",
          "hmid")


@pytest.fixture(scope="module")
def engines():
    """The port's and the JAX package's path engines on model 6."""
    return (lay.PathEngine(lay.load_model_atmosphere(6, 7), 0.7, 6371.23, 7),
            j_lay.PathEngine(j_lay.load_model_atmosphere(6, 7), 0.7,
                             6371.23, 7))


@pytest.fixture
def python_walk(monkeypatch):
    """The port's Python walks (the helper switched off)."""
    monkeypatch.setenv(native.SWITCH, "0")


def _equal(a, b, names):
    assert len(a) == len(b)
    for name, x, y in zip(names, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def _port_raw(raw):
    return RawLines(**{f: getattr(raw, f)
                       for f in RawLines.__dataclass_fields__})


def test_builds_from_its_own_source(tmp_path, monkeypatch):
    """The library is compiled from the port's copy of the source into
    the build directory, under a name keyed by the source and flags, and
    exports the four entry points; the JAX package's library is another
    file."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    path = native.build()
    assert path.parent == tmp_path and path.exists()
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parents[1].name == "monortm_tpu_torch"
    assert path.name.startswith("monortm_native-")
    assert native.CXX == "g++" and "-ffast-math" not in native.CXX_FLAGS
    lib = ctypes.CDLL(str(path))
    for name in ("group_resolve_lines", "alayer_integrate",
                 "rfpath_integrate", "amerge_walk"):
        assert hasattr(lib, name), name
    assert native.build() == path          # built once
    assert native.lib_path() != j_native._DIR / "libmonortm_native.so"


@pytest.mark.parametrize("zbnd", ZBND)
def test_amerge_matches_jax_and_python_walk(engines, monkeypatch, zbnd):
    mine, ref = engines
    h1, h2 = zbnd[0], zbnd[-1]
    args = (h1, h2, min(h1, h2), 0, np.asarray(zbnd))
    assert j_native.available()
    nat = mine.amerge(*args)
    _equal(nat, ref.amerge(*args), AMERGE)
    monkeypatch.setenv(native.SWITCH, "0")
    _equal(nat, mine.amerge(*args), AMERGE)


def test_amerge_walk_tolerance_edges(engines):
    """Both sides of the snap threshold, called directly: a boundary 2
    tol from a model level keeps both points, one inside tol absorbs the
    model level (lblatm.f90:5200-5210)."""
    prof = engines[0].prof
    tol = 5.0e-4
    b1, b2 = 1.0 + 2.0 * tol, 2.0 + 0.999 * tol
    zout = np.asarray([0.0, b1, b2, 20.0])
    args = (prof.zmdl, prof.pm, prof.tm, prof.rfndxm, zout, 0.0, 0.0, tol)
    res = native.amerge_walk(*args)
    _equal(res, j_native.amerge_walk(*args), ("zpth", "pp", "tp", "rf",
                                              "src_im", "src_jm", "src_a",
                                              "iphmid", "hmid"))
    zpth = res[0].tolist()
    assert 1.0 in zpth and b1 in zpth and b2 in zpth and 2.0 not in zpth


@pytest.mark.parametrize("with_minus5", [False, True])
def test_group_resolve_matches_jax_and_python(with_minus5):
    raw = _port_raw(synthetic_raw(with_minus5=with_minus5))
    nat = native.group_resolve_lines(raw)
    ref = j_native.group_resolve_lines(synthetic_raw(with_minus5))
    py = lines.resolve(lines.group(raw))
    assert isinstance(nat, lines.ResolvedLines) and len(nat.nu0) > 0
    for f in lines.ResolvedLines.__dataclass_fields__:
        a = np.asarray(getattr(nat, f))
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(a, np.asarray(getattr(py, f)),
                                      err_msg=f)
        assert a.dtype == np.asarray(getattr(py, f)).dtype, f


def _rfpath(engine, zbnd, angle):
    return engine.rfpath(zbnd[0], zbnd[-1], angle, 0.0, 0, zbnd[0], 1,
                         np.asarray(zbnd))


@pytest.mark.parametrize("angle", [0.0, 60.0])
@pytest.mark.parametrize("zbnd", ZBND)
def test_rfpath_matches_jax_and_python_walk(engines, monkeypatch, zbnd,
                                            angle):
    mine, ref = engines
    nat, want = _rfpath(mine, zbnd, angle), _rfpath(ref, zbnd, angle)
    monkeypatch.setenv(native.SWITCH, "0")
    py = _rfpath(mine, zbnd, angle)
    assert nat.keys() == want.keys() == py.keys()
    for k, v in nat.items():
        vals = v.items() if k == "sums" else [(k, v)]
        for name, x in vals:
            x = np.asarray(x)
            y = np.asarray(want[k][name] if k == "sums" else want[k])
            z = np.asarray(py[k][name] if k == "sums" else py[k])
            np.testing.assert_array_equal(x, y, err_msg=name)
            np.testing.assert_allclose(x, z, rtol=1e-12, atol=0,
                                       err_msg=name)
    assert nat["sums"]["amtp"][:7].max() > 0


def test_alayer_integrate_matches_jax_and_python(engines):
    """ALAYER interval by interval along a 60-degree path: the port's
    library bitwise the JAX package's, and within rtol 1e-12 of the
    port's Python ALAYER."""
    mine = engines[0]
    zbnd = ZBND[1]
    zpth, pp, tp, rfndxp, denp, _, _, _, _, _ = mine.amerge(
        zbnd[0], zbnd[-1], zbnd[0], 0, np.asarray(zbnd))
    r = mine.refr
    sh, gamma = r.findsh(zbnd[0])
    cpath = (mine.re + zbnd[0]) * r.andex(zbnd[0], sh, gamma) * \
        math.sin(60.0 / lay.DEG)
    n = len(zpth) - 1
    sums = [{"ppsum": np.zeros(n), "tpsum": np.zeros(n),
             "rhopsm": np.zeros(n), "amtp": np.zeros((lay.MXMOL, n))}
            for _ in range(3)]
    angles = [(math.cos(30.0 / lay.DEG), -math.sin(30.0 / lay.DEG))] * 3
    for j in range(n):
        sh, gamma = r.scalht(zpth[j], zpth[j + 1], rfndxp[j], rfndxp[j + 1])
        common = (zpth[j], zpth[j + 1], pp[j], pp[j + 1], tp[j], tp[j + 1],
                  denp[:, j], denp[:, j + 1], mine.nmol)
        tail = (cpath, sh, gamma, mine.re, lay.DELTAS, lay.GCAIR, 1)
        a = native.alayer_integrate(*common, *angles[0], *tail, sums[0], j)
        b = j_native.alayer_integrate(*common, *angles[1], *tail, sums[1],
                                      j)
        c = mine.alayer(j, *angles[2], cpath, sh, gamma, 1, zpth, pp, tp,
                        denp, sums[2])
        assert a == b, j
        np.testing.assert_allclose(a, c, rtol=1e-12, atol=1e-15)
        angles = [x[:2] for x in (a, b, c)]
    for k in ("ppsum", "tpsum", "rhopsm", "amtp"):
        np.testing.assert_array_equal(sums[0][k], sums[1][k], err_msg=k)
        np.testing.assert_allclose(sums[0][k], sums[2][k], rtol=1e-12,
                                   atol=0, err_msg=k)
    assert sums[0]["amtp"][:7].max() > 0


def test_switch_takes_the_python_walks(monkeypatch, tmp_path):
    """By default the layering and the catalog loader call the helper;
    with MONORTM_TPU_TORCH_NATIVE=0 they never do."""
    calls = []
    for name in ("amerge_walk", "rfpath_integrate", "group_resolve_lines"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _f=real, _n=name:
                            calls.append(_n) or _f(*a))
    write_tape3(tmp_path / "TAPE3", _port_raw(synthetic_raw(False)))
    nat_prof = atmpth(CASE1_REST, 0.2, 1.2)
    nat_cat = lines.load_catalog(tmp_path / "TAPE3", 0.0, 200.0)
    assert {"amerge_walk", "rfpath_integrate",
            "group_resolve_lines"} <= set(calls)
    calls.clear()
    monkeypatch.setenv(native.SWITCH, "0")
    py_prof = atmpth(CASE1_REST, 0.2, 1.2)
    py_cat = lines.load_catalog(tmp_path / "TAPE3", 0.0, 200.0)
    assert not calls
    np.testing.assert_allclose(py_prof.state.wkl, nat_prof.state.wkl,
                               rtol=1e-12, atol=0)
    for f in lines.PackedCatalog.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(py_cat, f),
                                      getattr(nat_cat, f), err_msg=f)


def test_missing_or_failing_compiler_raises(tmp_path, monkeypatch):
    """No library is built yet: without the compiler the helper raises
    naming it and the switch; a source it fails on raises naming it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "CXX", "g++-not-installed")
    with pytest.raises(RuntimeError, match="g\\+\\+-not-installed.*"
                       "MONORTM_TPU_TORCH_NATIVE=0"):
        native.amerge_walk(np.zeros(2), np.ones(2), np.ones(2), np.zeros(2),
                           np.zeros(2), 0.0, 0.0, 5e-4)
    with pytest.raises(RuntimeError, match="g\\+\\+-not-installed"):
        atmpth(CASE1_REST, 0.2, 1.2)
    monkeypatch.setattr(native, "CXX", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ bad.cpp failed"):
        native.build()
    assert not list(tmp_path.glob("*.so"))
