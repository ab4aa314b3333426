"""Cross-sections (IXSECT >= 1) in the port against the JAX package.

The FSCDXS index and xs/ spectra are synthetic, written as
tests/test_xsec.py writes them (`testing.write_xsec_data`: CCL4 and F11
over 780-820 cm^-1, at 216 and 296 K), since the reference's
cross-section data is not in this repository.

- `ops.xsec`'s `_radfn`, `convolve` and `xsec_od` are the JAX package's
  code (tests/test_torch_copies.py holds the bytes): on the same inputs
  their results are array-equal;
- `pipeline.run(device="cpu")` against the JAX pipeline (the Pallas
  kernel in interpret mode) on an IXSECT=1 rundir, IATM=0 (layer amounts
  from MONORTM_PROF.IN's cross-section blocks) and IATM=1 (record 3.7,
  the standard profiles), each with and without an in_lblrtm_cld file:
  results, the XSEC_OD column and every token of MONORTM.OUT at
  tests/test_torch_pipeline.py's tolerances (rtol 5e-5, atol 1e-4), the
  LOG's echo equal, and XSEC_OD non-zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from monortm_tpu.io import fscdxs as j_fscdxs
from monortm_tpu.ops import xsec as j_xsec
from monortm_tpu.pipeline import run as j_run
from monortm_tpu_torch.io import fscdxs
from monortm_tpu_torch.io.tape3 import write_tape3
from monortm_tpu_torch.ops import xsec
from monortm_tpu_torch.pipeline import run
from monortm_tpu_torch.testing import (make_xsec_rundir, write_xsec_data,
                                       xsec_tape3_lines)
from tests.test_torch_io import CASE1_REST, iatm1_tape5
from tests.test_torch_pipeline import (ATOL, RTOL, _files, _log_head,
                                       _same_results, _same_tokens)

# a TES cloud OD file (io/cldod.py) of 40 layers on three wavenumbers
CLOUD = "3\n790.0 800.0 810.0\n40\n" + "".join(
    f"{k + 1} {900.0 - 20.0 * k}\n{0.1 / (k + 1)} {0.2 / (k + 1)} 0.01\n"
    for k in range(40))


def test_radfn_equal():
    for v in (0.0, 1e-3, 0.5, 12.0, 790.0, 2500.0, 5e4):
        for xkt in (-1.0, 0.0, 1e-3, 0.2, 150.0, 210.0):
            assert xsec._radfn(v, xkt) == j_xsec._radfn(v, xkt), (v, xkt)


@pytest.mark.parametrize("pd,pave", [(200.0, 1000.0), (900.0, 300.0),
                                     (170.0 * 1013.0 / 760.0, 5.0)])
def test_convolve_equal(pd, pave):
    """Both branches: the Lorentz convolution (hwb / hwd > 0.1) and the
    interpolation of the stored values."""
    v1, v2, dv = 780.0, 820.0, 0.1
    vv = v1 + dv * np.arange(401)
    spec = np.exp(-((vv - 800.0) / 8.0) ** 2)
    wn = np.linspace(775.0, 825.0, 23)
    a = xsec.convolve(spec, v1, v2, dv, pd, 1e-4, 250.0, pave, wn)
    b = j_xsec.convolve(spec, v1, v2, dv, pd, 1e-4, 250.0, pave, wn)
    assert np.abs(b).max() > 0
    np.testing.assert_array_equal(a, b)


def test_xsec_od_equal(tmp_path):
    write_xsec_data(tmp_path)
    names = ["CCL4", "F11"]
    idx = fscdxs.read_fscdxs(tmp_path / "FSCDXS", names, 780.0, 820.0)
    j_idx = j_fscdxs.read_fscdxs(tmp_path / "FSCDXS", names, 780.0, 820.0)
    files = [f for regs in idx.regions.values() for r in regs
             for f in r.files]
    spectra = {f: fscdxs.read_xs_file(tmp_path / "xs" / f) for f in files}
    j_spectra = {f: j_fscdxs.read_xs_file(tmp_path / "xs" / f)
                 for f in files}
    wn = np.asarray([779.0, 785.5, 800.0, 806.25, 819.0, 830.0])
    p = np.asarray([1000.0, 300.0, 20.0])
    t = np.asarray([290.0, 230.0, 300.0])      # below, inside, above
    xamnt = np.asarray([[1.0e15, 5.0e14, 1.0e13], [2.0e15, 1.0e15, 3.0e13]])
    a = xsec.xsec_od(idx, spectra, wn, p, t, xamnt)
    b = j_xsec.xsec_od(j_idx, j_spectra, wn, p, t, xamnt)
    assert a.shape == (3, 6) and np.abs(b[:, 1:5]).min() > 0
    np.testing.assert_array_equal(a, b)


def _iatm1_xsec_rundir(d):
    """IATM=1, IXSECT=1 over 795-805 cm^-1 (6 wavenumbers): the US
    standard atmosphere 0-30 km with CCL4's standard profile (record 3.7,
    IPRFL=1), tests/test_atmos.py's test_xamnts_standard_profile."""
    d.mkdir(parents=True, exist_ok=True)
    write_xsec_data(d, ("CCL4",))
    write_tape3(d / "TAPE3", xsec_tape3_lines())
    rest = CASE1_REST[:3] + ["    1    1    0", "CCL4      "]
    (d / "MONORTM.IN").write_text(iatm1_tape5(v1=795.0, v2=805.0,
                                              dvset=2.0, rest=rest,
                                              ixsect=1))


@pytest.mark.parametrize("cloud", [False, True])
@pytest.mark.parametrize("iatm", [0, 1])
def test_xsec_pipeline_matches_jax(iatm, cloud, tmp_path):
    if iatm == 0:
        make_xsec_rundir(tmp_path, nprof=2, nlay=3, nwn=12)
    else:
        _iatm1_xsec_rundir(tmp_path)
    if cloud:
        (tmp_path / "in_lblrtm_cld").write_text(CLOUD)
    f = _files(tmp_path)
    if iatm == 1:
        del f["fileprof"]
    ref = j_run(**f, outdir=tmp_path / "jax", mesh=None, engine="hybrid",
                dtype=jnp.float32)
    mine = run(**f, outdir=tmp_path / "port", device="cpu")
    assert len(mine.results) == (2 if iatm == 0 else 1)
    _same_results(mine, ref)
    for a, b in zip(mine.results, ref.results):
        assert np.asarray(a.odx).min() > 0.0
        np.testing.assert_allclose(a.odx, b.odx, rtol=RTOL, atol=ATOL)
    out = tmp_path / "port" / "MONORTM.OUT"
    _same_tokens(out, tmp_path / "jax" / "MONORTM.OUT")
    rows = [s.split() for s in out.read_text().splitlines()
            if s.split() and s.split()[0] == "1"]
    assert rows and all(float(r[-1]) > 0.0 for r in rows)
    log = tmp_path / "port" / "MONORTM.LOG"
    assert _log_head(log) == _log_head(tmp_path / "jax" / "MONORTM.LOG")
    assert "xsec-prep" in log.read_text()
