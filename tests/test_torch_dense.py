"""The port's dense line engine and float64 runs against the JAX package's.

- `ops.lineshape.line_od_block` against `monortm_tpu.ops.lineshape.
  line_od_block` on the same catalog and layers, IBRD 0 and 1: in float64
  at rtol=1e-10, atol=1e-14; in float32 at rtol=2e-5, atol=2e-6*max|ref|
  (tests/test_pallas.py's tolerance);
- the same block against the independent LINES oracle
  `tests/reference_lines.py::lines_ref`, at tests/test_lines.py's own
  rtol=2e-7, atol=1e-14 in float64 and at rtol=2e-5, atol=2e-6*max|ref|
  in float32;
- `ODModel(engine="dense")` against the JAX `ODModel(use_pallas=False)`,
  batched profiles on a grid that is no multiple of the wavenumber tile,
  with several line tiles and candidate lists: float64 at rtol=1e-10,
  atol=1e-14 * max|ref|; float32 at rtol=2e-5, atol=2e-6*max|ref|;
- a profile's dense line OD is bitwise the same whatever the number of
  profiles computed with it (the fixed-shape row blocks);
- the float64 `MonoRTM.tb` gradient by every float field of the state
  against `jax.grad` of the JAX float64 model: rtol=1e-8, atol=1e-12 *
  max|ref| (two reverse-mode float64 adjoints of the same forward);
- a kernel engine asked of a float64 model raises ValueError naming the
  dtype;
- a float32 model builds the dense tiles only when the dense engine
  first runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.io.tape3 import read_tape3 as j_read_tape3
from monortm_tpu.io.tape3 import write_tape3 as j_write_tape3
from monortm_tpu.lines import group as j_group
from monortm_tpu.models.monortm import MonoRTM as JMonoRTM
from monortm_tpu.models.od import ODModel as JODModel
from monortm_tpu.ops import lineshape as jls
from monortm_tpu.ops.tips import tips_scor_numpy
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu.testing import synthetic_state as j_state
from monortm_tpu.types import LayerState as JLayerState
from monortm_tpu_torch.convert import state_from_numpy
from monortm_tpu_torch.io.tape3 import read_tape3
from monortm_tpu_torch.lines import group, pack, resolve
from monortm_tpu_torch.models import od as od_mod
from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.models.od import ODModel
from monortm_tpu_torch.ops import lineshape as pls
from monortm_tpu_torch.testing import synthetic_catalog_mw, synthetic_state
from monortm_tpu_torch.types import FIELDS
from tests.reference_lines import lines_ref
from tests.test_lines import synthetic_raw

torch.set_num_threads(1)

JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
NPDT = {torch.float64: np.float64, torch.float32: np.float32}
DTYPES = [torch.float64, torch.float32]
ODD_WN = np.linspace(0.3, 55.0, 150)       # 150 = 128 + 22 wavenumbers


def _close(got, want, dt):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    if dt == torch.float64:
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-14 * max(scale, 1.0))
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6 * scale)


@pytest.fixture(scope="module")
def tape3(tmp_path_factory):
    """ibrd -> (the JAX grouping, the port's packed catalog) of the JAX
    test_lines fixture's TAPE3 (IBRD=1: broadening data on the first H2O
    line), read back by each package."""
    out = {}
    for ibrd in (0, 1):
        raw = synthetic_raw()
        if ibrd:
            raw.brd_mol_flg[0, [0, 1, 6]] = 1
            raw.brd_mol_hw[0, [0, 1, 6]] = [0.45, 0.11, 0.05]
            raw.brd_mol_tmp[0, [0, 1, 6]] = [0.7, 0.6, 0.75]
            raw.brd_mol_shft[0, [0, 1, 6]] = [-0.012, 0.002, 0.001]
        path = tmp_path_factory.mktemp(f"ibrd{ibrd}") / "TAPE3"
        j_write_tape3(path, raw)
        out[ibrd] = (j_group(j_read_tape3(path, 0.1, 10.0)),
                     pack(resolve(group(read_tape3(path, 0.1, 10.0))),
                          tile=8))
    return out


WN_BLOCK = np.asarray([0.5, 0.741721, 1.0, 1.9168, 2.1, 3.0, 8.5])
LAYERS = np.asarray([(1013.0, 288.2), (550.0, 250.0), (120.0, 216.0)])


def _block_inputs(dt):
    wk = np.zeros((len(LAYERS), 39))
    wk[:, 0], wk[:, 1], wk[:, 6], wk[:, 21] = 5.0e21, 6.0e20, 4.0e23, 1.5e24
    wbrod = np.full(len(LAYERS), 2.0e22)
    scor = np.stack([tips_scor_numpy(t).reshape(-1) for _, t in LAYERS])
    cast = lambda a: np.asarray(a, NPDT[dt])
    return (cast(LAYERS[:, 0]), cast(LAYERS[:, 1]), cast(wk), cast(wbrod),
            cast(scor))


def _port_block(cat, ibrd, dt):
    dev = pls.catalog_to_device(pls.catalog_to_host(cat, dt), "cpu")
    p, t, wk, wb, sc = (torch.from_numpy(a) for a in _block_inputs(dt))
    if dt == torch.float64:
        wn, split = torch.from_numpy(WN_BLOCK), None
    else:
        hi = WN_BLOCK.astype(np.float32)
        lo = (WN_BLOCK - hi.astype(np.float64)).astype(np.float32)
        wn = torch.from_numpy(hi)
        split = (wn, torch.from_numpy(lo))
    return pls.line_od_block(dev, wn, split, p, t, wk, wb, sc,
                             pls.LineConfig(ibrd=ibrd), n_mol=39,
                             dtype=dt).numpy()


@pytest.mark.parametrize("ibrd", [0, 1])
@pytest.mark.parametrize("dt", DTYPES)
def test_line_od_block_matches_jax(tape3, dt, ibrd):
    from monortm_tpu.lines import pack as j_pack
    from monortm_tpu.lines import resolve as j_resolve
    g, cat = tape3[ibrd]
    jdev = jls.catalog_to_device(j_pack(j_resolve(g), tile=8), JDT[dt])
    p, t, wk, wb, sc = _block_inputs(dt)
    if dt == torch.float64:
        wn, split = jnp.asarray(WN_BLOCK), None
    else:
        hi = WN_BLOCK.astype(np.float32)
        lo = (WN_BLOCK - hi.astype(np.float64)).astype(np.float32)
        wn, split = jnp.asarray(hi), (jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(jls.line_od_block(
        jdev, wn, split, jnp.asarray(p), jnp.asarray(t), jnp.asarray(wk),
        jnp.asarray(wb), jnp.asarray(sc), jls.LineConfig(ibrd=ibrd),
        n_mol=39, dtype=JDT[dt]))
    got = _port_block(cat, ibrd, dt)
    assert got.shape == want.shape == (len(LAYERS), len(WN_BLOCK), 39)
    assert got.dtype == NPDT[dt]
    assert np.abs(want).max() > 0
    _close(got, want, dt)


@pytest.mark.parametrize("ibrd", [0, 1])
@pytest.mark.parametrize("dt", DTYPES)
def test_line_od_block_matches_oracle(tape3, dt, ibrd):
    g, cat = tape3[ibrd]
    got = _port_block(cat, ibrd, dt)
    p, t, wk, wb, _ = _block_inputs(torch.float64)
    for il, (pl, tl) in enumerate(LAYERS):
        want = np.stack([lines_ref(g, w, tl, pl, wk[il], wb[il],
                                   tips_scor_numpy(tl), ibrd=ibrd)
                         for w in WN_BLOCK])
        if dt == torch.float64:
            np.testing.assert_allclose(got[il], want, rtol=2e-7, atol=1e-14,
                                       err_msg=f"p={pl} t={tl}")
        else:
            _close(got[il], want, dt)
    if ibrd:   # the species-specific broadening changes the H2O OD
        got0 = _port_block(cat, 0, dt)
        assert not np.allclose(got[0, 1, 0], got0[0, 1, 0], rtol=1e-6,
                               atol=0.0)


def _host_state(dt, batch=3, nlay=5):
    st = j_state(nlay=nlay, batch=batch, seed=5)
    return JLayerState(**{f: np.asarray(getattr(st, f), NPDT[dt])
                          for f in FIELDS})


def _od_models(dt):
    kw = dict(dvset=float(ODD_WN[1] - ODD_WN[0]), nmol=22)
    # 64-line tiles: several windowed tiles, candidate lists per tile
    jm = JODModel(ODD_WN, catalog=j_catalog(n_h2o=150, n_o2=24, tile=128),
                  dtype=JDT[dt], use_pallas=False, line_tile=64, **kw)
    pm = ODModel(ODD_WN, catalog=synthetic_catalog_mw(n_h2o=150, n_o2=24,
                                                      tile=128),
                 device="cpu", dtype=dt, dense_line_tile=64, **kw)
    return jm, pm


@pytest.mark.parametrize("dt", DTYPES)
def test_dense_odmodel_matches_jax(dt):
    jm, pm = _od_models(dt)
    assert [len(c) for c in pm.dense["cand"]] == \
        np.asarray(jm.cand_mask).sum(axis=1).tolist()
    assert len(pm.dense["cand"]) == 2 and pm.dense["win"]["mol"].shape[0] > 2
    host = _host_state(dt)
    want = jax.jit(lambda s: jm(s))(jax.tree_util.tree_map(jnp.asarray,
                                                           host))
    got = pm(state_from_numpy(host, "cpu", dt), engine="dense")
    for f in ("od_total", "od_by_mol", "od_clw"):
        assert getattr(got, f).dtype == dt
        _close(getattr(got, f), getattr(want, f), dt)
    for sp in want.oc:
        _close(got.oc[sp], want.oc[sp], dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_dense_profile_bits_do_not_depend_on_the_batch(dt):
    wn = np.linspace(0.3, 55.0, 40)
    pm = ODModel(wn, float(wn[1] - wn[0]),
                 synthetic_catalog_mw(n_h2o=40, n_o2=12, tile=128), nmol=22,
                 device="cpu", dtype=dt, dense_line_tile=16)
    host = _host_state(dt, batch=3, nlay=22)   # 66 rows: two row blocks
    st = state_from_numpy(host, "cpu", dt)
    one = state_from_numpy(JLayerState(**{f: getattr(host, f)[2:]
                                          for f in FIELDS}), "cpu", dt)
    with torch.no_grad():
        full = pm(st, engine="dense").od_total
        alone = pm(one, engine="dense").od_total
    assert torch.equal(full[2:], alone)


def test_float64_tb_gradient_matches_jax():
    wn = np.linspace(0.3, 55.0, 40)
    kw = dict(dvset=float(wn[1] - wn[0]), nmol=22)
    jm = JMonoRTM(wn, catalog=j_catalog(n_h2o=40, n_o2=12, tile=128),
                  dtype=jnp.float64, use_pallas=False, **kw)
    pm = MonoRTM(wn, catalog=synthetic_catalog_mw(n_h2o=40, n_o2=12,
                                                  tile=128),
                 device="cpu", dtype=torch.float64, **kw)
    host = _host_state(torch.float64, batch=2, nlay=4)
    emis = np.full(len(wn), 0.9)
    tsfc = np.full((2, 1), 288.0)

    def jloss(s):
        tb = jm.tb(s, jnp.asarray(tsfc), jnp.asarray(emis),
                   jnp.asarray(1.0 - emis), irt=1)
        return jnp.sum(tb * jnp.linspace(0.5, 1.5, tb.size).reshape(
            tb.shape))

    want = jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.asarray,
                                                           host))
    leaves = state_from_numpy(host, "cpu", torch.float64)
    for f in FIELDS:
        getattr(leaves, f).requires_grad_()
    tb = pm.tb(leaves, torch.from_numpy(tsfc), torch.from_numpy(emis),
               torch.from_numpy(1.0 - emis), irt=1)
    w = torch.linspace(0.5, 1.5, tb.numel(), dtype=torch.float64)
    torch.sum(tb * w.reshape(tb.shape)).backward()
    for f in ("p", "t", "tz", "wkl", "wbrodl", "clw"):
        g = getattr(leaves, f).grad.numpy()
        ref = np.asarray(getattr(want, f))
        assert np.isfinite(g).all() and np.abs(ref).max() > 0, f
        np.testing.assert_allclose(g, ref, rtol=1e-8,
                                   atol=1e-12 * np.abs(ref).max(),
                                   err_msg=f)


@pytest.mark.parametrize("engine", ["full", "lorentz", "hybrid"])
def test_kernel_engine_at_float64_raises(engine):
    pm = MonoRTM(ODD_WN, 0.5, synthetic_catalog_mw(n_h2o=8, n_o2=4),
                 nmol=22, device="cpu", dtype=torch.float64)
    assert pm.engine_split(synthetic_state(nlay=3, device="cpu")) == \
        ("dense", ())
    st = synthetic_state(nlay=3, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        pm.od_model(st, engine=engine, lor_layers=(0,))


def test_dense_tiles_are_built_on_first_use():
    """A float32 model that runs the kernels' engine never builds the
    dense tiles; its first dense call does, at the module's tile sizes."""
    wn = np.linspace(0.3, 55.0, 40)
    pm = ODModel(wn, float(wn[1] - wn[0]),
                 synthetic_catalog_mw(n_h2o=40, n_o2=12, tile=128), nmol=22,
                 device="cpu")
    st = synthetic_state(nlay=3, device="cpu")
    with torch.no_grad():
        pm(st, engine="full")
        assert pm._dense is None
        pm(st, engine="dense")
    assert pm.dense["wt"] == min(od_mod.DENSE_WN_TILE, len(wn))
    assert pm.dense["win"]["mol"].shape[1] <= od_mod.DENSE_LINE_TILE
