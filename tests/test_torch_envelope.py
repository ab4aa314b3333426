"""The reference's capacity envelope in the port, at CPU sizes.

- `monortm_tpu_torch.envelope`'s inputs are those of the JAX package's
  tools/bench_envelope_e2e.py: the same MONORTM.IN text, profile and
  catalog lines.
- The envelope path at a small size (6 layers of the same profile
  recipe, 3000 lines, a 2000-point uniform grid over the same band,
  written by the module's own input writer) through the port's CPU
  pipeline (`run_envelope`) and through
  `monortm_tpu.pipeline.run(engine="hybrid", dtype=float32, mesh=None)`:
  Tb, radiance, TMR and the layer-summed OD at
  tests/test_torch_pipeline.py's rtol 5e-5 / atol 1e-4 K, and
  MONORTM.OUT of the same shape.
- At the JAX capacity check's size (250k lines x 8192 wn,
  tests/test_pallas.py::test_pallas_capacity_250k_lines_8k_wn, packed to
  the pipeline's tile of 256), the port's `build_plan` gives the JAX
  `ODModel(use_pallas=True)` plans (unsegmented) array for array, with
  fewer candidate columns than a fifth of the line tiles.  Plans only.
- The retrieval adjoint at the small envelope (`envelope.envelope_grad`:
  value and gradient of mean((tb - tb_obs)^2) through `MonoRTM.tb`, the
  plain adjoints on the CPU, the hybrid engine split) against
  `jax.value_and_grad` of the same loss through the JAX `MonoRTM.tb` on
  the same files, built by the JAX package's own readers, as
  tests/test_torch_adjoint_tb.py runs it: engine "hybrid", the Pallas
  kernel and its custom VJP in interpret mode on the all-Lorentz
  predicate's layers.  The catalog's speed dependence is off on both
  sides: the top layers reach 0.05 hPa, where the JAX SD-Voigt vjp is NaN
  (tests/test_torch_adjoint.py).  Loss and the gradients by p, t, tz and
  clw at rtol 1e-4, atol 1e-6 (test_torch_adjoint_tb.py's); by wkl at atol
  1e-3 x max and not by wbrodl: JAX's float32 vjp drops the path through
  the total column (tests/test_torch_adjoint.py).
- The kernels' wrapper: `row_blocks` covers any row count in order in
  blocks of at most 65535 rows, and `launch` / `launch_bwd` call the
  entry point once per block with every per-row pointer offset to the
  block's first row (a recording stand-in for the library on CPU
  tensors).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monortm_tpu.io.profin import read_profiles as j_read_profiles
from monortm_tpu.io.tape3 import RawLines as JRawLines
from monortm_tpu.io.tape5 import Tape5Reader as JTape5Reader
from monortm_tpu.lines import load_catalog as j_load_catalog
from monortm_tpu.lines import group as j_group
from monortm_tpu.lines import pack as j_pack
from monortm_tpu.lines import resolve as j_resolve
from monortm_tpu.models.monortm import MonoRTM as JMonoRTM
from monortm_tpu.models.od import ODModel as JODModel
from monortm_tpu.ops.lineshape import LineConfig as JLineConfig
from monortm_tpu.pipeline import run as j_run
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu_torch import envelope, pipeline
from monortm_tpu_torch.models.od import build_plan
from monortm_tpu_torch.ops import linesum_kernel as lk
from monortm_tpu_torch.ops.lineshape import catalog_to_host
from monortm_tpu_torch.ops.linesum import VOIGT_KERNEL
from monortm_tpu_torch.ops.linesum_lorentz import LORENTZ_KERNEL
from monortm_tpu_torch.testing import CAPACITY_TILE, capacity_catalog
from monortm_tpu_torch.types import FIELDS
from tests.test_torch_pipeline import ATOL, RTOL

TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_envelope_e2e.py"
SMALL = dict(nlay=6, lines=3000, nwn=2000)


def _tool():
    spec = importlib.util.spec_from_file_location("bench_envelope_e2e", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_envelope_inputs_match_tool():
    tool = _tool()
    assert envelope.tape5_text() == tool.TAPE5
    for nlay in (200, SMALL["nlay"]):
        a, b = envelope.make_profile(nlay), tool.make_profile(nlay)
        for f in ("p", "t", "tz", "wkl", "wbrodl", "clw"):
            np.testing.assert_array_equal(getattr(a.state, f),
                                          getattr(b.state, f), err_msg=f)
        for f in ("nmol", "angle", "h1", "h2"):
            assert getattr(a.meta, f) == getattr(b.meta, f), f
        for f in ("altz", "pz"):
            np.testing.assert_array_equal(getattr(a.meta, f),
                                          getattr(b.meta, f), err_msg=f)
        assert a.hmod == b.hmod
    # the tool's catalog split: two thirds H2O, one third O2
    n = SMALL["lines"]
    raw, ref = envelope.catalog_raw(n), j_catalog(
        n_h2o=n * 2 // 3, n_o2=n - n * 2 // 3, raw_lines=True)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(raw, f.name),
                                      getattr(ref, f.name), err_msg=f.name)


@pytest.fixture(scope="module")
def small_envelope(tmp_path_factory):
    d = tmp_path_factory.mktemp("envelope")
    files = envelope.write_inputs(d, **SMALL)
    mine = envelope.run_envelope(d / "port", **SMALL, device="cpu",
                                 files=files, echo=lambda s: None)
    ref = j_run(**files, outdir=d / "jax", mesh=None, engine="hybrid",
                dtype=jnp.float32)
    return d, mine, ref


def test_small_envelope_matches_jax_pipeline(small_envelope):
    _, mine, ref = small_envelope
    res = mine["result"]
    assert len(res.wn) == SMALL["nwn"]
    np.testing.assert_array_equal(res.wn, ref.wn)
    # both line-sum engines took part (the hybrid split)
    (n, eng, lor), = res.engines
    assert eng == "hybrid" and 0 < len(lor) < SMALL["nlay"]
    assert mine["tb_finite"] and mine["host_pull_bytes"] > 0
    for a, b in zip(res.results, ref.results):
        for f in ("tb", "rad", "tmr"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                       np.asarray(getattr(b, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)


def test_small_envelope_writes_monortm_out_like_jax(small_envelope):
    """MONORTM.OUT has the JAX run's rows and columns, one row per
    wavenumber, with the same wavenumber column; the layer-summed total
    OD it prints agrees at the same tolerance (its printed tokens carry 5
    digits, so they are not compared one by one)."""
    d, mine, ref = small_envelope
    la = (d / "port" / "MONORTM.OUT").read_text().splitlines()
    lb = (d / "jax" / "MONORTM.OUT").read_text().splitlines()
    assert len(la) == len(lb) > SMALL["nwn"]
    assert [len(x.split()) for x in la] == [len(x.split()) for x in lb]
    rows = [(a.split(), b.split()) for a, b in zip(la, lb)
            if a.split()[:1] == ["1"]]
    assert len(rows) == SMALL["nwn"]
    assert all(a[1] == b[1] for a, b in rows)
    for a, b in zip(mine["result"].results, ref.results):
        np.testing.assert_allclose(np.asarray(a.otot), np.asarray(b.otot),
                                   rtol=RTOL, atol=ATOL)


def _without_sd(cat):
    return dataclasses.replace(cat, sdep=np.zeros_like(cat.sdep))


def _jax_value_and_grad(files, lor):
    """jax.value_and_grad of envelope_grad's loss through the JAX
    MonoRTM.tb (engine "hybrid", Pallas in interpret mode) on the
    envelope's files without speed dependence; asserts that its
    all-Lorentz predicate picks the layers `lor`."""
    import jax

    prof = j_read_profiles(files["fileprof"])[0]
    cfg = JTape5Reader(files["filein"]).read_block()
    cat = _without_sd(j_load_catalog(files["hfile"], float(cfg.wn[0]),
                                     float(cfg.wn[-1]),
                                     tile=pipeline.LINE_TILE))
    jm = JMonoRTM(cfg.wn, cfg.dvset, cat, nmol=prof.meta.nmol,
                  line_cfg=JLineConfig(ibrd=cfg.ibrd), dtype=jnp.float32,
                  use_pallas=True, pallas_wn_tile=pipeline.WN_TILE,
                  pallas_line_tile=pipeline.LINE_TILE)
    st = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32),
                                prof.state)
    rows = np.asarray(jm.od_model.all_lorentz(st, per_layer=True))
    assert tuple(np.nonzero(rows)[0].tolist()) == tuple(lor)
    emis = jnp.full(len(cfg.wn), 0.95, jnp.float32)
    tb_of = lambda s: jm.tb(s, jnp.float32(288.0), emis, 1.0 - emis, irt=3,
                            engine="hybrid", lor_layers=tuple(lor))
    obs = tb_of(dataclasses.replace(st, t=st.t + 1.0, tz=st.tz + 1.0))

    def loss(*fields):
        s = dataclasses.replace(st, **dict(zip(FIELDS, fields)))
        return jnp.mean((tb_of(s) - obs) ** 2)

    value, grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(FIELDS)))))(
            *(getattr(st, f) for f in FIELDS))
    return float(value), dict(zip(FIELDS, map(np.asarray, grads)))


def test_small_envelope_gradient_matches_jax(small_envelope, monkeypatch):
    from monortm_tpu_torch import lines

    d, _, _ = small_envelope
    files = dict(filein=d / "MONORTM.IN", fileprof=d / "MONORTM_PROF.IN",
                 hfile=d / "TAPE3")
    load = lines.load_catalog
    monkeypatch.setattr(lines, "load_catalog",
                        lambda *a, **k: _without_sd(load(*a, **k)))
    model, state, _ = envelope.build_model(files, "cpu")
    mine = envelope.envelope_grad(model, state, echo=lambda s: None)
    assert mine["engine"] == "hybrid" and mine["grads_ok"]
    assert 0 < len(mine["lor_layers"]) < SMALL["nlay"]
    value, want = _jax_value_and_grad(files, mine["lor_layers"])
    np.testing.assert_allclose(mine["loss"], value, rtol=1e-4, atol=1e-6)
    got = {f: g.numpy() for f, g in mine["grads"].items()}
    for f in ("p", "t", "tz", "clw"):
        assert np.abs(want[f]).max() > 0, f
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(got["wkl"], want["wkl"], rtol=1e-4,
                               atol=1e-3 * np.abs(want["wkl"]).max())


def test_capacity_plans_match_jax():
    raw = capacity_catalog(raw_lines=True)
    cat = capacity_catalog()
    j_raw = JRawLines(**{f.name: getattr(raw, f.name)
                         for f in dataclasses.fields(raw)})
    j_cat = j_pack(j_resolve(j_group(j_raw)), tile=CAPACITY_TILE)
    wn = np.linspace(0.3, 55.0, 8192)
    jm = JODModel(wn, dvset=float(wn[1] - wn[0]), catalog=j_cat, nmol=22,
                  dtype=jnp.float32, use_pallas=True)
    host = catalog_to_host(cat, torch.float32)
    for (nt, wt), ref in (((256, 128), {"cand_map": jm.pallas_cand_map,
                                        "cand_valid": jm.pallas_cand_valid,
                                        "wn_hi": jm.pallas_wn_hi,
                                        "wn_lo": jm.pallas_wn_lo}),
                          ((128, 128), jm._plan_lorentz)):
        plan = build_plan(cat, host, wn, nt=nt, wt=wt)
        for k in ("cand_map", "cand_valid", "wn_hi", "wn_lo"):
            np.testing.assert_array_equal(plan[k], np.asarray(ref[k]),
                                          err_msg=f"{nt}/{wt} {k}")
        n_tiles = len(plan["cat"]["mol"]) // nt
        assert plan["cand_map"].shape[1] < n_tiles / 5, \
            (plan["cand_map"].shape, n_tiles)


def test_max_batch_at_the_envelope():
    """`_max_batch`'s per-profile estimate at the envelope (1.236e10
    bytes; 1.56x the 7.358 GiB peak read on an H100 by chip_smoke.py
    phase 14) caps a chunk at 4 profiles of a 0.75 x 79.1 GB budget; a
    narrow band of 200-layer profiles still takes 1024 profiles, 204800
    flat rows, which the kernels' wrapper launches in four blocks."""
    budget = 0.75 * 79.1e9
    assert pipeline._profile_bytes(80000, 200, 7, 208896) == 12359475200
    assert pipeline._max_batch(80000, 200, 7, 208896, budget) == 4
    b = pipeline._max_batch(101, 200, 22, 512, budget)
    assert b == 1024 and len(lk.row_blocks(b * 200)) == 4


@pytest.mark.parametrize("n_rows", [0, 1, 65535, 65536, 131070, 204800])
def test_row_blocks_cover_in_order(n_rows):
    blocks = lk.row_blocks(n_rows)
    assert blocks[0][0] == 0 and blocks[-1][1] == n_rows
    assert all(b[0] == a[1] for a, b in zip(blocks, blocks[1:]))
    assert all(0 < r1 - r0 <= lk.MAX_GRID_ROWS for r0, r1 in blocks) \
        or blocks == [(0, 0)]
    assert len(blocks) == max(1, -(-n_rows // lk.MAX_GRID_ROWS))


# the pointer arguments of the entry points, by position (FWD_ARGTYPES and
# BWD_ARGTYPES): per-row operands, rows, per-line operands
_FWD = {"per_ln": range(12, 19), "rows": 19, "per_line": range(5, 12),
        "out": [24]}
_BWD = {"per_ln": range(13, 20), "rows": 21, "per_line": range(6, 13),
        "out": [20, *range(26, 34)]}


@pytest.mark.parametrize("voigt", [True, False], ids=["voigt", "lorentz"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_launch_offsets_rows_by_block(monkeypatch, direction, voigt):
    """More than 65535 flat rows: one call per `row_blocks` block, each
    per-row pointer (the seven operands; the output, or the cotangent g,
    the seven cotangents and the deferral words) at its block's first
    row, the per-line pointers unmoved, the launch counted per call."""
    calls = []
    monkeypatch.setattr(lk._Library, "fns", {
        direction: lambda *a: calls.append(a) or 0})
    monkeypatch.setattr(lk, "_stream", lambda dev: 0)
    k = VOIGT_KERNEL if voigt else LORENTZ_KERNEL
    monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(k, "bwd_launches", 0)
    L, n, wt, n_mol = 65600, 32, 32, 2
    gen = torch.Generator().manual_seed(0)
    pre = {key: torch.rand((L, n), generator=gen) for key in lk.PER_LN}
    pre.update({key: torch.rand(n, generator=gen) for key in lk.PER_L})
    pre["flags"] = {key: torch.zeros(n) for key in lk.FLAGS}
    pre["bits"] = lk.flag_bits(pre["flags"])
    pre["mol0"] = torch.zeros(n, dtype=torch.int32)
    mol = torch.ones(n, dtype=torch.int32)
    wn = torch.zeros(wt)
    maps = (torch.zeros((1, 1), dtype=torch.int32),) * 2
    if direction == "forward":
        got = k.launch(pre, mol, wn, wn, *maps, n, wt, n_mol)
        pos, row_bytes = _FWD, [wt * n_mol * 4]
        assert k.launches == 2
    else:
        g = torch.rand((L, wt, n_mol), generator=gen)
        got = k.launch_bwd(pre, mol, wn, wn, *maps, n, wt, n_mol, g)
        pos, row_bytes = _BWD, [wt * n_mol * 4] + [n * 4] * 8
        assert k.bwd_launches == 2
        if not voigt:       # no cotangent of ad or k3v, no deferral words
            pos = {**pos, "out": [20, 26, 27, 28, 31, 32]}
            row_bytes = row_bytes[:4] + row_bytes[6:8]
    assert [c[pos["rows"]] for c in calls] == [65535, 65]
    first, second = calls
    for i in pos["per_ln"]:
        assert second[i] - first[i] == 65535 * n * 4
    for i in pos["per_line"]:
        assert second[i] == first[i]
    for i, nb in zip(pos["out"], row_bytes):
        assert first[i] != 0 and second[i] - first[i] == 65535 * nb
    assert got is not None


def test_lane_counts_by_interval_match_lane_counts(small_envelope):
    """chip_smoke.py counts the envelope's lanes by interval (its whole
    plans would take lane_counts several minutes a kernel on the card);
    on the small envelope's plans, as rebuilt from its files, and with
    every layer at 0.02 hPa (SD-Voigt lanes in every row), the counts by
    lane class, by class of the branch trees and the SD-Voigt lanes of
    each (layer, line) are lane_counts' exactly."""
    import chip_smoke

    d, _, _ = small_envelope
    files = dict(filein=d / "MONORTM.IN", fileprof=d / "MONORTM_PROF.IN",
                 hfile=d / "TAPE3")
    model, state, _ = envelope.build_model(files, "cpu")
    _, lor = model.engine_split(state)
    voigt = [i for i in range(SMALL["nlay"]) if i not in set(lor)]
    vacuum = dataclasses.replace(state, p=torch.full_like(state.p, 0.02))
    cases = (("full", state, voigt), ("lorentz", state, list(lor)),
             ("full", vacuum, list(range(SMALL["nlay"]))))
    for engine, st, layers in cases:
        args = chip_smoke.operands(model, st, engine, layers)[:9]
        want = chip_smoke.lane_counts(*args, voigt=engine == "full")
        got = chip_smoke.lane_counts_by_interval(*args,
                                                 voigt=engine == "full",
                                                 rows_per_chunk=3)
        assert got[0] == want[0] and got[2] == want[2], (engine, got, want)
        assert torch.equal(got[1], want[1])
        assert want[0][0] > 0 and want[0][1] > 0
        if engine == "full":
            assert want[0][2] + want[0][3] > 0


def test_deferral_words_and_their_slot_limit(monkeypatch):
    """The adjoint's deferral word packs the first and last slot (+ 1) of
    a (layer, line)'s SD-Voigt lanes in 16 bits each (defer_mark in
    csrc/linesum_math.cuh), 0 for none: `deferral_span` decodes it, up to
    slot 65534, and `launch_bwd` refuses a reverse map of 65535 slots or
    more before it calls the library."""
    first = torch.tensor([0, 30, 31, 624, 65533])
    last = torch.tensor([0, 32, 31, 624, 65534])
    words = (((first + 1) << 16) | (last + 1)).to(torch.int32)
    words = torch.cat([torch.zeros(1, dtype=torch.int32), words])
    f, la = lk.deferral_span(words)
    assert f.tolist() == [-1] + first.tolist()
    assert la.tolist() == [-1] + last.tolist()
    monkeypatch.setattr(lk._Library, "fns", {
        "backward": lambda *a: pytest.fail("the library was called")})
    monkeypatch.setattr(lk, "_stream", lambda dev: 0)
    n, wt = 32, 32
    pre = {key: torch.zeros((1, n)) for key in lk.PER_LN}
    pre.update({key: torch.zeros(n) for key in lk.PER_L})
    pre["flags"] = {key: torch.zeros(n) for key in lk.FLAGS}
    pre["bits"] = lk.flag_bits(pre["flags"])
    pre["mol0"] = torch.zeros(n, dtype=torch.int32)
    rev = torch.zeros((1, lk.MAX_REV_SLOTS), dtype=torch.int32)
    with pytest.raises(ValueError, match="deferral word"):
        VOIGT_KERNEL.launch_bwd(pre, torch.ones(n, dtype=torch.int32),
                                torch.zeros(wt), torch.zeros(wt), rev, rev,
                                n, wt, 2, torch.zeros((1, wt, 2)))
