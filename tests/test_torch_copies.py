"""The port's copies of the JAX package's jax-free host modules.

The port imports nothing of `monortm_tpu`; it carries its own copies of
the constants, the catalog packer (`lines`), `io.tape3.RawLines`, the
table loader and its `.npz` tables.  These tests hold each copy equal to
its original, and scan the port's sources for an import of the JAX
package.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest

from monortm_tpu import constants as j_constants
from monortm_tpu import lines as j_lines
from monortm_tpu.data import loader as j_loader
from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
from monortm_tpu_torch import constants, lines
from monortm_tpu_torch.data import loader
from monortm_tpu_torch.testing import synthetic_catalog_mw

ROOT = Path(__file__).resolve().parents[1]
TABLES = sorted((ROOT / "monortm_tpu" / "data" / "tables").glob("*.npz"))


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("table", [p.name for p in TABLES])
def test_tables_byte_identical(table):
    mine = ROOT / "monortm_tpu_torch" / "data" / "tables" / table
    assert _sha(mine) == _sha(ROOT / "monortm_tpu" / "data" / "tables" / table)


def test_table_sets_identical():
    mine = sorted(p.name for p in
                  (ROOT / "monortm_tpu_torch" / "data" / "tables").glob("*"))
    assert mine == [p.name for p in TABLES] and len(mine) == 4


def test_loader_reads_the_same_arrays():
    for fn in ("mt_ckd", "isotopes", "tips_tables"):
        a, b = getattr(loader, fn)(), getattr(j_loader, fn)()
        assert a.keys() == b.keys(), fn
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fn}.{k}")
    assert loader.MOLECULE_NAMES == j_loader.MOLECULE_NAMES
    assert loader.TABLE_DIR != j_loader.TABLE_DIR


def test_constants_equal():
    names = [n for n in vars(j_constants)
             if n.isupper() and isinstance(getattr(j_constants, n), float)]
    assert len(names) > 20
    for n in names:
        assert getattr(constants, n) == getattr(j_constants, n), n
    assert constants.grav_const(30.0) == j_constants.grav_const(30.0)


@pytest.mark.parametrize("kw", [dict(n_h2o=40, n_o2=12),
                                dict(n_h2o=64, n_o2=0, seed=3, tile=64)])
def test_catalog_equal_field_by_field(kw):
    mine, ref = synthetic_catalog_mw(**kw), j_catalog(**kw)
    assert isinstance(mine, lines.PackedCatalog)
    assert not isinstance(mine, j_lines.PackedCatalog)
    fields = [f.name for f in j_lines.PackedCatalog.__dataclass_fields__
              .values()]
    assert fields == list(lines.PackedCatalog.__dataclass_fields__)
    for f in fields:
        a, b = getattr(mine, f), getattr(ref, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f


def test_group_resolve_match_on_raw_lines():
    raw = j_catalog(n_h2o=30, n_o2=10, raw_lines=True)
    mine_raw = synthetic_catalog_mw(n_h2o=30, n_o2=10, raw_lines=True)
    a, b = lines.resolve(lines.group(mine_raw)), j_lines.resolve(
        j_lines.group(raw))
    for f in j_lines.ResolvedLines.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_native_source_byte_identical():
    """The port's native helper builds from a copy of the JAX package's
    C++ source, byte for byte."""
    assert _sha(ROOT / "monortm_tpu_torch" / "native" / "monortm_native.cpp") \
        == _sha(ROOT / "monortm_tpu" / "native" / "monortm_native.cpp")


def _code(path):
    """A module's text after its docstring, with the imports of its own
    package's modules pointed at monortm_tpu."""
    text = path.read_text()
    body = text[text.index('"""', 3) + 3:]
    return body.replace("monortm_tpu_torch", "monortm_tpu")


def test_xsec_code_byte_identical():
    """`ops/xsec.py`'s code is the JAX package's, byte for byte, but for
    the imports, which name the port's `constants` and `io.fscdxs`."""
    mine = ROOT / "monortm_tpu_torch" / "ops" / "xsec.py"
    ref = ROOT / "monortm_tpu" / "ops" / "xsec.py"
    assert _code(mine) == _code(ref)
    assert "from monortm_tpu_torch import constants" in mine.read_text()
    assert "from monortm_tpu_torch.io.fscdxs import" in mine.read_text()


_IMPORT = re.compile(r"^\s*(from|import)\s+monortm_tpu(\.|\s|$)", re.M)


_MESHES = [(2, 1, 300), (4, 2, 700), (2, 2, 40)]
# the default tiles keep the bare mesh ids
_TILED_MESHES = [pytest.param(wt, lt, *m, id="-".join(
    map(str, m if (wt, lt) == (128, 4096) else (wt, lt) + m)))
    for wt, lt in ((128, 4096), (64, 512), (64, 32)) for m in _MESHES]


@pytest.mark.parametrize("wn_tile,line_tile,n_wn,n_line,nwn", _TILED_MESHES)
def test_dense_tiles_mesh_padding_is_the_jax_ones(wn_tile, line_tile, n_wn,
                                                  n_line, nwn):
    """The dense engine's tiles on a mesh (`build_dense_tiles`'
    n_wn / n_line padding and `shard_dense`) at wn_tile x line_tile are
    the JAX `ODModel(wn_tile=, line_tile=, use_pallas=False, mesh=)` XLA
    engine's tiles (od.py:99, :198, :266)."""
    import jax
    import jax.numpy as jnp
    import torch
    from monortm_tpu.models.od import ODModel as JODModel
    from monortm_tpu.parallel.sharding import make_mesh
    from monortm_tpu_torch.models.od import build_dense_tiles, shard_dense
    from monortm_tpu_torch.ops.lineshape import catalog_to_host

    wn = np.linspace(0.3, 55.0, nwn)
    kw = dict(n_h2o=5000, n_o2=40)
    mesh = make_mesh(n_prof=1, n_wn=n_wn, n_line=n_line,
                     devices=jax.devices("cpu")[:n_wn * n_line])
    jm = JODModel(wn, 0.05, j_catalog(**kw), nmol=22, dtype=jnp.float64,
                  use_pallas=False, wn_tile=wn_tile, line_tile=line_tile,
                  mesh=mesh)
    cat = synthetic_catalog_mw(**kw)
    tiles = build_dense_tiles(cat, catalog_to_host(cat, torch.float64), wn,
                              wn_tile, line_tile, n_wn, n_line)
    np.testing.assert_array_equal(tiles["wn"], jm.wn_tiles)
    k2 = len(tiles["o2"]["mol"])
    assert tiles["o2_cols"] * n_line == len(jm.o2_tiles["mol"])
    assert tiles["cols"] * n_line == jm.n_cand
    for k, v in tiles["o2"].items():
        np.testing.assert_array_equal(v, jm.o2_tiles[k][:k2], err_msg=k)
    assert not np.asarray(jm.o2_tiles["valid"][k2:]).any()
    rows, c, kk = len(tiles["cand"]) // n_wn, tiles["cols"], tiles["o2_cols"]
    for w in range(n_wn):
        for l in range(n_line):
            mine = shard_dense(tiles, n_wn, n_line, w, l)
            cs = slice(l * c, (l + 1) * c)
            want = [jm.cand_idx[i, cs][jm.cand_mask[i, cs]].tolist()
                    for i in range(w * rows, (w + 1) * rows)]
            assert mine["cand"] == want
            assert mine["o2_idx"] == [k for k in range(l * kk, (l + 1) * kk)
                                      if k < k2]


def test_port_sources_never_import_the_jax_package():
    files = sorted((ROOT / "monortm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert ROOT / "monortm_tpu_torch" / "parallel" / "sharding.py" in files
    for path in files:
        text = path.read_text()
        assert not _IMPORT.search(text), path
        assert not re.search(r"^\s*(from|import)\s+jax", text, re.M), path
