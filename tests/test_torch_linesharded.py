"""The port's line-axis sharding (`parallel.linesharded`) against the JAX
package's (`monortm_tpu.parallel.linesharded`).

- `split_catalog_stack` gives the JAX function's round-robin layout,
  padding and validity mask exactly;
- `line_od_linesharded` on a 1x1x4 mesh of gloo ranks on the CPU (this
  file as `__main__`, so no rank imports jax) matches the JAX function on
  4 virtual CPU devices at tests/test_linesharded.py's tolerances: float64
  at rtol 1e-12, the float32 two-float split at rtol 2e-5, atol 2e-6 x
  max.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_SHARDS = 4
CATALOG = dict(n_h2o=24, n_o2=8, tile=64)
WN = np.linspace(0.4, 50.0, 32)
NLAY = 3


def _rank_main(out: str):
    """One rank of a 1x1xN_SHARDS mesh; rank 0 saves both dtypes' OD."""
    import torch

    from monortm_tpu_torch.ops.lineshape import LineConfig
    from monortm_tpu_torch.ops.tips import tips_scor
    from monortm_tpu_torch.parallel import distributed
    from monortm_tpu_torch.parallel.linesharded import (
        line_od_linesharded, split_catalog_stack)
    from monortm_tpu_torch.parallel.sharding import make_mesh
    from monortm_tpu_torch.testing import (synthetic_catalog_mw,
                                           synthetic_state)

    torch.set_num_threads(1)
    distributed.init_distributed("gloo")
    mesh = make_mesh(n_prof=1, n_wn=1, n_line=N_SHARDS)
    cat = synthetic_catalog_mw(**CATALOG)
    res = {}
    for dtype in (torch.float64, torch.float32):
        state = synthetic_state(nlay=NLAY, device="cpu", dtype=dtype)
        scor = tips_scor(state.t, dtype=dtype).reshape(
            state.t.shape + (39 * 9,))
        if dtype == torch.float64:
            wn, split = torch.as_tensor(WN), None
        else:
            hi = WN.astype(np.float32)
            lo = (WN - hi.astype(np.float64)).astype(np.float32)
            wn = torch.as_tensor(hi)
            split = (wn, torch.as_tensor(lo))
        stack = split_catalog_stack(cat, N_SHARDS, dtype)
        res[str(dtype)[6:]] = line_od_linesharded(
            stack, wn, split, state, scor, LineConfig(), 22, mesh,
            dtype=dtype).numpy()
    if mesh.rank == 0:
        np.savez(out, **res)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_split_catalog_stack_matches_jax(n_shards, dt):
    import jax.numpy as jnp
    import torch
    from monortm_tpu.parallel.linesharded import split_catalog_stack as j_split
    from monortm_tpu.testing import synthetic_catalog_mw as j_catalog
    from monortm_tpu_torch.parallel.linesharded import split_catalog_stack
    from monortm_tpu_torch.testing import synthetic_catalog_mw

    want = j_split(j_catalog(**CATALOG), n_shards, getattr(jnp, dt))
    got = split_catalog_stack(synthetic_catalog_mw(**CATALOG), n_shards,
                              getattr(torch, dt))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from monortm_tpu_torch.parallel.distributed import spawn
    out = tmp_path_factory.mktemp("linesharded") / "od.npz"
    outs = spawn(["-m", "tests.test_torch_linesharded", str(out)], N_SHARDS,
                 env={**os.environ, "OMP_NUM_THREADS": "1"}, cwd=ROOT,
                 timeout=300)
    for r, (rc, text) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{text[-4000:]}"
    return dict(np.load(out))


@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_linesharded_matches_jax(ranks, dt):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from monortm_tpu.ops.lineshape import LineConfig
    from monortm_tpu.ops.tips import tips_scor
    from monortm_tpu.parallel.linesharded import (line_od_linesharded,
                                                  split_catalog_stack)
    from monortm_tpu.testing import synthetic_catalog_mw, synthetic_state

    dtype = getattr(jnp, dt)
    cat = synthetic_catalog_mw(**CATALOG)
    state = synthetic_state(nlay=NLAY)
    t = jnp.asarray(state.t, dtype)
    scor = tips_scor(t, dtype=dtype).reshape(t.shape + (39 * 9,))
    if dt == "float64":
        wn, split = jnp.asarray(WN, dtype), None
    else:
        wn = jnp.asarray(WN.astype(np.float32))
        split = (wn, jnp.asarray((WN - WN.astype(np.float32)
                                  .astype(np.float64)).astype(np.float32)))
    mesh = Mesh(np.asarray(jax.devices("cpu")[:N_SHARDS]), ("line",))
    want = np.asarray(line_od_linesharded(
        split_catalog_stack(cat, N_SHARDS, dtype), wn, split, state, scor,
        LineConfig(), 22, mesh, dtype=dtype))
    got = ranks[dt]
    assert got.shape == want.shape and got.dtype == want.dtype
    if dt == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-6 * np.abs(want).max())


if __name__ == "__main__":
    _rank_main(sys.argv[1])
