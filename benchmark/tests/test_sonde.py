"""The stacked radiosonde cell (`mw_sonde.pipeline`, driver
`drivers/sonde.py`) at a size a test run holds: a sound run comes out
correct; a Tb altered where the writer produces it, half the profiles
left out, and the layer amounts moved by 1% between the program's
layering and its model come out not correct; the cell's readers read
the program's `layering.pool` stage and LAYERING line and return None
on a LOG without them."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as R
from benchmark.gen.sonde import write_sondes
from benchmark.reference import layering as LA
from benchmark.tests.tiny import tiny

CELL = "mw_sonde.pipeline"
SEED = 2_147_483_701


def _run(tmp_path, wrap=None, seconds=0.5):
    """A run of the tiny cell with drv.run_fn wrapped after set-up."""
    c = tiny(CELL)
    drv = R.driver_of(c, SEED, torch.device("cpu"), tmp_path / CELL)[1]
    if wrap is not None:
        setup = drv.setup

        def broken_setup():
            setup()
            drv.run_fn = wrap(drv.run_fn, drv, c)
        drv.setup = broken_setup
    return R.run(c, SEED, seconds, False, device="cpu", drv=drv)


def test_a_sound_run_is_correct(tmp_path):
    res = _run(tmp_path)
    assert res["correct"] and res["attempted"] >= 1, res["checks"]


def test_tb_altered_in_the_writer(tmp_path):
    from monortm_tpu_torch.io import output

    def wrap(run_fn, drv, c):
        dtb = 2.0 * c.limits["tb_gap_k"]["limit"]

        def run(*a, **k):
            write = output.OutputWriter.write_profile

            def altered(self, npr, wn, res, *aa, **kk):
                res = dataclasses.replace(res, tb=res.tb + dtb)
                return write(self, npr, wn, res, *aa, **kk)
            output.OutputWriter.write_profile = altered
            try:
                return run_fn(*a, **k)
            finally:
                output.OutputWriter.write_profile = write
        return run
    assert not _run(tmp_path, wrap)["correct"]


def test_half_the_profiles_left_out(tmp_path):
    def wrap(run_fn, drv, c):
        def run(*a, filein=None, **k):
            lines = filein.read_text().splitlines(keepends=True)
            starts = [j for j, ln in enumerate(lines) if ln[:1] == "$"]
            half = filein.with_suffix(".half")
            half.write_text("".join(lines[:starts[len(starts) // 2]])
                            + "%%%%\n")
            return run_fn(*a, filein=half, **k)
        return run
    assert not _run(tmp_path, wrap)["correct"]


def test_layer_amounts_moved_between_layering_and_model(tmp_path):
    from monortm_tpu_torch.atmos import tape5_atm

    def wrap(run_fn, drv, c):
        def run(*a, **k):
            block = tape5_atm._atmpth_block

            def scaled(args):
                prof = block(args)
                prof.state = dataclasses.replace(
                    prof.state, wkl=prof.state.wkl * 1.01)
                return prof
            tape5_atm._atmpth_block = scaled
            try:
                return run_fn(*a, **k)
            finally:
                tape5_atm._atmpth_block = block
        return run
    assert not _run(tmp_path, wrap)["correct"]


class _Logs:
    def __init__(self, tables, rows):
        self.tables, self.rows = tables, rows

    def stages(self, steps):
        return self.tables[:steps]

    def layering(self, steps):
        return self.rows[:steps]


def _ctx(tables=(), rows=(), steps=2):
    return SimpleNamespace(driver=_Logs(list(tables), list(rows)),
                           steps=steps)


def test_readers_read_their_rows_and_none_without():
    tables = [{"profiles+layering": 3.0, "layering.pool": 2.5},
              {"profiles+layering": 2.0, "layering.pool": 1.5},
              {"profiles+layering": 9.0, "layering.pool": 9.0}]
    rows = [(512, 8, 7), (512, 8, 6), (512, 8, 1)]
    ctx = _ctx(tables, rows)
    assert R.reader("layering_pool_s.sonde")(ctx) == pytest.approx(2.0)
    assert R.reader("layering_wait_s.sonde")(ctx) == pytest.approx(0.5)
    assert R.reader("chunks_per_run.sonde")(ctx) == pytest.approx(6.5)
    # the parent's LOG: profiles+layering without the pool's stage, no
    # LAYERING line; a driver that keeps no LOG
    old = _ctx([{"profiles+layering": 3.0}] * 2, [])
    for m in ("layering_pool_s.sonde", "layering_wait_s.sonde",
              "chunks_per_run.sonde"):
        assert R.reader(m)(old) is None, m
        assert R.reader(m)(_ctx()) is None, m


def test_the_driver_reads_the_layering_line(tmp_path):
    c = tiny(CELL)
    drv = R.driver_of(c, SEED, torch.device("cpu"), tmp_path / CELL)[1]
    drv.setup()
    drv.step(0)
    nlay = {len(LA.layer(LA.parse_block(b))["p"]) for b in
            LA.parse_run(drv.pool["tape5s"][0])["blocks"]}
    assert drv.layering(1) == [(3, 1, len(nlay))]
    assert "profiles+layering" in drv.stages(1)[0]
    drv.cleanup()


def test_every_seed_writes_the_same_number_of_sondes(tmp_path):
    c = tiny(CELL)
    for seed in (SEED, 4_000_000_007):
        pool = write_sondes(c.cfg, seed, 2, 3, tmp_path / str(seed))
        assert [len(LA.parse_run(p)["blocks"]) for p in pool["tape5s"]] \
            == [3, 3]
