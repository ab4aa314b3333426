"""The control of each cell's check comes out not correct: the plain
reference in the precision below the configuration's (control.BELOW)
put in the program's place fails a limit of
benchmark/workloads/<cell>.json, here at a size a test run holds (on the
chip at the cells' own sizes: benchmark/control.py)."""

import json

import pytest
import torch

from benchmark import control as C
from benchmark.run import judge
from benchmark.tests.tiny import tiny

CELLS = [w["name"] for w in json.loads(
    (C.HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2_147_483_659, 3_000_000_019])
def test_the_control_fails(cell, seed, tmp_path):
    c = tiny(cell)
    dtype = getattr(torch, C.BELOW[c.cfg["precision"]])
    ok, rows = judge(C.control(c, seed, dtype, "cpu", tmp_path)[0],
                     c.limits)
    assert not ok, rows
