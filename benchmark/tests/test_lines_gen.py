"""The line catalogs of the configurations: the lines each configuration
names, at the positions of its source, every one read by RDLNFL's panel
rules at the configuration's grid, whatever the seed."""

import json

import numpy as np
import pytest

from benchmark.gen.lines import GHZ_PER_CM, NLINEREC, n_lines, \
    synthetic_lines
from benchmark.reference.lines import catalog
from benchmark.run import ROOT

CONFIGS = [c["file"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]]
SEEDS = (2_147_483_659, 4_000_000_007)


def _grid_ends(cfg):
    g = cfg["grid"]
    return g["v1"], g["v1"] + (g["nwn"] - 1) * g["dvset"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("path", CONFIGS)
def test_every_named_line_is_read(path, seed):
    cfg = json.loads((ROOT / path).read_text())
    raw = synthetic_lines(cfg["lines"], seed)
    want = sum(len(c["ghz"]) if "ghz" in c else c["n"]
               for c in cfg["lines"])
    assert n_lines(raw) == want
    n = len(raw["iflg"])
    assert (raw["iflg"][np.r_[NLINEREC - 1:n:NLINEREC, n - 1]] >= 0).all()
    cpl = np.nonzero(raw["iflg"] < 0)[0]
    assert (raw["iflg"][cpl - 1] == 1).all()
    got = catalog(raw, *_grid_ends(cfg))
    assert len(got["nu0"]) == want
    for c in cfg["lines"]:
        mol = 1 if c["kind"] == "h2o" else 7
        nu = np.sort(got["nu0"][got["mol"] == mol])
        if "ghz" in c:
            assert np.isin(np.round(np.asarray(c["ghz"]) / GHZ_PER_CM, 9),
                           np.round(nu, 9)).all()
        else:
            assert c["cm"][0] <= nu[0] and nu[-1] <= c["cm"][1]


def test_a_coupling_record_never_ends_a_panel():
    """A dense coupled band: the records are moved so that every panel
    ends on a line, and each coupling record still follows its line."""
    classes = [dict(kind="h2o", n=300, cm=[0.5, 60.0]),
               dict(kind="o2_coupled", n=900, cm=[1.5, 10.0])]
    for seed in range(6):
        raw = synthetic_lines(classes, seed)
        n = len(raw["iflg"])
        assert (raw["iflg"][np.r_[NLINEREC - 1:n:NLINEREC, n - 1]]
                >= 0).all()
        cpl = np.nonzero(raw["iflg"] < 0)[0]
        assert (raw["iflg"][cpl - 1] == 1).all()
        assert len(catalog(raw, 0.3, 55.0)["nu0"]) == 1200
