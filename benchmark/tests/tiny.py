"""A cell of BENCHMARK.json cut to a size a CPU test run holds: the
configuration's shapes and the traffic's kind, with few wavenumbers,
lines, layers and profiles."""

from benchmark import run as R


def tiny(name: str, nwn: int = 24, nlay: int = 6):
    c = R.load_cell(name)
    cfg = dict(c.cfg)
    g = cfg["grid"]
    cfg["grid"] = dict(g, nwn=nwn, dvset=round(g["dvset"] * (g["nwn"] - 1)
                                               / (nwn - 1), 4))
    cfg["lines"] = [dict(k, n=min(k["n"], 64)) if "n" in k else k
                    for k in cfg["lines"]]
    cfg["profile"] = dict(cfg["profile"], nlay=nlay)
    tr = dict(c.traffic, sample_wn=8)
    if "profiles_per_run" in tr:
        tr["profiles_per_run"] = min(tr["profiles_per_run"], 3)
        tr["pool"] = 2
    if "profiles" in tr:
        tr["profiles"] = 2
    c.cfg, c.traffic = cfg, tr
    return c
