"""The adjoint kernel's Lorentz-lane math and its split into a sweep and a
deferred pass, compiled on the host.

`csrc/linesum_math.cuh` uses no CUDA runtime API, so g++ compiles it as
host C++, without contraction as the kernels are built (the partials'
explicit fused multiply-adds are `fmaf` on the host).  Held here:

- `lorentz_partials` (the Lorentz shape's value as the forward computes
  it, its partials by detuning and hw in closed form from that value)
  and the hoisted pedestal of `line_pre` (VOIGT true and false), against
  the dual-number instantiation (`lorentz<Dual>`, `pedestal<Dual>`) and
  against float64 autograd of the plain formulas.  Tolerance: 1e-6 of
  the partial's own size, for d/d hw of the larger of its size and
  (1/pi)/(hw^2 + d^2), the terms whose difference it is (both
  evaluations cancel there alike).  The value must equal the forward's
  bit for bit.
- `lorentz_class_adjoint` / `sd_pair_adjoint` behind the lane switch, with
  the per-line terms hoisted into `LinePre`, against the all-dual
  `pair_adjoint`, for every class of the branch trees with and without
  the mirror term: each cotangent within 2e-6 of the largest reference
  value of its class and lane kind, and again over the far wing alone
  (beyond 10 cm^-1, where the pedestal's terms weigh as much as the
  shape's); the partials round in another order.  d_stild bit for bit.
- `sweep_tile` followed by `deferred_tile` over one tile of wavenumbers:
  with a one-hot cotangent at each wavenumber in turn, d_stild must be
  that pair's sls exactly (a pair visited twice doubles it, a pair
  missed zeroes it), so every kept pair is visited exactly once, SD-Voigt
  lanes by the deferred pass alone; and with a dense cotangent all seven
  sums agree with the all-dual loop.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++")

CSRC = Path(__file__).resolve().parents[1] / "monortm_tpu_torch" / "csrc"
INV_PI = float(np.float32(0.31830987334251404))
PI_D = 3.1415926535898
FLAGS = {"o2": 1, "co2": 2, "cpl": 4, "xf1": 8, "xf15": 16, "valid": 32}
COT = ("shift", "stild", "hw", "ad", "k3v", "ya", "yb")

HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <string.h>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "linesum_math.cuh"
using namespace linesum;

static bool read_line(Line& ln) {
    return scanf("%f %f %f %f %f %f %f %f %f %f %d", &ln.nu_hi, &ln.nu_lo,
                 &ln.sdep, &ln.shift, &ln.stild, &ln.hw, &ln.ad, &ln.k3v,
                 &ln.ya, &ln.yb, &ln.flags) == 11;
}
static void put(const float* a) {
    for (int c = 0; c < N_COT; ++c) printf(" %.9e", a[c]);
}

// one pair through the lane switch, as the two kernels split it
struct LorentzPair {
    const Pair& p;
    const Line& ln;
    const LinePre& pre;
    float gb;
    float* acc;
    template <int CLS> void operator()() const {
        lorentz_class_adjoint<CLS>(p, class_line<CLS>(ln), pre, gb, acc);
    }
};
template <bool VOIGT>
static int split_pair(const Pair& p, const Line& ln, float gb, float* acc) {
    const LinePre pre = line_pre<VOIGT>(ln);
    if (lorentz_lane<VOIGT>(p.d1, pre)) {
        for_class(pre.cls, LorentzPair{p, ln, pre, gb, acc});
        return 1;
    }
    sd_pair_adjoint(p, ln, gb, acc);
    return 0;
}

template <bool VOIGT> static void pairs() {
    float whi, wlo, gb;
    Line ln;
    while (scanf("%f %f %f", &whi, &wlo, &gb) == 3 && read_line(ln)) {
        float ref[N_COT] = {0}, got[N_COT] = {0};
        Pair p;
        int kept = pair_of(whi, wlo, ln, p), lor = -1;
        if (kept) {
            pair_adjoint<VOIGT>(p, ln, gb, ref);
            lor = split_pair<VOIGT>(p, ln, gb, got);
        }
        printf("%d %d %d %d", kept, lor, (int)p.mirror, (int)p.within);
        put(ref);
        put(got);
        printf("\n");
    }
}

template <bool VOIGT> static void sweep() {
    int wt, n_lines;
    if (scanf("%d %d", &wt, &n_lines) != 2) return;
    std::vector<float> whi(wt), wlo(wt), g(wt), hot(wt);
    for (int w = 0; w < wt; ++w)
        if (scanf("%f %f %f", &whi[w], &wlo[w], &g[w]) != 3) return;
    Line ln;
    for (int n = 0; n < n_lines && read_line(ln); ++n) {
        const LinePre pre = line_pre<VOIGT>(ln);
        for (int w0 = -1; w0 < wt; ++w0) {   // -1: the dense cotangent
            const float* gg = g.data();
            if (w0 >= 0) {
                for (int w = 0; w < wt; ++w) hot[w] = w == w0 ? 1.0f : 0.0f;
                gg = hot.data();
            }
            float ref[N_COT] = {0}, got[N_COT] = {0};
            int kept = 0, sd = 0;
            for (int w = 0; w < wt; ++w) {
                Pair p;
                if (!pair_of(whi[w], wlo[w], ln, p)) continue;
                if (w0 < 0 || w == w0) {
                    kept += 1;
                    sd += !lorentz_lane<VOIGT>(p.d1, pre);
                }
                pair_adjoint<VOIGT>(p, ln, gg[w], ref);
            }
            const bool deferred = sweep_tile<VOIGT>(
                whi.data(), wlo.data(), gg, 1, wt, ln, pre, got);
            const float swept = got[D_STILD];
            if (VOIGT && deferred)
                deferred_tile(whi.data(), wlo.data(), gg, 1, wt, ln, pre,
                              got);
            printf("%d %d %d %d %d %.9e", n, w0, kept, sd, (int)deferred,
                   swept);
            put(ref);
            put(got);
            printf("\n");
        }
    }
}

// A row of the reverse map: slot s holds the wavenumbers [s*wt, (s+1)*wt).
// For each line, the sweep (sweep_slot over every slot, in order) and the
// deferred pass (deferred_row over its word, recording the slots it
// visits), as the two kernels run them; beside them the same pairs through
// split_pair summed slot by slot (the kernels' order: each slot's partial
// from zero, Lorentz lanes, then SD-Voigt lanes), in one running sum per
// pass (the order before the per-slot sums), and in double.  With hot,
// again once per slot with the cotangent of that slot alone.
template <bool VOIGT> static void row() {
    int wt, n_slots, n_lines, hot;
    if (scanf("%d %d %d %d", &wt, &n_slots, &n_lines, &hot) != 4) return;
    const int nw = wt * n_slots;
    std::vector<float> whi(nw), wlo(nw), g(nw), one(nw);
    for (int w = 0; w < nw; ++w)
        if (scanf("%f %f %f", &whi[w], &wlo[w], &g[w]) != 3) return;
    Line ln;
    for (int n = 0; n < n_lines && read_line(ln); ++n) {
        const LinePre pre = line_pre<VOIGT>(ln);
        std::vector<int> sd_slot(n_slots, 0);
        for (int w = 0; w < nw; ++w) {
            Pair p;
            if (pair_of(whi[w], wlo[w], ln, p)
                && !lorentz_lane<VOIGT>(p.d1, pre))
                sd_slot[w / wt] = 1;
        }
        for (int s0 = -1; s0 < (hot ? n_slots : 0); ++s0) {
            const float* gg = g.data();
            if (s0 >= 0) {
                for (int w = 0; w < nw; ++w)
                    one[w] = w / wt == s0 ? g[w] : 0.0f;
                gg = one.data();
            }
            float got[N_COT] = {0};
            unsigned word = 0;
            for (int s = 0; s < n_slots; ++s)
                sweep_slot<VOIGT>(s, &whi[s * wt], &wlo[s * wt], &gg[s * wt],
                                  1, wt, ln, pre, got, word);
            std::vector<int> visits(n_slots, 0);
            if (VOIGT) {
                float sd[N_COT] = {0};
                const auto tile = [&](int s, const float*& a,
                                      const float*& b, const float*& c) {
                    if (s >= n_slots) return false;
                    visits[s] += 1;
                    a = &whi[s * wt];
                    b = &wlo[s * wt];
                    c = &gg[s * wt];
                    return true;
                };
                deferred_row(word, tile, 1, wt, ln, pre, sd);
                for (int c = 0; c < N_COT; ++c) got[c] += sd[c];
            }
            float emu[N_COT] = {0}, emu_sd[N_COT] = {0}, run[N_COT] = {0},
                  run_sd[N_COT] = {0};
            double ref[N_COT] = {0};
            for (int s = 0; s < n_slots; ++s) {
                float part[N_COT] = {0}, part_sd[N_COT] = {0};
                for (int w = s * wt; w < (s + 1) * wt; ++w) {
                    Pair p;
                    if (!pair_of(whi[w], wlo[w], ln, p)) continue;
                    float term[N_COT] = {0};
                    const bool lor = split_pair<VOIGT>(p, ln, gg[w], term);
                    split_pair<VOIGT>(p, ln, gg[w], lor ? part : part_sd);
                    split_pair<VOIGT>(p, ln, gg[w], lor ? run : run_sd);
                    for (int c = 0; c < N_COT; ++c) ref[c] += term[c];
                }
                for (int c = 0; c < N_COT; ++c) {
                    emu[c] += part[c];
                    emu_sd[c] += part_sd[c];
                }
            }
            int same = 1, most = 0, n_sd = 0, last_sd = -1;
            for (int s = 0; s < n_slots; ++s) {
                same &= (visits[s] > 0) == (sd_slot[s] > 0);
                most = visits[s] > most ? visits[s] : most;
                n_sd += sd_slot[s];
                if (sd_slot[s]) last_sd = s;
            }
            printf("%d %d %u %d %d %d %d", n, s0, word, n_sd, last_sd, same,
                   most);
            for (int c = 0; c < N_COT; ++c) emu[c] += emu_sd[c];
            for (int c = 0; c < N_COT; ++c) run[c] += run_sd[c];
            put(got);
            put(emu);
            put(run);
            for (int c = 0; c < N_COT; ++c) printf(" %.17e", ref[c]);
            printf("\n");
        }
    }
}

int main(int argc, char** argv) {
    const bool voigt = argc > 2 && !strcmp(argv[2], "voigt");
    if (!strcmp(argv[1], "lorentz")) {
        float d, hw;
        while (scanf("%f %f", &d, &hw) == 2) {
            Line ln{0.0f, 0.0f, 0.0f, 0.0f, 1.0f, hw, 0.0f, 0.0f, 0.0f, 0.0f,
                    FL_VALID};
            const LinePre pv = line_pre<true>(ln), pl = line_pre<false>(ln);
            float k, k_dn, k_dh;
            lorentz_partials(d, pv, k, k_dn, k_dh);
            const Dual h = var<Dual>(hw, 1);
            const Dual kd = lorentz(var<Dual>(d, 0), h);
            const Dual k3v = pedestal<true>(h), k3l = pedestal<false>(h);
            printf("%.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e %.9e "
                   "%.9e %.9e %.9e %.9e %.9e %.9e\n", k, k_dn, k_dh, kd.v,
                   kd.dn, kd.dh, lorentz(d, hw), pv.k3, pv.k3_dh, k3v.v,
                   k3v.dh, pedestal<true>(hw), pl.k3, pl.k3_dh, k3l.v, k3l.dh,
                   pedestal<false>(hw));
        }
    } else if (!strcmp(argv[1], "pairs")) {
        voigt ? pairs<true>() : pairs<false>();
    } else if (!strcmp(argv[1], "sweep")) {
        voigt ? sweep<true>() : sweep<false>();
    } else if (!strcmp(argv[1], "row")) {
        voigt ? row<true>() : row<false>();
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    d = tmp_path_factory.mktemp("bwd_math")
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "harness"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    f"-I{CSRC}", "-o", str(out), str(d / "harness.cpp"),
                    "-lm"], check=True, capture_output=True, timeout=300)
    return out


def _run(exe, args, rows):
    stdin = "".join(" ".join(f"{v:.9e}" if isinstance(v, (float, np.floating))
                             else str(int(v)) for v in r) + "\n"
                    for r in rows)
    out = subprocess.run([str(exe), *args], input=stdin, text=True,
                         capture_output=True, check=True, timeout=300).stdout
    return np.loadtxt(out.splitlines(), ndmin=2)


def _bits(**on):
    return sum(FLAGS[k] for k, v in on.items() if v) | FLAGS["valid"]


# the classes of the branch trees by their flags
CLASSES = {
    "o2_cpl_xf1": _bits(o2=1, cpl=1, xf1=1),
    "o2_cpl": _bits(o2=1, cpl=1),
    "o2": _bits(o2=1),
    "co2_xf15": _bits(co2=1, cpl=1, xf15=1),
    "co2_cpl": _bits(co2=1, cpl=1),
    "co2": _bits(co2=1),
    "cpl": _bits(cpl=1),
    "plain": _bits(),
}


def test_lorentz_partials_closed_form(exe):
    rng = np.random.default_rng(0)
    n = 2000
    hw = (10.0 ** rng.uniform(-4.0, np.log10(0.3), n)).astype(np.float32)
    d = rng.uniform(-25.0, 25.0, n)
    d[:200] = hw[:200] * rng.uniform(-3.0, 3.0, 200)    # the line core
    d[200:300] = hw[200:300] * np.where(rng.random(100) < 0.5, -1.0, 1.0)
    d[300:320], d[320:340], d[340:360] = 25.0, -25.0, 0.0
    d[360:400] = rng.uniform(25.0, 110.0, 40)           # k2 = K(wn + nu)
    d = d.astype(np.float32)
    got = _run(exe, ["lorentz"], zip(d.astype(float), hw.astype(float)))

    D = torch.tensor(d, dtype=torch.float64, requires_grad=True)
    H = torch.tensor(hw, dtype=torch.float64, requires_grad=True)
    k = H * INV_PI / (H * H + D * D)
    k_dn, k_dh = (g.numpy() for g in torch.autograd.grad(k.sum(), [D, H]))
    k = k.detach().numpy()
    r_pi = INV_PI / (hw.astype(np.float64) ** 2 + d.astype(np.float64) ** 2)

    assert np.isfinite(got).all()
    # the value is the forward's, bit for bit, in all three evaluations
    assert (got[:, 0] == got[:, 6]).all() and (got[:, 3] == got[:, 6]).all()
    assert np.abs(got[:, 0] - k).max() <= 4e-7 * np.abs(k).max()
    for col in (1, 4):      # closed form, dual number
        assert (np.abs(got[:, col] - k_dn) <= 1e-6 * np.abs(k_dn)).all()
        assert (np.abs(got[:, col + 1] - k_dh)
                <= 1e-6 * np.maximum(np.abs(k_dh), r_pi)).all()
    # a zero detuning has a zero d/d detuning and the peak's d/d hw
    zero = d == 0.0
    assert (got[zero, 1] == 0.0).all() and (got[zero, 2] < 0.0).all()

    # the hoisted pedestals: xlorentz(25/hw)/hw and the Lorentz shape at 25
    z = 25.0 / H
    ped_v = 1.0 / (PI_D * (1.0 + z * z)) / H
    ped_l = H * INV_PI / (H * H + 625.0)
    for c0, ped in ((7, ped_v), (12, ped_l)):
        ref_dh, = torch.autograd.grad(ped.sum(), [H])
        ref, ref_dh = ped.detach().numpy(), ref_dh.numpy()
        assert (got[:, c0] == got[:, c0 + 2]).all()         # LinePre = dual
        assert (got[:, c0] == got[:, c0 + 4]).all()         # = the forward
        assert (got[:, c0 + 1] == got[:, c0 + 3]).all()
        assert (np.abs(got[:, c0] - ref) <= 1e-6 * np.abs(ref)).all()
        assert (np.abs(got[:, c0 + 1] - ref_dh)
                <= 1e-6 * np.abs(ref_dh)).all()


def _line_rows(rng, n, flags, voigt, nu_range=(1.0, 54.0)):
    """n random lines of one class at bench-like widths; with `voigt`,
    half of them narrow against their Doppler width (zeta < 0.99)."""
    nu = rng.uniform(*nu_range, n)
    nu_hi = np.float32(nu)
    nu_lo = np.float32(nu - nu_hi.astype(np.float64))
    hw = 10.0 ** rng.uniform(-3.0, -0.7, n)
    ad = 10.0 ** rng.uniform(-6.0, -5.0, n)
    if voigt:
        sd_lane = rng.random(n) < 0.5
        ad = np.where(sd_lane, 10.0 ** rng.uniform(-3.0, -2.3, n), ad)
        hw = np.where(sd_lane, ad * 10.0 ** rng.uniform(-1.0, 1.5, n), hw)
    cols = [nu_hi, nu_lo, rng.uniform(0.0, 0.12, n),
            rng.uniform(-2e-3, 2e-3, n), 10.0 ** rng.uniform(-3.0, 0.0, n),
            hw, ad, 10.0 ** rng.uniform(-6.0, -4.0, n),
            rng.uniform(-0.05, 0.05, n), rng.uniform(-0.02, 0.02, n)]
    return [tuple(float(np.float32(c[i])) for c in cols) + (flags,)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["voigt", "lorentz"])
@pytest.mark.parametrize("cls", list(CLASSES))
def test_pair_adjoint_split_matches_all_dual(exe, cls, mode):
    voigt = mode == "voigt"
    rng = np.random.default_rng(sorted(CLASSES).index(cls) + 10 * voigt)
    n = 600
    # lines below 12.5 cm^-1 take the mirror term near the grid's start
    lines = _line_rows(rng, n, CLASSES[cls], voigt, (0.5, 54.0))
    rows = []
    for i, ln in enumerate(lines):
        nu = float(ln[0]) + float(ln[1])
        kind = i % 6
        if kind == 0:       # anywhere on the grid
            wn = rng.uniform(0.3, 55.0)
        elif kind == 1:     # low wavenumbers: wn + nu - 25 <= 0
            wn = rng.uniform(0.3, max(0.31, min(24.0 - nu, 12.0)))
        elif kind == 2:     # the line core
            wn = nu + float(ln[6]) * rng.uniform(-80.0, 80.0)
        elif kind == 3:     # inside the window
            wn = nu + rng.uniform(-25.0, 25.0)
        elif kind == 4:     # outside it (kept for O2 alone)
            wn = nu + rng.choice([-1.0, 1.0]) * rng.uniform(25.01, 50.0)
        else:               # the window's edge and the centre
            wn = nu + rng.choice([-25.0, 0.0, 25.0])
        wn = max(wn, 0.05)
        whi = np.float32(wn)
        wlo = np.float32(wn - float(whi))
        rows.append((float(whi), float(wlo), float(rng.normal())) + ln)
    got = _run(exe, ["pairs", mode], rows)
    kept, lor, mirror, within = (got[:, c].astype(int) for c in range(4))
    ref, new = got[:, 4:11], got[:, 11:18]
    assert np.isfinite(got).all()
    # both mirror states, and for O2 both sides of the window, are reached
    assert (kept & (mirror == 1)).sum() > 20
    assert (kept & (mirror == 0)).sum() > 20
    if cls.startswith("o2"):
        assert ((kept == 1) & (within == 0)).sum() > 20
    else:
        assert (kept == within).all()
    if voigt:
        assert (lor == 0).sum() > 20 and (lor == 1).sum() > 20
    else:
        assert (lor[kept == 1] == 1).all()
    assert (new[:, 1] == ref[:, 1]).all()           # d_stild: the forward's
    # the far wing apart, where the pedestal's terms are of the size of
    # the shape's and nothing cancels
    r = np.asarray([row[:7] for row in rows])
    far = np.abs((r[:, 0] - r[:, 3]) + (r[:, 1] - r[:, 4]) - r[:, 6]) > 10.0
    assert ((kept == 1) & (lor == 1) & far).sum() > 50
    for lanes in ((kept == 1) & (lor == 1), (kept == 1) & (lor == 1) & far,
                  (kept == 1) & (lor == 0)):
        if not lanes.any():
            continue
        for c, name in enumerate(COT):
            scale = np.abs(ref[lanes, c]).max()
            err = np.abs(new[lanes, c] - ref[lanes, c]).max()
            assert err <= 2e-6 * scale, (cls, mode, name, err, scale)
    assert (new[kept == 0] == 0.0).all()


@pytest.mark.parametrize("mode", ["voigt", "lorentz"])
def test_sweep_and_deferred_visit_each_pair_once(exe, mode):
    voigt = mode == "voigt"
    rng = np.random.default_rng(7 + voigt)
    wt = 128
    wn = np.linspace(10.0, 16.0, wt)
    whi = wn.astype(np.float32)
    wlo = (wn - whi.astype(np.float64)).astype(np.float32)
    g = rng.normal(size=wt).astype(np.float32)
    lines = []
    for flags in CLASSES.values():
        # around the tile, so that SD-Voigt lanes, window edges and (for
        # O2) pairs outside the window all fall inside it; a few lines on
        # a grid point (detuning ~0), and a few low enough for the mirror
        ln = _line_rows(rng, 10, flags, voigt, (9.0, 17.0))
        ln += _line_rows(rng, 3, flags, voigt, (0.5, 14.0))
        ln += _line_rows(rng, 3, flags, voigt, (36.0, 42.0))
        for j in range(4):
            row = list(ln[j])
            k = int(rng.integers(0, wt))
            row[0], row[1] = float(whi[k]), float(wlo[k])
            row[3] = 0.0
            ln[j] = tuple(row)
        lines += ln
    rows = [(wt, len(lines))]
    rows += [(float(a), float(b), float(c)) for a, b, c in zip(whi, wlo, g)]
    got = _run(exe, ["sweep", mode], rows + lines)
    assert got.shape[0] == len(lines) * (wt + 1)
    w0, kept, sd, deferred = (got[:, c].astype(int) for c in (1, 2, 3, 4))
    swept, ref, new = got[:, 5], got[:, 6:13], got[:, 13:20]
    assert np.isfinite(got).all()
    hot = w0 >= 0
    # one-hot cotangents: each kept pair is visited exactly once ...
    assert (new[hot, 1] == ref[hot, 1]).all()
    assert (np.abs(ref[hot & (kept == 1), 1]) > 0).sum() > 1000
    # ... SD-Voigt lanes by the deferred pass alone, Lorentz lanes by the
    # sweep alone, and the sweep reports exactly the tiles with SD lanes
    assert (deferred[~hot] == (sd[~hot] > 0)).all()
    assert (swept[hot & (sd == 1)] == 0.0).all()
    assert (swept[hot & (sd == 0)] == new[hot & (sd == 0), 1]).all()
    if voigt:
        assert (hot & (sd == 1)).sum() > 50
        assert ((~hot) & (sd == 0)).sum() > 5      # tiles with nothing left
    else:
        assert (sd == 0).all()
    # the dense cotangent: all seven sums against the all-dual loop
    for c, name in enumerate(COT):
        scale = np.abs(ref[~hot, c]).max()
        err = np.abs(new[~hot, c] - ref[~hot, c]).max()
        assert err <= 2e-6 * scale, (mode, name, err, scale)
    if not voigt:
        assert (new[:, 3] == 0.0).all() and (new[:, 4] == 0.0).all()


def _row_grid(rng, n_slots, wt, w0, dw):
    """A row of n_slots tiles of wt wavenumbers from w0 by dw, and a
    smooth cotangent (a line sum's cotangent varies slowly over a
    line's window) with a little noise."""
    wn = w0 + dw * np.arange(n_slots * wt)
    whi = wn.astype(np.float32)
    wlo = (wn - whi.astype(np.float64)).astype(np.float32)
    g = (1.0 + 0.3 * np.sin(wn / 3.0)
         + 0.05 * rng.normal(size=wn.size)).astype(np.float32)
    return wn, whi, wlo, g


def _row_lines(rng, voigt, wn, centres):
    """One line of each class at each of `centres` (wavenumbers); with
    `voigt`, narrow against its Doppler width (zeta < 0.99), its
    SD-Voigt lanes (|detuning| <= 100 aD) within a few dozen points."""
    lines = []
    for flags in CLASSES.values():
        ln = _line_rows(rng, len(centres), flags, voigt)
        for row, nu in zip(ln, centres):
            row = list(row)
            row[0] = float(np.float32(nu))
            row[1] = float(np.float32(nu - row[0]))
            row[3] = 0.0
            if voigt:
                ad = 10.0 ** rng.uniform(-4.5, -3.7)
                row[6] = float(np.float32(ad))
                row[5] = float(np.float32(ad * 10.0 ** rng.uniform(-1, 1)))
            lines.append(tuple(row))
    return lines


def _row_run(exe, mode, whi, wlo, g, lines, wt, hot):
    n_slots = len(whi) // wt
    rows = [(wt, n_slots, len(lines), int(hot))]
    rows += [(float(a), float(b), float(c)) for a, b, c in zip(whi, wlo, g)]
    got = _run(exe, ["row", mode], rows + lines)
    assert got.shape[0] == len(lines) * (1 + hot * n_slots)
    assert np.isfinite(got).all()
    return got


@pytest.mark.parametrize("mode", ["voigt", "lorentz"])
def test_sweep_and_deferred_visit_each_pair_once_along_a_row(exe, mode):
    """A row of 40 slots, SD-Voigt lanes in slots past 30 (one slot, and
    two across a tile boundary) and before: the deferred pass visits the
    slots that hold SD-Voigt lanes and no other, each once, and with the
    cotangent of one slot at a time and of all, the two kernels' sums are
    bit for bit those of every kept pair taken once, in the kernels'
    order."""
    voigt = mode == "voigt"
    rng = np.random.default_rng(70 + voigt)
    wt, n_slots = 128, 40
    wn, whi, wlo, g = _row_grid(rng, n_slots, wt, 20.0, 0.69e-3)
    at = lambda s, frac: float(wn[0] + (s + frac) * wt * 0.69e-3)
    centres = [at(33, 0.4), at(38, 0.7), at(31, 0.0), at(36, 0.0),
               at(30, 0.999), at(4, 0.5)]
    got = _row_run(exe, mode, whi, wlo, g, _row_lines(rng, voigt, wn,
                                                      centres), wt, True)
    word = got[:, 2].astype(np.int64)
    n_sd, last_sd, same, most = (got[:, c].astype(int) for c in range(3, 7))
    kernel, emulated = got[:, 7:14], got[:, 14:21]
    assert (kernel == emulated).all()
    assert (same == 1).all() and (most <= 1).all()
    first = (word >> 16) - 1
    has = n_sd > 0
    assert (word[~has] == 0).all()
    assert ((word[has] & 0xFFFF) - 1 == last_sd[has]).all()
    assert (first[has] == last_sd[has] - n_sd[has] + 1).all()
    if voigt:
        dense = got[:, 1] < 0
        assert (dense & has & (first > 30)).sum() >= 20
        assert (dense & (n_sd == 2) & (first > 30)).sum() >= 8
        assert (dense & has & (last_sd < 31)).sum() >= 8
    else:
        assert not has.any()


@pytest.mark.parametrize("mode", ["voigt", "lorentz"])
def test_row_sums_slot_by_slot(exe, mode):
    """C4: over a row of 500 slots (the reverse rows of the reference's
    capacity envelope hold 233-625), each cotangent is the kernels'
    per-slot order bit for bit, and within the adjoint's tolerance (rtol
    2e-5, atol 1e-5 x max) of the float64 sum of the same float32 terms;
    the running sum over every wavenumber, the order before, is printed
    beside it on failure."""
    voigt = mode == "voigt"
    rng = np.random.default_rng(80 + voigt)
    wt, n_slots = 128, 500
    dw = 50.0 / (wt * n_slots)
    wn, whi, wlo, g = _row_grid(rng, n_slots, wt, 2.5, dw)
    centres = list(rng.uniform(26.0, 29.0, 4))
    got = _row_run(exe, mode, whi, wlo, g, _row_lines(rng, voigt, wn,
                                                      centres), wt, False)
    kernel, emulated, running = got[:, 7:14], got[:, 14:21], got[:, 21:28]
    ref = got[:, 28:35]
    assert (kernel == emulated).all()
    if voigt:
        assert (got[:, 3] > 0).sum() >= 16
    for c, name in enumerate(COT):
        if not voigt and name in ("ad", "k3v"):
            assert (kernel[:, c] == 0.0).all()
            continue
        scale = np.abs(ref[:, c]).max()
        assert scale > 0.0, name
        tol = 1e-5 * scale + 2e-5 * np.abs(ref[:, c])
        err = np.abs(kernel[:, c] - ref[:, c])
        run = np.abs(running[:, c] - ref[:, c])
        assert (err <= tol).all(), (name, (err / scale).max(),
                                    "running sum:", (run / scale).max())
