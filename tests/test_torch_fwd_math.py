"""The forward kernel's walk over staged lines, compiled on the host.

`csrc/linesum_math.cuh` uses no CUDA runtime API, so g++ compiles it as
host C++, without contraction as the kernels are built.  The harness
below emulates one block of `csrc/linesum.cu`: it stages the lines chunk
by chunk as the kernel does (`fwd_key` drops the lines that add nothing to
the block's wavenumbers, `fwd_line` / `fwd_sd` hoist the rest, packed in
order), then runs `fwd_chunk` for each of the block's threads with its NW
wavenumbers (the loop per class of the branch trees, the running sum of
the current molecule kept apart and written back where the molecule
changes) and `fwd_flush` at the end.  The sums must equal, bit for bit,
those of the unhoisted loop the kernel ran before: `pair_of` ->
`shapes<VOIGT>` -> `branch_trees` -> `acc[m] += sls * stild`, line by line.

The lines cover every class of the branch trees, the mirror term, pairs
inside and outside the window (uncoupled O2 outside it, where the loop
added 0 * stild and the walk adds nothing), SD-Voigt lanes (VOIGT=true),
invalid lines and lines of no molecule, molecules that change inside a
chunk, runs that cross chunks, and lanes past the tile's end.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++")

CSRC = Path(__file__).resolve().parents[1] / "monortm_tpu_torch" / "csrc"
FLAGS = {"o2": 1, "co2": 2, "cpl": 4, "xf1": 8, "xf15": 16, "valid": 32}

HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <string.h>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "linesum_math.cuh"
using namespace linesum;

static unsigned bits(float x) {
    unsigned u;
    memcpy(&u, &x, sizeof u);
    return u;
}

struct Raw {
    Line ln;
    int mol;
};

// the forward kernel's loop before hoisting, at each wavenumber
template <bool VOIGT>
static void reference(const std::vector<float>& whi,
                      const std::vector<float>& wlo,
                      const std::vector<Raw>& lines, int n_mol,
                      std::vector<float>& out, long* stats) {
    for (size_t w = 0; w < whi.size(); ++w) {
        float* acc = &out[w * n_mol];
        for (int m = 0; m < n_mol; ++m) acc[m] = 0.0f;
        for (const Raw& r : lines) {
            const Line& ln = r.ln;
            const int fl = ln.flags, m = r.mol;
            if (!(fl & FL_VALID) || m < 0 || m >= n_mol) continue;
            Pair pr;
            if (!pair_of(whi[w], wlo[w], ln, pr)) continue;
            float k1, k2, k3;
            const bool lor = shapes<VOIGT>(pr, ln, k1, k2, k3);
            const float sls = branch_trees(pr, ln, k1, k2, k3);
            acc[m] += sls * ln.stild;
            stats[0] += 1;                           // kept pairs
            stats[1] += !lor;                        // SD-Voigt lanes
            stats[2] += pr.mirror;                   // with the mirror term
            stats[3] += pr.o2 && !pr.cpl && !pr.within;  // 0 * stild
        }
    }
}

// one block of the kernel: S threads of NW wavenumbers each
template <bool VOIGT, int NW>
static void hoisted(const std::vector<float>& whi,
                    const std::vector<float>& wlo,
                    const std::vector<Raw>& lines, int n_mol, int chunk,
                    int S, std::vector<float>& out, long* stats) {
    const int n_w = static_cast<int>(whi.size());
    float lo = INFINITY, hi = -INFINITY;
    for (int w = 0; w < n_w; ++w) {
        lo = fminf(lo, whi[w]);
        hi = fmaxf(hi, whi[w]);
    }
    std::vector<float> t_whi(S * NW), t_wlo(S * NW), acc(S * NW, 0.0f);
    std::vector<float*> rows(S * NW);
    std::vector<int> cur_m(S, -1);
    for (int t = 0; t < S; ++t)
        for (int r = 0; r < NW; ++r) {
            const int w = t + r * S, wc = w < n_w ? w : n_w - 1;
            t_whi[t * NW + r] = whi[wc];
            t_wlo[t * NW + r] = wlo[wc];
            rows[t * NW + r] = w < n_w ? &out[w * n_mol] : nullptr;
        }
    for (float& v : out) v = 0.0f;
    const int n_lines = static_cast<int>(lines.size());
    for (int c0 = 0; c0 < n_lines; c0 += chunk) {
        std::vector<FwdLine> s;
        std::vector<FwdSd> sd;
        for (int q = c0; q < n_lines && q < c0 + chunk; ++q) {
            const Line& ln = lines[q].ln;
            const int k = fwd_key(ln.flags, lines[q].mol, n_mol,
                                  ln.nu_hi + (ln.nu_lo + ln.shift), ln.shift,
                                  lo, hi);
            if (k < 0) {
                const bool valid = (ln.flags & FL_VALID) && lines[q].mol >= 0
                                   && lines[q].mol < n_mol;
                stats[valid ? 4 : 5] += 1;   // outside every window; none
                continue;
            }
            if (!s.empty() && (s.back().key >> 3) != (k >> 3)) stats[6] += 1;
            s.push_back(fwd_line<VOIGT>(ln));
            s.back().key = k;
            sd.push_back(fwd_sd(ln));
        }
        const int n = static_cast<int>(s.size());
        s.emplace_back();
        s.back().key = -1;                  // the sentinel
        for (int t = 0; t < S; ++t)
            fwd_chunk<VOIGT, NW>(s.data(), sd.data(), n,
                                 &t_whi[t * NW], &t_wlo[t * NW],
                                 &acc[t * NW], cur_m[t], &rows[t * NW]);
    }
    for (int t = 0; t < S; ++t)
        fwd_flush<NW>(&acc[t * NW], cur_m[t], &rows[t * NW]);
}

template <bool VOIGT, int NW>
static void run(int chunk, int S, int n_mol, const std::vector<float>& whi,
                const std::vector<float>& wlo, const std::vector<Raw>& lines) {
    std::vector<float> ref(whi.size() * n_mol), got(whi.size() * n_mol);
    long stats[7] = {0};
    reference<VOIGT>(whi, wlo, lines, n_mol, ref, stats);
    hoisted<VOIGT, NW>(whi, wlo, lines, n_mol, chunk, S, got, stats);
    for (int c = 0; c < 7; ++c) printf("%ld ", stats[c]);
    printf("\n");
    for (size_t e = 0; e < ref.size(); ++e)
        printf("%u %u\n", bits(ref[e]), bits(got[e]));
}

int main() {
    int voigt, nw, chunk, S, n_w, n_mol, n_lines;
    if (scanf("%d %d %d %d %d %d %d", &voigt, &nw, &chunk, &S, &n_w, &n_mol,
              &n_lines) != 7)
        return 1;
    std::vector<float> whi(n_w), wlo(n_w);
    for (int w = 0; w < n_w; ++w)
        if (scanf("%f %f", &whi[w], &wlo[w]) != 2) return 1;
    std::vector<Raw> lines(n_lines);
    for (Raw& r : lines) {
        Line& ln = r.ln;
        if (scanf("%f %f %f %f %f %f %f %f %f %f %d %d", &ln.nu_hi,
                  &ln.nu_lo, &ln.sdep, &ln.shift, &ln.stild, &ln.hw, &ln.ad,
                  &ln.k3v, &ln.ya, &ln.yb, &ln.flags, &r.mol) != 12)
            return 1;
    }
#define RUN(V, N) \
    if (voigt == V && nw == N) run<V, N>(chunk, S, n_mol, whi, wlo, lines);
    RUN(1, 1) RUN(1, 2) RUN(1, 4) RUN(0, 1) RUN(0, 2) RUN(0, 4)
    return 0;
}
"""


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    d = tmp_path_factory.mktemp("fwd_math")
    (d / "harness.cpp").write_text(HARNESS)
    out = d / "harness"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    f"-I{CSRC}", "-o", str(out), str(d / "harness.cpp"),
                    "-lm"], check=True, capture_output=True, timeout=300)
    return out


def _bits(**on):
    return sum(FLAGS[k] for k, v in on.items() if v) | FLAGS["valid"]


# the eight flag combinations (seven classes of the branch trees: CO2
# coupled without XF15 is the CO2 class)
CLASSES = [_bits(o2=1, cpl=1, xf1=1), _bits(o2=1, cpl=1), _bits(o2=1),
           _bits(co2=1, cpl=1, xf15=1), _bits(co2=1, cpl=1), _bits(co2=1),
           _bits(cpl=1), _bits()]


def _f32(x):
    return float(np.float32(x))


def _block(rng, voigt, n_w, n_mol):
    """The wavenumbers of one block and a catalog chunk's worth of lines
    around them, in runs of one class and one molecule."""
    # 12.5 with a line at 12.5: dsum = 25 exactly, the mirror term's edge
    wn = np.sort(np.append(rng.uniform(6.0, 18.0, n_w - 1), 12.5))
    whi = wn.astype(np.float32)
    wlo = (wn - whi.astype(np.float64)).astype(np.float32)
    lines = []
    while len(lines) < 700:
        flags = int(rng.choice(CLASSES))
        mol = int(rng.integers(0, n_mol))
        for _ in range(int(rng.integers(1, 12))):
            # mostly around the block, some beyond every window (nu > 43)
            nu = rng.uniform(0.5, 60.0)
            shift = rng.uniform(-2e-3, 2e-3)
            hw = 10.0 ** rng.uniform(-3.0, -0.7)
            ad = 10.0 ** rng.uniform(-6.0, -5.0)
            if voigt and rng.random() < 0.4:
                # narrow against its Doppler width (zeta < 0.99), some of
                # them centred on a wavenumber of the block
                ad = 10.0 ** rng.uniform(-2.7, -2.0)
                hw = ad * 10.0 ** rng.uniform(-1.0, 1.0)
                if rng.random() < 0.5:
                    nu, shift = float(wn[rng.integers(0, n_w)]), 0.0
            nu_hi = np.float32(nu)
            nu_lo = np.float32(nu - float(nu_hi))
            lines.append([float(nu_hi), float(nu_lo),
                          _f32(rng.uniform(0.0, 0.12)), _f32(shift),
                          _f32(10.0 ** rng.uniform(-3.0, 0.0)), _f32(hw),
                          _f32(ad), _f32(10.0 ** rng.uniform(-6.0, -4.0)),
                          _f32(rng.uniform(-0.05, 0.05)),
                          _f32(rng.uniform(-0.02, 0.02)), flags, mol])
    for j, flags in enumerate(CLASSES):
        lines[300 + 11 * j][:2] = [12.5, 0.0]
        lines[300 + 11 * j][3] = 0.0
        lines[300 + 11 * j][10] = flags
    # an invalid line and lines of no molecule, inside runs
    for j, (fl, m) in enumerate(((0, 1), (_bits(), -1), (_bits(), n_mol))):
        row = list(lines[100 + 97 * j])
        row[10], row[11] = (row[10] & ~FLAGS["valid"]) if fl == 0 else fl, m
        lines[100 + 97 * j] = row
    return whi, wlo, lines


@pytest.mark.parametrize("nw", [1, 2, 4])
@pytest.mark.parametrize("mode", ["voigt", "lorentz"])
def test_walk_is_bitwise_the_unhoisted_loop(exe, mode, nw):
    voigt = mode == "voigt"
    rng = np.random.default_rng(100 * voigt + nw)
    n_mol, chunk, threads = 4, 37, 64 // nw
    n_w = 61                # 3 lanes past the tile's end
    whi, wlo, lines = _block(rng, voigt, n_w, n_mol)
    head = f"{int(voigt)} {nw} {chunk} {threads} {n_w} {n_mol} {len(lines)}\n"
    body = "".join(f"{a:.9e} {b:.9e}\n" for a, b in zip(whi, wlo))
    body += "".join(" ".join(f"{v:.9e}" if isinstance(v, float) else str(v)
                             for v in ln) + "\n" for ln in lines)
    out = subprocess.run([str(exe)], input=head + body, text=True,
                         capture_output=True, check=True,
                         timeout=300).stdout.splitlines()
    kept, sd, mirror, o2_out, far, none, switches = map(int, out[0].split())
    ref_got = np.array([ln.split() for ln in out[1:]], dtype=np.uint32)
    assert ref_got.shape == (n_w * n_mol, 2)
    ref, got = ref_got[:, 0], ref_got[:, 1]
    # the sums, bit for bit
    assert (got == ref).all(), np.nonzero(got != ref)[0][:10]
    assert (ref != 0).sum() >= n_w * n_mol * 3 // 4
    # what the case covers
    assert kept > 5000 and mirror > 500 and o2_out > 200
    assert far > 50 and none == 3 and switches > 20
    if voigt:
        assert sd > 30
    else:
        assert sd == 0


def test_mirror_test_without_the_subtraction():
    """fwd_pair tests dsum <= 25 where pair_of tests (dsum - 25) <= 0."""
    edge = np.arange(np.float32(12.0).view(np.uint32),
                     np.float32(50.0).view(np.uint32), 97,
                     dtype=np.uint32).view(np.float32)
    around = np.nextafter(np.float32(25.0),
                          np.float32([-np.inf, np.inf]), dtype=np.float32)
    special = np.float32([25.0, 0.0, -0.0, -1e30, 1e30, 1e-30, -25.0,
                          np.inf, -np.inf, np.nan, 1e6, 3.0])
    d = np.concatenate([edge, around, special])
    with np.errstate(invalid="ignore"):
        assert ((d - np.float32(25.0) <= 0) == (d <= np.float32(25.0))).all()
