"""The LINES prologue kernels (csrc/prologue.cu) and their plain versions.

On the CPU:
- `precompute_bwd_plain`, the adjoint's closed form in PyTorch, against
  torch.autograd through `precompute_plain`: in float64 to 1e-12 of each
  gradient's norm, in float32 to 1e-6 of it (the repository's adjoint
  tolerance), on a catalog that reaches every branch: H2O lines, coupled
  O2 (xg = -1), CO2, xg = -3 and -5 with self mixing, IBRD 0 and 1,
  padding lines (valid = 0), speed dependence on and off (the pedestal's
  SD-Voigt and plain Voigt), rows in each TEMPLC interval and outside
  them, and the all-Lorentz sum's missing cotangents of ad and k3v.
- csrc/prologue_math.cuh compiled on the host (g++, without contraction
  as nvcc -fmad=false builds the kernels): its forward against
  `precompute_plain` in float32 (the host's libm and PyTorch's CPU
  kernels round exp, expm1, pow and sqrt each their own way, so to a few
  float32 ulps here; the card's check is bitwise), and its adjoint,
  summed per row in the kernels' runs, against `precompute_bwd_plain`
  (1e-6 of each gradient's norm).
- `line_constants`' packed catalog and runs; `precompute` on the CPU is
  `precompute_plain`, bit for bit.

On the card (marked `cuda`, skipped without one; `python -m pytest
tests -m cuda -n 0` there): the kernel's seven operands against
`precompute_plain` on the same CUDA tensors, bit for bit, at 8 x 40 and
64 x 40 rows; its adjoint on the line sum's own cotangents twice with
the same bits, and against `precompute_bwd_plain` and autograd through
`precompute_plain` (1e-6 of each gradient's norm); the kernels one
value_and_grad step launches in its line stage (chip_smoke's phase 16,
which adds the envelope's shape).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from monortm_tpu_torch.ops.lineshape import LineConfig
from monortm_tpu_torch.ops.linesum import (PER_LN, PRO_COLS, RUN_LINES,
                                           line_constants, precompute,
                                           precompute_bwd_plain,
                                           precompute_plain)
from monortm_tpu_torch.ops.voigt import sdvoigt
from monortm_tpu_torch.testing import (line_sum_cotangents, prologue_rows,
                                       prologue_device_catalog)

CSRC = Path(__file__).resolve().parents[1] / "monortm_tpu_torch" / "csrc"
GRADS = ("p", "t", "wk", "wbrod", "scor_flat")


def autograd_grads(cat, state, cfg, g, dtype):
    leaves = [v.clone().requires_grad_() for v in state]
    pre = precompute_plain(cat, *leaves, cfg, dtype)
    outs = [(pre[k] * gk).sum() for k, gk in zip(PER_LN, g)
            if gk is not None]
    return torch.autograd.grad(sum(outs), leaves)


def rel_err(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


CFGS = {"ibrd0": LineConfig(),
        "ibrd1": LineConfig(ibrd=1, sclcpl=0.9, sclhw=1.1, y0res=1e-3)}


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("lorentz", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_plain_adjoint_is_autograd(cfg, lorentz, dtype, tol):
    cat = prologue_device_catalog(dtype)
    state = prologue_rows(dtype=dtype)
    g = line_sum_cotangents(cat, state, CFGS[cfg], dtype, lorentz)
    ref = autograd_grads(cat, state, CFGS[cfg], g, dtype)
    got = precompute_bwd_plain(cat, *state, CFGS[cfg], g, dtype)
    for name, a, b in zip(GRADS, got, ref):
        assert a.shape == b.shape and a.dtype == dtype, name
        assert torch.isfinite(a).all(), name
        assert rel_err(a, b) <= tol, (name, rel_err(a, b))


# ---- csrc/prologue_math.cuh on the host ----------------------------------

HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "prologue_math.cuh"
using namespace prologue;

template <typename T> static std::vector<T> get(FILE* f, long long n) {
    std::vector<T> v(n);
    if (fread(v.data(), sizeof(T), n, f) != (size_t)n) exit(3);
    return v;
}
template <typename T> static void put(FILE* f, const std::vector<T>& v) {
    fwrite(v.data(), sizeof(T), v.size(), f);
}

// the kernels' work on the host: the seven operands of every pair, then
// each row's gradients from its runs (each run's lines summed in order)
template <bool IBRD> static void run(FILE* in, FILE* out, int L, int N,
                                     int n_runs) {
    constexpr int NA = NAdj<IBRD>::value;
    std::vector<float> kc = get<float>(in, N_CONSTS);
    Consts K;
    float* kp = &K.boltz;
    for (int i = 0; i < N_CONSTS; ++i) kp[i] = kc[i];
    auto cols = get<float>(in, (long long)N_COLS * N);
    auto words = get<int>(in, N);
    auto p = get<float>(in, L), t = get<float>(in, L), wt = get<float>(in, L);
    auto wk = get<float>(in, (long long)L * 39);
    auto scor = get<float>(in, (long long)L * 351);
    auto g = get<float>(in, 7LL * L * N);
    auto perm = get<int>(in, N);
    auto runs = get<int>(in, 3LL * n_runs);
    std::vector<float> fwd(7LL * L * N), gp(L), gt(L), gwk(L * 39LL),
        gwb(L), gsc(L * 351LL), part((long long)L * n_runs * NA);
    for (int r = 0; r < L; ++r) {
        const RowVals rv = row_vals(p[r], t[r], wt[r], K);
        for (int n = 0; n < N; ++n) {
            LineCols ln;
            load_line<IBRD>(cols.data(), words.data(), N, n, ln);
            Pair q;
            pair_fwd<IBRD>(rv, &wk[r * 39LL], &scor[r * 351LL], ln, K, q);
            const float o[7] = {q.shift, q.stild, q.hw, q.ad, q.k3v, q.ya,
                                q.yb};
            for (int k = 0; k < 7; ++k)
                fwd[(k * (long long)L + r) * N + n] = o[k];
        }
        for (int i = 0; i < n_runs; ++i) {
            float acc[NA] = {0};
            for (int j = 0; j < runs[n_runs + i]; ++j) {
                const int n = perm[runs[i] + j];
                float gg[7];
                for (int k = 0; k < 7; ++k)
                    gg[k] = g[(k * (long long)L + r) * N + n];
                LineCols ln;
                load_line<IBRD>(cols.data(), words.data(), N, n, ln);
                Pair q;
                pair_fwd<IBRD, false>(rv, &wk[r * 39LL], &scor[r * 351LL],
                                      ln, K, q);
                pair_adj<IBRD>(rv, ln, K, q, gg, acc);
            }
            for (int k = 0; k < NA; ++k)
                part[((long long)r * n_runs + i) * NA + k] = acc[k];
        }
        row_adj<IBRD>(rv, &wk[r * 39LL], K, &part[(long long)r * n_runs * NA],
                      &runs[2 * n_runs], n_runs, &gp[r], &gt[r],
                      &gwk[r * 39LL], &gwb[r], &gsc[r * 351LL]);
    }
    put(out, fwd); put(out, gp); put(out, gt); put(out, gwk); put(out, gwb);
    put(out, gsc);
}

int main(int argc, char** argv) {
    FILE* in = fopen(argv[1], "rb");
    FILE* out = fopen(argv[2], "wb");
    int head[4];
    if (fread(head, sizeof(int), 4, in) != 4) return 2;
    if (head[0]) run<true>(in, out, head[1], head[2], head[3]);
    else run<false>(in, out, head[1], head[2], head[3]);
    fclose(out);
    return 0;
}
"""


def build_host(d: Path) -> Path:
    """The harness built in `d` (g++ -O2 -ffp-contract=off: no
    contraction, as nvcc -fmad=false builds the kernels)."""
    (d / "h.cpp").write_text(HARNESS)
    exe = d / "h"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    f"-I{CSRC}", "-o", str(exe), str(d / "h.cpp")],
                   check=True, capture_output=True, text=True)
    return exe


def run_host(exe: Path, cat, state, cfg, g):
    """The harness on a catalog, rows and cotangents (PER_LN order, None
    for zero): the seven operands {name: [L, N]} and the five gradients."""
    from monortm_tpu_torch.ops.linesum_kernel import prologue_consts
    pro = line_constants(cat)["pro"]
    p, t, wk, wbrod, scor = (v.float().contiguous() for v in state)
    L, n = p.shape[0], pro["words"].shape[0]
    wtot = torch.sum(wk, dim=-1) + wbrod
    zero = torch.zeros((L, n))
    gs = torch.stack([zero if v is None else v.float() for v in g])
    n_runs = pro["runs"].shape[1]
    d = exe.parent
    with open(d / "in.bin", "wb") as f:
        np.asarray([int(cfg.ibrd != 0), L, n, n_runs], np.int32).tofile(f)
        prologue_consts(cfg).tofile(f)
        for v in (pro["cols"], pro["words"], p, t, wtot, wk, scor, gs,
                  pro["perm"], pro["runs"]):
            v.contiguous().numpy().tofile(f)
    subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")],
                   check=True)
    o = np.fromfile(d / "out.bin", np.float32)
    sizes = [7 * L * n, L, L, L * 39, L, L * 351]
    parts = np.split(o, np.cumsum(sizes)[:-1])
    fwd = dict(zip(PER_LN, torch.as_tensor(parts[0]).reshape(7, L, n)))
    shapes = [(L,), (L,), (L, 39), (L,), (L, 351)]
    return fwd, [torch.as_tensor(a).reshape(s)
                 for a, s in zip(parts[1:], shapes)]


@pytest.fixture(scope="module")
def host_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    return build_host(tmp_path_factory.mktemp("prologue_host"))


def ulps(a, b):
    """Distance in float32 ulps of b's magnitude, elementwise."""
    a, b = a.double(), b.double()
    ulp = torch.as_tensor(np.spacing(np.abs(b.float().numpy()))).double()
    return (a - b).abs() / ulp.clamp_min(np.spacing(np.float32(1e-30)))


@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_host_header_forward_is_the_plain_prologue(host_exe, cfg):
    """Six operands within 8 float32 ulps of precompute_plain (PyTorch's
    CPU exp, expm1, pow and sqrt are not the host libm's: its float32
    sqrt is not even correctly rounded).  The pedestal k3v on the
    harness's own hw and ad: where sdep = 0 (plain Voigt) within 64 ulps
    of PyTorch's; where the speed-dependent two-point form subtracts two
    nearly equal terms, the header's and PyTorch's each within 16 ulps of
    those terms (`sd_term_ulp`) of the float64 evaluation."""
    cat = prologue_device_catalog()
    state = prologue_rows(n_rep=2, dtype=torch.float32)
    fwd, _ = run_host(host_exe, cat, state, CFGS[cfg], [None] * 7)
    ref = precompute_plain(cat, *state, CFGS[cfg])
    for k in PER_LN:
        if k != "k3v":
            u = ulps(fwd[k], ref[k])
            assert float(u.max()) <= 8, (k, float(u.max()))
    sdep = torch.broadcast_to(cat["sdep"], fwd["hw"].shape)
    d25 = torch.tensor(25.0)
    k32 = sdvoigt(d25, fwd["hw"], fwd["ad"], sdep)
    k64 = sdvoigt(d25.double(), fwd["hw"].double(), fwd["ad"].double(),
                  sdep.double(), f32_fallback=True)
    plain = sdep == 0.0
    assert plain.any() and (~plain).any()
    assert float(ulps(fwd["k3v"], k32)[plain].max()) <= 64
    scale = sd_term_ulp(fwd["hw"], fwd["ad"], sdep)
    for got in (fwd["k3v"], k32):
        err = (got.double() - k64).abs() / scale
        assert float(err[~plain].max()) <= 16, float(err[~plain].max())


def sd_term_ulp(hw, ad, sdep):
    """One float32 ulp of the terms w(z1), w(z2) whose difference is an
    SD-Voigt pedestal sdvoigt(25, hw, ad), in the pedestal's units
    (Re w(z) ~ 1 / (sqrt(pi) |z|) in Humlicek's outer region)."""
    hw, ad, sdep = hw.double(), ad.double(), sdep.double()
    g2 = hw * sdep
    alfa, beta = hw / g2 - 1.5, 25.0 / g2
    delta = 0.25 / np.log(2.0) * (ad / g2) ** 2
    tmp = torch.sqrt((alfa + delta) ** 2 + beta ** 2)
    x1 = torch.sqrt((tmp + alfa + delta) / 2.0) - torch.sqrt(delta)
    y1 = torch.sqrt(torch.clamp_min((tmp - delta - alfa) / 2.0, 0.0))
    w = 0.5641896 / torch.hypot(x1, y1)
    return torch.as_tensor(np.spacing(w.float().numpy())).double() \
        * 0.46971863934982516 / ad


@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("lorentz", [False, True])
def test_host_header_adjoint_is_the_plain_adjoint(host_exe, cfg, lorentz):
    """The header's pair adjoint, summed per row over the runs and
    through row_adj, against precompute_bwd_plain in float32: 1e-6 of
    each gradient's norm (the two forwards differ by a few ulps)."""
    cat = prologue_device_catalog()
    state = prologue_rows(n_rep=2, dtype=torch.float32)
    g = line_sum_cotangents(cat, state, CFGS[cfg], torch.float32, lorentz)
    _, got = run_host(host_exe, cat, state, CFGS[cfg], g)
    ref = precompute_bwd_plain(cat, *state, CFGS[cfg], g)
    for name, a, b in zip(GRADS, got, ref):
        assert rel_err(a, b) <= 1e-6, (name, rel_err(a, b))


# ---- the packed catalog, and the dispatch on the CPU ---------------------

def test_line_constants_pack_the_catalog():
    """The packed columns are the catalog's; each word decodes to the
    line's molecule, isotopologue, mixing, xg and IBRD flags; the runs
    take every line once, in catalog order within one isotopologue, at
    most RUN_LINES each."""
    cat = prologue_device_catalog(n=9000)
    pro = line_constants(cat)["pro"]
    n = cat["mol"].shape[0]
    k = 0
    for name in PRO_COLS:
        col = cat[name].reshape(n, -1).T
        assert torch.equal(pro["cols"][k:k + col.shape[0]], col), name
        k += col.shape[0]
    assert k == pro["cols"].shape[0] == 47
    w = pro["words"].to(torch.int64)
    assert torch.equal(w & 0x3f, cat["mol"] - 1)
    assert torch.equal((w >> 6) & 0x1ff, cat["iso_flat"])
    assert torch.equal((w >> 15) & 1, cat["self_mix"].to(torch.int64))
    assert torch.equal((w >> 16) & 1, (cat["xg"] == -1).to(torch.int64))
    assert torch.equal((w >> 17) & 1, (cat["xg"] == -3).to(torch.int64))
    for j in range(7):
        assert torch.equal((w >> (20 + j)) & 1, cat["brd_flg"][:, j])
    perm, runs = pro["perm"].to(torch.int64), pro["runs"].to(torch.int64)
    seen = torch.cat([perm[s:s + c] for s, c in zip(runs[0], runs[1])])
    assert torch.equal(seen, perm) and torch.equal(seen.sort().values,
                                                   torch.arange(n))
    assert int(runs[1].max()) == RUN_LINES and int(runs[1].min()) > 0
    for s, c, iso in runs.T.tolist():
        lines = perm[s:s + c]
        assert bool((cat["iso_flat"][lines] == iso).all())
        assert bool((lines[1:] > lines[:-1]).all())
    assert runs[2].tolist() == sorted(runs[2].tolist())


@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_precompute_on_the_cpu_is_the_plain_prologue(cfg):
    """CPU tensors take the eager prologue: the same bits and graph."""
    cat = prologue_device_catalog()
    state = prologue_rows(dtype=torch.float32)
    got = precompute(cat, *state, CFGS[cfg])
    ref = precompute_plain(cat, *state, CFGS[cfg])
    for k in PER_LN:
        assert torch.equal(got[k], ref[k]), k
    const = line_constants(cat)
    for k in ("sdep", "nu_hi", "nu_lo", "bits", "mol0"):
        assert torch.equal(got[k], const[k]), k


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def card_rows(n_rep, device):
    return prologue_rows(n_rep=n_rep, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("n_rep", [40, 320])
def test_card_forward_is_the_plain_prologue_bit_for_bit(card, cfg, n_rep):
    """8 x 40 and 64 x 40 rows: the kernel's seven operands are
    precompute_plain's on the same CUDA tensors, bit for bit."""
    from monortm_tpu_torch.ops.linesum import PROLOGUE_KERNEL
    cat = prologue_device_catalog(device=card)
    state = card_rows(n_rep, card)
    n0 = PROLOGUE_KERNEL.launches
    got = precompute(cat, *state, CFGS[cfg])
    ref = precompute_plain(cat, *state, CFGS[cfg])
    assert PROLOGUE_KERNEL.launches == n0 + 1
    bad = {k: float(ulps(got[k], ref[k]).max()) for k in PER_LN
           if not torch.equal(got[k], ref[k])}
    assert not bad, bad


def card_grads(cat, state, cfg, g, plain=False):
    leaves = [v.clone().requires_grad_() for v in state]
    pre = (precompute_plain if plain else precompute)(cat, *leaves, cfg)
    outs = [(k, v) for k, v in zip(PER_LN, g) if v is not None]
    return torch.autograd.grad([pre[k] for k, _ in outs], leaves,
                               [v for _, v in outs])


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", sorted(CFGS))
@pytest.mark.parametrize("lorentz", [False, True])
def test_card_adjoint_is_the_plain_adjoint(card, cfg, lorentz):
    """The adjoint kernel on the line sum's own cotangents: twice the same
    bits, and within 1e-6 of each gradient's norm of precompute_bwd_plain
    and of autograd through precompute_plain."""
    from monortm_tpu_torch.ops.linesum import PROLOGUE_KERNEL
    cat = prologue_device_catalog(device=card)
    state = card_rows(40, card)
    g = line_sum_cotangents(cat, state, CFGS[cfg], torch.float32, lorentz)
    n0 = PROLOGUE_KERNEL.bwd_launches
    got = card_grads(cat, state, CFGS[cfg], g)
    again = card_grads(cat, state, CFGS[cfg], g)
    assert PROLOGUE_KERNEL.bwd_launches == n0 + 2
    for name, a, b in zip(GRADS, got, again):
        assert torch.equal(a, b), name
    plain = precompute_bwd_plain(cat, *state, CFGS[cfg], g)
    eager = card_grads(cat, state, CFGS[cfg], g, plain=True)
    for name, a, b, c in zip(GRADS, got, plain, eager):
        assert rel_err(a, b) <= 1e-6, (name, rel_err(a, b))
        assert rel_err(a, c) <= 1e-6, (name, rel_err(a, c))


@pytest.mark.cuda
def test_card_retrieval_step_launches(card):
    """One value_and_grad step at the retrieval cell's shape (8 x 40
    layers, a 55-line microwave catalog): the prologue launches once per
    engine each way, and the profiler counts at most
    chip_smoke.PRO_SPAN_LIMIT kernels in the `lines` and `lines.bwd`
    spans (some 5000 with the eager prologue)."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    cs.FAILED.clear()
    out = cs.phase16_step(card)
    assert not cs.FAILED, cs.FAILED
    assert sum(out["span_kernels"].values()) <= cs.PRO_SPAN_LIMIT
    n = 2 if out["engine"] == "hybrid" else 1
    assert out["prologue_launches"] == [n, n]
