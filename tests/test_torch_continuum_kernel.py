"""The continuum and cloud kernels (csrc/continuum.cu) and the eager stage.

On the CPU:
- csrc/continuum_math.cuh compiled on the host (g++, without contraction
  as nvcc -fmad=false builds the kernels, and with CONT_TRUE_SCALAR_DIV:
  PyTorch's CPU kernels divide by a Python number where its CUDA kernels
  multiply by the reciprocal), the kernels' work repeated on the host in
  their order: each sub-continuum's window values and Rayleigh's ABSRB
  term against `ContinuumPlan`'s eager float32 ones (bit for bit where no
  exp or pow enters; the host's libm is not PyTorch's, so within a few
  ulps where one does), the ABSRB values and the seven outputs against
  the eager ones, and the adjoint, summed per row in the kernel's fixed
  order, against autograd through the eager stage in float32 and float64
  (`check_adjoint`: 1e-6 of each gradient's norm, or four times float32
  autograd's own distance from float64 where that is larger, as in t's
  gradient through the cloud), on three grids: the microwave grid of the
  retrieval cell (four sub-continua), the envelope's 0.3-55 cm^-1 and
  phase 10's infrared-to-UV grid (every sub-continuum and Rayleigh),
  with nmol 22, 7 and 39.
- `ops.continuum_kernel.pack`: the packed tables are the float64 tables
  cast once, the taps and weights the plans'.
- An `ODModel` on CPU tensors takes the eager stage, bit for bit.

On the card (marked `cuda`, skipped without one; `python -m pytest
tests -m cuda -n 0` there): the forward's seven outputs against the eager
CUDA stage bit for bit at 8 x 40 and 64 x 40 rows and on the infrared
grid; the adjoint twice with the same bits and against autograd through
the eager CUDA stage (`check_adjoint`); one value_and_grad
step at the retrieval shape: one call of each entry point, and the
kernels inside the `continuum` and `continuum.bwd` spans (chip_smoke's
phase 17, which adds the kernels' times).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from monortm_tpu_torch.ops.cloud import od_clw
from monortm_tpu_torch.ops.continuum import (CONTINUUM_KERNEL, SPECIES,
                                             ContinuumPlan, _Layer)
from monortm_tpu_torch.ops.continuum_kernel import (COLUMNS, FLT_ARRAYS,
                                                    INT_ARRAYS, KINDS,
                                                    LAYOUT, OUTPUTS, pack)
from monortm_tpu_torch.ops.planck import radfn
from monortm_tpu_torch.testing import (continuum_cotangents as cotangents,
                                       continuum_eager as eager,
                                       continuum_grid, continuum_rows as rows,
                                       synthetic_state)

CSRC = Path(__file__).resolve().parents[1] / "monortm_tpu_torch" / "csrc"
GRADS = ("p", "t", "wk", "wbrod", "clw")
# grid name -> nmol of the plan
GRIDS = {"mw": 22, "envelope": 7, "ir": 39}
# kinds whose value takes an exp or a pow
LIBM = {"h2o_self", "co2_frgn", "o2_fund", "n2_rt", "n2_fund"}
# the adjoint against autograd: the repository's tolerance, in units of
# each gradient's norm, and the factor on float32 autograd's own distance
# from float64 where that is larger (chip_smoke.PRO_F32_FACTOR)
ADJ_TOL, F32_FACTOR = 1e-6, 4.0


def plan_of(grid, device="cpu"):
    wn, dvset = continuum_grid(grid)
    return ContinuumPlan(wn, dvset=dvset, nmol=GRIDS[grid], device=device)


def rel_err(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


def ulps(a, b):
    """Distance in float32 ulps of b's magnitude, elementwise."""
    a, b = a.double(), b.double()
    ulp = torch.as_tensor(np.spacing(np.abs(b.float().cpu().numpy())),
                          device=b.device).double()
    return (a - b).abs() / ulp.clamp_min(np.spacing(np.float32(1e-30)))


# ---- csrc/continuum_math.cuh on the host ---------------------------------

HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#define __device__
#define __forceinline__ inline
#define CONT_TRUE_SCALAR_DIV
#include "continuum_math.cuh"
using namespace cont;

template <typename T> static std::vector<T> get(FILE* f, long long n) {
    std::vector<T> v(n);
    if (n && fread(v.data(), sizeof(T), n, f) != (size_t)n) exit(3);
    return v;
}
template <typename T> static void put(FILE* f, const std::vector<T>& v) {
    fwrite(v.data(), sizeof(T), v.size(), f);
}

// the kernels' work on the host, in their orders: the rows' window
// values, ABSRB values and outputs, then each row's adjoint as cont_bwd's
// block forms it (thread-strided sums folded by the same tree)
int main(int argc, char** argv) {
    FILE* in = fopen(argv[1], "rb");
    FILE* out = fopen(argv[2], "wb");
    int head[5];
    if (fread(head, sizeof(int), 5, in) != 5) return 2;
    const int R = head[0], mask = head[3];
    auto lay = get<long long>(in, N_LAYOUT);
    auto ints = get<int>(in, head[1]);
    auto flts = get<float>(in, head[2]);
    const double teff = get<double>(in, 1)[0];
    const Plan P = plan_of(ints.data(), flts.data(), lay.data(), teff);
    auto p = get<float>(in, R), t = get<float>(in, R);
    auto wk = get<float>(in, R * 39LL);
    auto wb = get<float>(in, R), clw = get<float>(in, R),
         wtot = get<float>(in, R);
    const long long RW = (long long)R * P.n_wn;
    std::vector<std::vector<float>> g(N_OUT);
    Cot G;
    for (int q = 0; q < N_OUT; ++q) {
        if (mask >> q & 1) g[q] = get<float>(in, RW);
        G.g[q] = (mask >> q & 1) ? g[q].data() : nullptr;
    }
    const int nab = N_SPECIES * P.nptabs;
    std::vector<float> win((long long)R * P.n_win), ab((long long)R * nab),
        outs(N_OUT * RW), rf(RW), gp(R), gt(R), gwk(R * 39LL), gwb(R),
        gcl(R);
    std::vector<double> gab(nab);
    for (int r = 0; r < R; ++r) {
        const Row<float> L = head[4]
            ? row_of<float>(p[r], t[r], wk[r * 39LL], wk[r * 39LL + 1],
                            wk[r * 39LL + 2], wk[r * 39LL + 6], wtot[r])
            : row_in(p[r], t[r], &wk[r * 39LL], wb[r], P.nmol);
        for (int s = 0; s < P.n_subs; ++s) {
            const int* m = P.meta + s * META;
            for (int j = 0; j < m[M_NPTC]; ++j)
                win[(long long)r * P.n_win + m[M_WIN] + j] =
                    sub_value<float>(sub_view(P, s), j, L, P.teff);
        }
        float* a = &ab[(long long)r * nab];
        for (int i = 0; i < nab; ++i)
            a[i] = absrb_value(P, L, i / P.nptabs, i % P.nptabs);
        const CloudRow<float> c = cloud_row(t[r]);
        const CloudRow<Dual1> cd = cloud_row(seed<1>(t[r], 0));
        for (int w = 0; w < P.n_wn; ++w) {
            float o[N_OUT];
            col_values(P, a, w, L.xkt, c, clw[r], o);
            for (int q = 0; q < N_OUT; ++q)
                outs[q * RW + (long long)r * P.n_wn + w] = o[q];
        }
        if (!mask) continue;
        Cot Gr;
        for (int q = 0; q < N_OUT; ++q)
            Gr.g[q] = G.g[q] ? G.g[q] + (long long)r * P.n_wn : nullptr;
        static double red[N_FOLD][BWD_THREADS];
        for (int i = 0; i < BWD_THREADS; ++i) {
            double acc[N_COLSUM] = {0};
            for (int w = i; w < P.n_wn; w += BWD_THREADS)
                rf[(long long)r * P.n_wn + w] = col_adjoint(
                    P, a, w, w, L.xkt, c, cd, clw[r], Gr, acc);
            for (int q = 0; q < N_COLSUM; ++q) red[q][i] = acc[q];
        }
        for (int s = BWD_THREADS / 2; s > 0; s >>= 1)
            for (int i = 0; i < s; ++i)
                for (int q = 0; q < N_COLSUM; ++q) red[q][i] += red[q][i + s];
        double col[N_COLSUM];
        for (int q = 0; q < N_COLSUM; ++q) col[q] = red[q][0];
        for (int j = 0; j < nab; ++j) {
            double v[WARP];
            for (int l = 0; l < WARP; ++l)
                v[l] = absrb_adjoint(P, j / P.nptabs, j % P.nptabs,
                                     Gr.g[j / P.nptabs],
                                     &rf[(long long)r * P.n_wn], l);
            for (int off = WARP / 2; off > 0; off /= 2)
                for (int l = 0; l < off; ++l) v[l] += v[l + off];
            gab[j] = v[0];
        }
        const Row<Dual> LD = row_dual(L);
        const int n_pts = P.n_win + (P.has_ray ? P.nptabs : 0);
        for (int i = 0; i < BWD_THREADS; ++i) {
            double prim[N_PRIM] = {0};
            for (int j = i; j < n_pts; j += BWD_THREADS)
                point_adjoint(P, j, gab.data(), LD, prim);
            for (int q = 0; q < N_PRIM; ++q) red[q][i] = prim[q];
        }
        for (int s = BWD_THREADS / 2; s > 0; s >>= 1)
            for (int i = 0; i < s; ++i)
                for (int q = 0; q < N_PRIM; ++q) red[q][i] += red[q][i + s];
        double prim[N_PRIM];
        for (int q = 0; q < N_PRIM; ++q) prim[q] = red[q][0];
        row_grads(P, prim, col, &gp[r], &gt[r], &gwk[r * 39LL], &gwb[r],
                  &gcl[r]);
    }
    put(out, win); put(out, ab); put(out, outs); put(out, gp); put(out, gt);
    put(out, gwk); put(out, gwb); put(out, gcl);
    fclose(out);
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_exe(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    d = tmp_path_factory.mktemp("continuum_host")
    (d / "h.cpp").write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    f"-I{CSRC}", "-o", str(d / "h"), str(d / "h.cpp")],
                   check=True, capture_output=True, text=True)
    return d / "h"


def run_host(exe: Path, plan, state, g=None, wtot=True):
    """The harness on a CPU plan, flat rows and cotangents (OUTPUTS order,
    None for zero; no adjoint without g).  wtot: take the rows' column sum
    from PyTorch's CPU sum (whose order is not the card's).  Returns the
    window values [R, n_win], ABSRB [R, 6, nptabs], the seven outputs and
    the five gradients."""
    pk = pack(plan)
    p, t, wk, wbrod, clw = (v.float().contiguous() for v in state)
    R, W, n_abs = p.shape[0], pk["n_wn"], pk["nptabs"]
    lay = pk["layout"]
    n_win = int(lay[LAYOUT.index("n_win")])
    wt = wbrod + torch.sum(wk[..., :plan.nmol], dim=-1)
    g = [None] * 7 if g is None else g
    mask = sum(1 << q for q, v in enumerate(g) if v is not None)
    d = exe.parent
    with open(d / "in.bin", "wb") as f:
        np.asarray([R, pk["ints"].numel(), pk["flts"].numel(), mask,
                    int(wtot)], np.int32).tofile(f)
        lay.tofile(f)
        pk["ints"].numpy().tofile(f)
        pk["flts"].numpy().tofile(f)
        np.asarray([pk["teff"]], np.float64).tofile(f)
        for v in (p, t, wk, wbrod, clw, wt):
            v.numpy().tofile(f)
        for v in g:
            if v is not None:
                v.float().contiguous().numpy().tofile(f)
    subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")],
                   check=True)
    o = np.fromfile(d / "out.bin", np.float32)
    sizes = [R * n_win, R * 6 * n_abs, 7 * R * W, R, R, R * 39, R, R]
    parts = [torch.as_tensor(a) for a in np.split(o, np.cumsum(sizes)[:-1])]
    grads = [parts[3], parts[4], parts[5].reshape(R, 39), parts[6],
             parts[7]]
    return (parts[0].reshape(R, n_win), parts[1].reshape(R, 6, n_abs),
            list(parts[2].reshape(7, R, W)), grads)


def eager_windows(plan, p, t, wk, wbrod):
    """Each sub-continuum's eager window values, concatenated [R, n_win],
    and the eager ABSRB values [R, 6, nptabs] (Rayleigh's term last)."""
    L = _Layer(p, t, wk, wbrod, plan.nmol)
    R = p.shape[0]
    absrb = torch.zeros((R, 6, plan.nptabs))
    win = []
    for sub in plan.subs:
        s = {k: v.to(torch.float32) for k, v in sub.dstatic.items()}
        vals = sub.fn(s, L)
        win.append(vals)
        i = SPECIES.index(sub.species)
        absrb[:, i] = sub.dplan.apply(vals, absrb[:, i].clone())
    if plan.rayleigh_base is not None:
        v, base = (a.to(torch.float32) for a in plan.rayleigh_base)
        absrb[:, 5] = base * L.wtot[..., None] / radfn(v, L.xkt[..., None])
    return torch.cat(win, dim=1), absrb


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_host_forward_is_the_eager_stage(host_exe, grid):
    """Window values: bit for bit for kinds without exp or pow, within 4
    ulps for those with; Rayleigh's ABSRB term within 4 ulps; the ABSRB
    values and the seven outputs within 1e-6 of each output's largest
    value (the XINT weights' signs mix, so an ulp of a window value is
    no ulp of the sum), and the species' outputs within 8 ulps times
    radfn's amplification of an ulp of exp besides (`radfn_cond`: the
    host's expf and PyTorch's CPU exp differ by an ulp here and there)."""
    plan = plan_of(grid)
    state = rows()
    win, ab, outs, _ = run_host(host_exe, plan, state)
    ref_win, ref_ab = eager_windows(plan, *state[:4])
    k = 0
    for sub in plan.subs:
        n = sub.static["vj"].shape[0]
        u = float(ulps(win[:, k:k + n], ref_win[:, k:k + n]).max())
        assert u <= (4 if sub.name in LIBM else 0), (sub.name, u)
        k += n
    if plan.rayleigh_base is not None:
        assert float(ulps(ab[:, 5], ref_ab[:, 5]).max()) <= 4
    for i in range(6):
        scale = float(ref_ab[:, i].abs().max())
        assert float((ab[:, i] - ref_ab[:, i]).abs().max()) \
            <= 1e-6 * scale, SPECIES[i]
    cond = radfn_cond(plan, state[1])
    for name, a, b in zip(OUTPUTS, outs, eager(plan, *state)):
        tol = 1e-6 * float(b.abs().max())
        if name in SPECIES[:-1]:
            tol = tol + 8 * cond * torch.as_tensor(np.spacing(
                np.abs(b.numpy())))
        d = (a - b).abs() - tol
        at = np.unravel_index(int(d.argmax()), d.shape)
        assert float(d.max()) <= 0, (name, at, float(a[at]), float(b[at]))
        assert bool(((a == 0) == (b == 0)).all()), name


def radfn_cond(plan, t):
    """By how much radfn(wn, t / RADCN2) multiplies a relative error of
    exp(-x), x = wn RADCN2 / t [R, W]: 1 / x in its middle branch
    (0.01 < x <= 10), where wn (1 - e) / (1 + e) cancels, else 1."""
    from monortm_tpu_torch import constants as cst
    x = torch.as_tensor(plan.wn)[None, :] / (t.double()[:, None]
                                             / cst.RADCN2)
    return torch.where((x > 0.01) & (x <= 10.0), 1.0 / x,
                       torch.ones_like(x)).float()


def autograd_grads(plan, state, g, dtype=torch.float32):
    """Autograd through the eager stage at `dtype` (the float32 rows and
    cotangents promoted for float64)."""
    leaves = [v.detach().to(dtype).clone().requires_grad_() for v in state]
    outs = eager(plan, *leaves, dtype=dtype)
    pairs = [(o, v.to(dtype)) for o, v in zip(outs, g)
             if v is not None and o.requires_grad]
    return torch.autograd.grad([o for o, _ in pairs], leaves,
                               [v for _, v in pairs], allow_unused=True)


def check_adjoint(got, ref32, ref64) -> dict:
    """Each gradient against autograd in float32 and in float64: within
    ADJ_TOL of its norm, or, where float32 autograd is itself further
    from float64 than ADJ_TOL / F32_FACTOR, within F32_FACTOR times that
    distance (phase 16's rule at the envelope).  Returns the readings."""
    out = {}
    for name, a, b, c in zip(GRADS, got, ref32, ref64):
        if b is None:
            assert not a.any(), name
            continue
        assert torch.isfinite(a).all(), name
        own = rel_err(b, c)
        tol = max(ADJ_TOL, F32_FACTOR * own)
        out[name] = (rel_err(a, b), rel_err(a, c), own)
        assert out[name][0] <= tol and out[name][1] <= tol, (name,
                                                             out[name])
    return out


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("kind", ["random", "shared", "cloud"])
def test_host_adjoint_is_autograd(host_exe, grid, kind):
    """The header's adjoint, in the kernel's order, against autograd
    through the eager stage (check_adjoint); p, wk and wbrod within
    ADJ_TOL of float32 autograd whatever the cotangents."""
    plan = plan_of(grid)
    state = rows()
    g = cotangents(plan, state[0].shape[0], kind)
    *_, got = run_host(host_exe, plan, state, g)
    errs = check_adjoint(got, autograd_grads(plan, state, g),
                         autograd_grads(plan, state, g, torch.float64))
    for name in ("p", "wk", "wbrod"):
        if name in errs:
            assert errs[name][0] <= ADJ_TOL, (name, errs[name])


# ---- the packed plan, and the dispatch on the CPU ------------------------

@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_pack_is_the_plan(grid):
    """The packed columns are the float64 tables cast once; the taps and
    weights are the plans'; every tap of a plan is in its reverse map
    once."""
    plan = plan_of(grid)
    pk = pack(plan)
    lay = dict(zip(LAYOUT, pk["layout"].tolist()))
    ints, flts = pk["ints"].to(torch.int64), pk["flts"]
    i_end = dict(zip(INT_ARRAYS, list(lay.values())[1:len(INT_ARRAYS)]
                     + [ints.numel()]))
    f_end = dict(zip(FLT_ARRAYS, [lay[k] for k in FLT_ARRAYS[1:]]
                     + [flts.numel()]))
    arr = lambda k: (ints[lay[k]:i_end[k]] if k in INT_ARRAYS
                     else flts[lay[k]:f_end[k]])
    meta = arr("meta").reshape(-1, 9)
    assert lay["n_subs"] == len(plan.subs) == meta.shape[0]
    for s, sub in enumerate(plan.subs):
        kind, sp, nptc, col, t0, nt, ent, rev, win = meta[s].tolist()
        assert KINDS[kind] == sub.name and SPECIES[sp] == sub.species
        for q, key in enumerate(COLUMNS[sub.name]):
            got = arr("cols")[col + q * nptc:col + (q + 1) * nptc]
            assert torch.equal(got, torch.as_tensor(
                sub.static[key]).to(torch.float32)), (sub.name, key)
        assert t0 + nt <= plan.nptabs
        assert np.array_equal(sub.plan.target_idx, t0 + np.arange(nt))
        assert np.array_equal(arr("s1_src")[ent:ent + nt].numpy(),
                              sub.plan.src_idx)
        assert torch.equal(arr("s1_w")[4 * ent:4 * (ent + nt)],
                           torch.as_tensor(sub.plan.weights.reshape(-1))
                           .to(torch.float32))
        ptr = arr("s1_rptr")[rev:rev + nptc + 1]
        codes = arr("s1_rev")[int(ptr[0]):int(ptr[-1])]
        taps = (sub.plan.src_idx[:, None] - 3 + np.arange(4))
        n_in = int(((taps >= 0) & (taps < nptc)).sum())
        assert len(codes) == n_in and len(set(codes.tolist())) == n_in
    src2 = arr("s2_src")
    tgt = plan.stage2.target_idx
    assert np.array_equal(src2[tgt].numpy(), plan.stage2.src_idx)
    assert int((src2 >= 0).sum()) == len(tgt)
    w2 = arr("s2_w").reshape(-1, 4)
    assert torch.equal(w2[tgt], torch.as_tensor(plan.stage2.weights)
                       .to(torch.float32))
    assert torch.equal(arr("wn"), torch.as_tensor(plan.wn).to(torch.float32))
    assert lay["has_ray"] == (plan.rayleigh_base is not None)
    assert arr("s2_rev").numel() == int(arr("s2_rptr")[-1])


def test_model_on_the_cpu_takes_the_eager_stage():
    """An ODModel on CPU tensors (float32 and float64) takes the eager
    continuum and cloud: the same bits as the plan and od_clw, and no
    kernel call."""
    from monortm_tpu_torch.models.od import ODModel
    from monortm_tpu_torch.testing import synthetic_catalog_mw
    wn, dvset = continuum_grid("mw")
    for dtype in (torch.float32, torch.float64):
        m = ODModel(wn, dvset, synthetic_catalog_mw(n_h2o=4, n_o2=4),
                    nmol=22, device="cpu", dtype=dtype,
                    kernels=dtype == torch.float32)
        st = synthetic_state(nlay=6, batch=2, device="cpu", dtype=dtype)
        n0 = CONTINUUM_KERNEL.launches
        res = m(st)
        assert CONTINUUM_KERNEL.launches == n0
        oc = m.cont(st.p, st.t, st.wkl, st.wbrodl, dtype=dtype)
        for k in SPECIES:
            assert torch.equal(res.oc[k], oc[k]), k
        assert torch.equal(res.od_clw, od_clw(m.wn_t, st.t[..., None],
                                              st.clw[..., None]))
        assert m.cont.kernel_pack is None


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def kernel_outs(plan, state):
    oc, cl = CONTINUUM_KERNEL(plan, *state[:4], state[4])
    return [oc[k] for k in SPECIES] + [cl]


@pytest.mark.cuda
@pytest.mark.parametrize("grid,batch", [("mw", 8), ("mw", 64), ("ir", 8)])
def test_card_forward_is_the_eager_stage_bit_for_bit(card, grid, batch):
    """The seven outputs are the eager CUDA stage's on the same tensors,
    bit for bit, in one call of the forward's entry point."""
    plan = plan_of(grid, card)
    state = rows(batch=batch, device=card)
    n0 = CONTINUUM_KERNEL.launches
    with torch.no_grad():
        got = kernel_outs(plan, state)
        ref = eager(plan, *state)
    assert CONTINUUM_KERNEL.launches == n0 + 1
    bad = {k: float(ulps(a, b).max()) for k, a, b in zip(OUTPUTS, got, ref)
           if not torch.equal(a, b)}
    assert not bad, bad


def card_grads(plan, state, g, eager_path=False):
    leaves = [v.detach().clone().requires_grad_() for v in state]
    outs = eager(plan, *leaves) if eager_path else kernel_outs(plan, leaves)
    pairs = [(o, v) for o, v in zip(outs, g)
             if v is not None and o.requires_grad]
    return torch.autograd.grad([o for o, _ in pairs], leaves,
                               [v for _, v in pairs], allow_unused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["mw", "ir"])
@pytest.mark.parametrize("kind", ["random", "shared"])
def test_card_adjoint_is_autograd(card, grid, kind):
    """The adjoint twice with the same bits, one call of its entry point
    each, and against autograd through the eager CUDA stage in float32
    and float64 (check_adjoint)."""
    plan = plan_of(grid, card)
    state = rows(device=card)
    g = cotangents(plan, state[0].shape[0], kind, device=card)
    n0 = CONTINUUM_KERNEL.bwd_launches
    got = card_grads(plan, state, g)
    again = card_grads(plan, state, g)
    assert CONTINUUM_KERNEL.bwd_launches == n0 + 2
    for name, a, b in zip(GRADS, got, again):
        assert torch.equal(a, b), name
    check_adjoint(got, card_grads(plan, state, g, eager_path=True),
                  autograd_grads(plan, state, g, torch.float64))


@pytest.mark.cuda
def test_card_retrieval_step_calls(card):
    """One value_and_grad step at the retrieval cell's shape: one call of
    each entry point, and at most chip_smoke.CONT_SPAN_LIMIT kernels in
    the `continuum` and `continuum.bwd` spans (917 with the eager
    stage)."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    cs.FAILED.clear()
    out = cs.phase17_step(card)
    assert not cs.FAILED, cs.FAILED
    assert out["continuum_calls"] == [1, 1]
    assert sum(out["span_kernels"].values()) <= cs.CONT_SPAN_LIMIT
