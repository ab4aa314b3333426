// Device math of the LINES prologue kernels (prologue.cu): the operands
// of the line sum for one (layer row, line) pair, as the plain PyTorch
// `ops.lineshape.line_params` + `ops.linesum.precompute_plain` form them
// (INITI, the LINES preamble, INTENS, HALFWHM_C/_D with line coupling and
// the IBRD=1 adjustments, modm.f90:301-380, 442-454, 833-865; the
// 25 cm^-1 pedestal), and their adjoint.
//
// Forward (`pair_fwd`): every operation of the PyTorch version, in its
// order, in float.  Where PyTorch combines a tensor with a Python number
// it does so with the number rounded to float, and it divides by a
// number as a multiply by the number's float reciprocal; the wrapper
// forms those floats on the host (ops/linesum_kernel.py,
// `prologue_consts`) and the kernel multiplies by them (Consts).  The
// 39-term sum wtot = sum(wk) + wbrod is PyTorch's own, made by the
// wrapper, since its summation order is the library's.  Built without
// contraction (-fmad=false) and with IEEE division, sqrt, exp, expm1 and
// pow, the seven operands are meant to be the PyTorch version's bit for
// bit.
//
// Adjoint (`pair_adj`): the partials of the seven operands by the row's
// state in closed form, written out by hand from the same operations,
// with the pedestal's partials by (hw, ad) from sdvoigt<Dual64>, as the
// line-sum adjoint takes an SD-Voigt lane's (linesum_math.cuh, sd_shape).
// A pair gives the row's partial sums that do not depend on which column
// of wk or scor it reads (Adj: rhorat, t, rp, rp2, the seven IBRD=1
// densities) and two that do (the molecule's density rho_mol and the
// isotopologue's TIPS ratio); the kernels sum them per row in a fixed
// order and apply the row's own chain (row_adj).
//
// Like linesum_math.cuh this header uses no CUDA runtime API, so a host
// compiler builds it too (tests/test_torch_prologue.py).

#pragma once

#include "linesum_math.cuh"

namespace prologue {

using linesum::Dual64;
using linesum::var;

// the floats PyTorch forms from the Python constants of line_params, in
// the order of ops/linesum_kernel.py's PROLOGUE_CONSTS
struct Consts {
    float boltz;       // BOLTZ * t
    float k1000;       // * 1.0e3
    float inv_xn0;     // / xn0
    float inv_p0;      // / 1013.25
    float inv_t0;      // / T0
    float neg_radct;   // -RADCT *
    float inv_t0_sub;  // - 1.0 / T0
    float inv_clight;  // / CLIGHT
    float dop;         // 2.0 * LN2 * BOLTZ * t
    float avogad;      // * AVOGAD
    float sclcpl, y0res, sclhw;
};
constexpr int N_CONSTS = 13;

// per-line columns of the packed [N_COLS, N] catalog (linesum.PRO_COLS)
enum Col {
    C_NU_HI, C_NU_LO, C_PSHIFT, C_S0ADJ, C_E, C_ALPF, C_ALPS, C_TDEP,
    C_MASS, C_SDEP, C_A1, C_B1 = C_A1 + 4, C_A2 = C_B1 + 4, C_B2 = C_A2 + 4,
    C_BRD_HW = C_B2 + 4, C_BRD_TMP = C_BRD_HW + 7,
    C_BRD_SHFT = C_BRD_TMP + 7, N_COLS = C_BRD_SHFT + 7
};
// the per-line word (linesum.line_constants): 0-based molecule, flat
// isotopologue, -5 self mixing, xg == -1, xg == -3, IBRD molecule flags
constexpr int W_MOL = 0x3f, W_ISO_SHIFT = 6, W_ISO = 0x1ff, W_MIX = 1 << 15,
              W_XG1 = 1 << 16, W_XG3 = 1 << 17, W_BRD_SHIFT = 20;
constexpr int N_BRD = 7;

__device__ __forceinline__ int word_mol(int w) { return w & W_MOL; }
__device__ __forceinline__ int word_iso(int w) {
    return (w >> W_ISO_SHIFT) & W_ISO;
}

// One line's columns.
struct LineCols {
    float c[N_COLS];
    int word;
};

template <bool IBRD>
__device__ __forceinline__ void load_line(const float* cols, const int* words,
                                          long long n_lines, long long n,
                                          LineCols& ln) {
    constexpr int n_read = IBRD ? N_COLS : C_BRD_HW;
#pragma unroll
    for (int k = 0; k < n_read; ++k) ln.c[k] = cols[k * n_lines + n];
    ln.word = words[n];
}

// The row's scalars (INITI + the LINES preamble, modm.f90:301-314, 868-883)
struct RowVals {
    float p, t, wtot;
    float q, u, xn, rhorat, rp, rp2, rt;
};

__device__ __forceinline__ RowVals row_vals(float p, float t, float wtot,
                                            const Consts& K) {
    RowVals r;
    r.p = p;
    r.t = t;
    r.wtot = wtot;
    r.q = t * K.boltz;
    r.u = p / r.q;
    r.xn = r.u * K.k1000;
    r.rhorat = r.xn * K.inv_xn0;
    r.rp = p * K.inv_p0;
    r.rp2 = r.rp * r.rp;
    r.rt = t * K.inv_t0;
    return r;
}

// a value of a coefficient row of 4 temperatures, selected, not indexed,
// so that the columns stay in registers
__device__ __forceinline__ float pick(const float* c, int k) {
    return k == 0 ? c[0] : (k == 1 ? c[1] : (k == 2 ? c[2] : c[3]));
}
// TEMPLC (modm.f90:305), the temperatures of the coupling rows
__device__ __forceinline__ float templc(int k) {
    return k == 0 ? 200.0f : (k == 1 ? 250.0f : (k == 2 ? 296.0f : 340.0f));
}

// The TEMPLC interval of t (searchsorted(TEMPLC[1:], t, right) clamped to
// [0, 2]), its reciprocal width and t's offset in it (modm.f90:305-314)
struct Interval {
    int ilc;
    float rectlc, tmpdif;
};

__device__ __forceinline__ Interval interval(float t) {
    Interval v;
    v.ilc = (templc(1) <= t) + (templc(2) <= t) + (templc(3) <= t);
    if (v.ilc > 2) v.ilc = 2;
    v.rectlc = 1.0f / (templc(v.ilc + 1) - templc(v.ilc));
    v.tmpdif = t - templc(v.ilc);
    return v;
}

// a coupling coefficient row at t, and its slope in t
__device__ __forceinline__ float interp(const float* c, const Interval& v) {
    const float lo = pick(c, v.ilc), hi = pick(c, v.ilc + 1);
    return lo + (hi - lo) * v.rectlc * v.tmpdif;
}
__device__ __forceinline__ float interp_dt(const float* c, const Interval& v) {
    return (pick(c, v.ilc + 1) - pick(c, v.ilc)) * v.rectlc;
}

// Everything the forward forms for one (row, line) pair that its adjoint
// reads again.
struct Pair {
    float w_line, scor_line, rho_mol;
    Interval iv;
    float rho_for, rho_sel, a1i, b1i, a2i, b2i, aip, bip;
    float rho7[N_BRD], term[N_BRD], alfa_tmp[N_BRD];
    bool brd_on, has_brd, own0;
    float rho_flg;
    float shift, xnu;
    float a, ex, s1, s, c1, e1, num, em, den, stild;
    float rtx, alfa0, hwhms, hc, fm3, hw;
    float x_d, y_d, ad;
    float k3v, ya, yb;
};

// The seven operands of one (row, line) pair: line_params + precompute
// (ops/lineshape.py:157-229, ops/linesum.py:precompute_plain), operation
// by operation.  wk_row / scor_row: the row's [39] columns and [351]
// TIPS ratios.  K3V = false leaves the pedestal out (the adjoint reads
// its partials, not its value).
template <bool IBRD, bool K3V = true>
__device__ __forceinline__ void pair_fwd(const RowVals& r,
                                         const float* wk_row,
                                         const float* scor_row,
                                         const LineCols& ln, const Consts& K,
                                         Pair& q) {
    const float* c = ln.c;
    const int mol0 = word_mol(ln.word);
    const bool xg1 = ln.word & W_XG1, xg3 = ln.word & W_XG3;
    q.w_line = wk_row[mol0];
    q.rho_mol = r.rhorat * q.w_line / r.wtot;

    // _coupling_coeffs: interval interpolation, -5 mixing, scalings
    q.iv = interval(r.t);
    q.rho_for = (r.rhorat - q.rho_mol) / r.rhorat;
    q.rho_sel = q.rho_mol / r.rhorat;
    q.a1i = interp(c + C_A1, q.iv);
    q.b1i = interp(c + C_B1, q.iv);
    float aip = q.a1i, bip = q.b1i;
    if (ln.word & W_MIX) {
        q.a2i = interp(c + C_A2, q.iv);
        q.b2i = interp(c + C_B2, q.iv);
        aip = q.rho_for * q.a1i + q.rho_sel * q.a2i;
        bip = q.rho_for * q.b1i + q.rho_sel * q.b2i;
    }
    if (xg1) {
        aip = aip * K.sclcpl + K.y0res;
        bip = bip * K.sclcpl + K.y0res;
    }
    if (xg3) {
        aip = aip * K.sclhw;
        bip = bip * K.sclhw;
    }
    q.aip = aip;
    q.bip = bip;

    // pressure shift, with the IBRD=1 species-specific adjustment
    float shift = c[C_PSHIFT] * r.rhorat;
    q.brd_on = IBRD && mol0 < N_BRD;
    if (IBRD) {
        float dshift = 0.0f;
#pragma unroll
        for (int j = 0; j < N_BRD; ++j) {
            const float flg = (ln.word >> (W_BRD_SHIFT + j)) & 1;
            q.rho7[j] = r.rhorat * wk_row[j] / r.wtot;
            q.term[j] = flg * (c[C_BRD_SHFT + j] - c[C_PSHIFT]);
            dshift = j == 0 ? q.rho7[0] * q.term[0]
                            : dshift + q.rho7[j] * q.term[j];
        }
        shift = shift + (q.brd_on ? 1.0f : 0.0f) * dshift;
    }
    q.shift = shift;
    q.xnu = c[C_NU_HI] + (c[C_NU_LO] + shift);

    // intensity (INTENS)
    q.scor_line = scor_row[word_iso(ln.word)];
    q.a = c[C_E] * K.neg_radct;
    const float b = 1.0f / r.t * 1.0f - K.inv_t0_sub;
    q.ex = expf(q.a * b);
    q.s1 = c[C_S0ADJ] * q.ex;
    q.s = q.s1 * q.scor_line;
    q.c1 = q.xnu * K.neg_radct / r.t;
    q.e1 = expf(q.c1);
    q.num = q.s * (q.e1 + 1.0f);
    q.em = expm1f(q.xnu * K.neg_radct * K.inv_t0);
    q.den = q.xnu * -q.em;
    q.stild = q.num / q.den;

    // Lorentz halfwidth (HALFWHM_C)
    q.rtx = powf(r.rt, c[C_TDEP]);
    q.alfa0 = c[C_ALPF] * q.rtx;
    q.hwhms = c[C_ALPS] * q.rtx;
    float hc = q.alfa0 * (r.rhorat - q.rho_mol) + q.hwhms * q.rho_mol;
    q.has_brd = false;
    if (IBRD) {
        int any = 0;
        float alfsum = 0.0f, rho_flg = 0.0f;
#pragma unroll
        for (int j = 0; j < N_BRD; ++j) {
            const int on = (ln.word >> (W_BRD_SHIFT + j)) & 1;
            const float flg = on;
            any |= on;
            q.alfa_tmp[j] = c[C_BRD_HW + j] * powf(r.rt, c[C_BRD_TMP + j]);
            const float fa = flg * q.alfa_tmp[j];
            alfsum = j == 0 ? q.rho7[0] * fa : alfsum + q.rho7[j] * fa;
            rho_flg = j == 0 ? q.rho7[0] * flg : rho_flg + q.rho7[j] * flg;
        }
        q.rho_flg = rho_flg;
        q.has_brd = any && mol0 < N_BRD;
        const int own = mol0 < N_BRD ? mol0 : N_BRD - 1;
        q.own0 = !((ln.word >> (W_BRD_SHIFT + own)) & 1);
        float hw_brd = (r.rhorat - rho_flg) * q.alfa0 + alfsum;
        if (q.own0) hw_brd = hw_brd + q.rho_mol * (q.hwhms - q.alfa0);
        if (q.has_brd) hc = hw_brd;
    }
    q.hc = hc;
    q.fm3 = 1.0f - q.aip * r.rp - q.bip * r.rp2;
    q.hw = xg3 ? hc * q.fm3 : hc;

    // Doppler halfwidth (HALFWHM_D)
    q.x_d = q.xnu * K.inv_clight;
    q.y_d = sqrtf(r.t * K.dop * K.avogad / c[C_MASS]);
    q.ad = q.x_d * q.y_d;

    // precompute: the pedestal at 25 cm^-1 and the coupling Y factors
    q.k3v = K3V ? linesum::sdvoigt(25.0f, q.hw, q.ad, c[C_SDEP]) : 0.0f;
    q.ya = q.aip * r.rp / q.hw;
    q.yb = q.bip * r.rp2;
}

// indices of a pair's contributions to its row's sums
enum {
    A_RHORAT, A_T, A_RP, A_RP2, A_RHO_MOL, A_SCOR, A_RHO7,
    N_ADJ = A_RHO7 + N_BRD
};
// how many of them a kernel sums: the seven densities only with IBRD=1
template <bool IBRD> struct NAdj { static constexpr int value = A_RHO7; };
template <> struct NAdj<true> { static constexpr int value = N_ADJ; };

// The adjoint of pair_fwd for the cotangents g[7] of its seven operands
// (PER_LN order; a null pointer's cotangent is zero): adds the pair's
// contributions to acc[N_ADJ].  The row's own chain (rhorat, rp, rp2, rt
// by p and t; rho_mol and the densities by wk and wtot) is row_adj's.
template <bool IBRD>
__device__ __forceinline__ void pair_adj(const RowVals& r, const LineCols& ln,
                                         const Consts& K, const Pair& q,
                                         const float* g, float* acc) {
    const float* c = ln.c;
    const bool xg1 = ln.word & W_XG1, xg3 = ln.word & W_XG3;
    float g_shift = g[0], g_stild = g[1], g_hw = g[2], g_ad = g[3];
    const float g_k3v = g[4], g_ya = g[5], g_yb = g[6];
    float g_rhorat = 0.0f, g_t = 0.0f, g_rp = 0.0f, g_rp2 = 0.0f,
          g_rho_mol = 0.0f, g_rt = 0.0f;
    float g_rho7[N_BRD];
#pragma unroll
    for (int j = 0; j < N_BRD; ++j) g_rho7[j] = 0.0f;

    // k3v = sdvoigt(25, hw, ad): partials in double, as sd_shape<Dual>
    if (g_k3v != 0.0f) {
        const Dual64 k = linesum::sdvoigt(var<Dual64>(25.0f, 0),
                                          var<Dual64>(q.hw, 1),
                                          var<Dual64>(q.ad, 2), c[C_SDEP]);
        g_hw = g_hw + g_k3v * static_cast<float>(k.dh);
        g_ad = g_ad + g_k3v * static_cast<float>(k.da);
    }
    // ya = aip * rp / hw, yb = bip * rp2
    const float t_ya = g_ya / q.hw;
    float g_aip = t_ya * r.rp, g_bip = g_yb * r.rp2;
    g_rp = t_ya * q.aip;
    g_rp2 = g_yb * q.bip;
    g_hw = g_hw - t_ya * q.ya;

    // ad = (xnu / CLIGHT) * sqrt(z), z proportional to t
    float g_xnu = g_ad * q.y_d * K.inv_clight;
    if (q.y_d > 0.0f) g_t = g_ad * q.x_d * (0.5f * q.y_d / r.t);

    // hw = hc * (1 - aip rp - bip rp2) where xg == -3
    float g_hc = g_hw;
    if (xg3) {
        g_hc = g_hw * q.fm3;
        const float g_f = g_hw * q.hc;
        g_aip = g_aip - g_f * r.rp;
        g_bip = g_bip - g_f * r.rp2;
        g_rp = g_rp - g_f * q.aip;
        g_rp2 = g_rp2 - g_f * q.bip;
    }
    // hc: HALFWHM_C, or its IBRD=1 form
    float g_alfa0, g_hwhms = 0.0f;
    if (IBRD && q.has_brd) {
        g_rhorat = g_hc * q.alfa0;
        g_alfa0 = g_hc * (r.rhorat - q.rho_flg);
        if (q.own0) {
            g_rho_mol = g_hc * (q.hwhms - q.alfa0);
            g_hwhms = g_hc * q.rho_mol;
            g_alfa0 = g_alfa0 - g_hc * q.rho_mol;
        }
#pragma unroll
        for (int j = 0; j < N_BRD; ++j) {
            const float flg = (ln.word >> (W_BRD_SHIFT + j)) & 1;
            g_rho7[j] = g_hc * flg * q.alfa_tmp[j] - g_hc * q.alfa0 * flg;
            if (r.rt > 0.0f)
                g_rt = g_rt + g_hc * q.rho7[j] * flg * q.alfa_tmp[j]
                                  * c[C_BRD_TMP + j] / r.rt;
        }
    } else {
        g_alfa0 = g_hc * (r.rhorat - q.rho_mol);
        g_rhorat = g_hc * q.alfa0;
        g_rho_mol = g_hc * (q.hwhms - q.alfa0);
        g_hwhms = g_hc * q.rho_mol;
    }
    // alfa0 = alpf rt^tdep, hwhms = alps rt^tdep
    const float g_rtx = g_alfa0 * c[C_ALPF] + g_hwhms * c[C_ALPS];
    if (r.rt > 0.0f) g_rt = g_rt + g_rtx * c[C_TDEP] * q.rtx / r.rt;

    // stild = s (1 + e1) / (xnu (-em))
    const float g_num = g_stild / q.den;
    const float g_den = -g_num * q.stild;
    const float g_s = g_num * (q.e1 + 1.0f);
    const float g_c1 = g_num * q.s * q.e1;
    g_xnu = g_xnu + g_c1 * K.neg_radct / r.t;
    g_t = g_t - g_c1 * q.c1 / r.t;
    g_xnu = g_xnu + g_den * -q.em;
    const float g_c2 = g_den * q.xnu * (q.em + 1.0f);   // d(-em)/dc2 = -e^c2
    g_xnu = g_xnu - g_c2 * K.neg_radct * K.inv_t0;
    // s = s0adj exp(a (1/t - 1/T0)) scor
    const float g_scor = g_s * q.s1;
    const float g_arg = g_s * q.scor_line * c[C_S0ADJ] * q.ex;
    g_t = g_t - g_arg * q.a / (r.t * r.t);

    // xnu = nu_hi + (nu_lo + shift); shift = pshift rhorat [+ dshift]
    g_shift = g_shift + g_xnu;
    g_rhorat = g_rhorat + g_shift * c[C_PSHIFT];
    if (IBRD && q.brd_on) {
#pragma unroll
        for (int j = 0; j < N_BRD; ++j)
            g_rho7[j] = g_rho7[j] + g_shift * q.term[j];
    }

    // the coupling coefficients: scalings, then the -5 mixing
    if (xg3) {
        g_aip = g_aip * K.sclhw;
        g_bip = g_bip * K.sclhw;
    }
    if (xg1) {
        g_aip = g_aip * K.sclcpl;
        g_bip = g_bip * K.sclcpl;
    }
    if (ln.word & W_MIX) {
        const float g_for = g_aip * q.a1i + g_bip * q.b1i;
        const float g_sel = g_aip * q.a2i + g_bip * q.b2i;
        g_t = g_t + g_aip * (q.rho_for * interp_dt(c + C_A1, q.iv)
                             + q.rho_sel * interp_dt(c + C_A2, q.iv))
                  + g_bip * (q.rho_for * interp_dt(c + C_B1, q.iv)
                             + q.rho_sel * interp_dt(c + C_B2, q.iv));
        g_rhorat = g_rhorat + (g_for - g_sel) * q.rho_sel / r.rhorat;
        g_rho_mol = g_rho_mol + (g_sel - g_for) / r.rhorat;
    } else {
        g_t = g_t + g_aip * interp_dt(c + C_A1, q.iv)
                  + g_bip * interp_dt(c + C_B1, q.iv);
    }
    g_t = g_t + g_rt * K.inv_t0;

    acc[A_RHORAT] += g_rhorat;
    acc[A_T] += g_t;
    acc[A_RP] += g_rp;
    acc[A_RP2] += g_rp2;
    acc[A_RHO_MOL] += g_rho_mol;
    acc[A_SCOR] += g_scor;
    if (IBRD) {
#pragma unroll
        for (int j = 0; j < N_BRD; ++j) acc[A_RHO7 + j] += g_rho7[j];
    }
}

// A run of one row's sums: the run's flat isotopologue (which names its
// molecule, iso / 9) and sums[NAdj] over its lines.
// row_adj: the row's gradients from its runs, taken in order: p, t, the
// [39] columns wk (into g_wk), wbrod, the [351] TIPS ratios (into g_scor,
// zeroed first).  rho_mol = rhorat wk[m] / wtot of each run's molecule
// and the IBRD=1 densities rho7[j] = rhorat wk[j] / wtot carry rhorat's,
// wk's and wtot's shares; wtot = sum(wk) + wbrod.
template <bool IBRD>
__device__ __forceinline__ void row_adj(const RowVals& r, const float* wk_row,
                                        const Consts& K, const float* sums,
                                        const int* iso, int n_runs,
                                        float* g_p, float* g_t, float* g_wk,
                                        float* g_wbrod, float* g_scor) {
    constexpr int NA = NAdj<IBRD>::value;
    for (int k = 0; k < 39; ++k) g_wk[k] = 0.0f;
    for (int k = 0; k < 351; ++k) g_scor[k] = 0.0f;
    float tot[NA];
    for (int k = 0; k < NA; ++k) tot[k] = 0.0f;
    float g_wtot = 0.0f, g_rhorat = 0.0f;
    for (int i = 0; i < n_runs; ++i) {
        const float* s = sums + static_cast<long long>(i) * NA;
        for (int k = 0; k < NA; ++k) tot[k] += s[k];
        const int m = iso[i] / 9;
        const float w = wk_row[m];
        const float rho = r.rhorat * w / r.wtot;
        const float g = s[A_RHO_MOL];
        g_rhorat = g_rhorat + g * w / r.wtot;
        g_wk[m] = g_wk[m] + g * r.rhorat / r.wtot;
        g_wtot = g_wtot - g * rho / r.wtot;
        g_scor[iso[i]] = g_scor[iso[i]] + s[A_SCOR];
    }
    g_rhorat = g_rhorat + tot[A_RHORAT];
    if (IBRD) {
        for (int j = 0; j < N_BRD; ++j) {
            const float g = tot[A_RHO7 + j];
            const float rho = r.rhorat * wk_row[j] / r.wtot;
            g_rhorat = g_rhorat + g * wk_row[j] / r.wtot;
            g_wk[j] = g_wk[j] + g * r.rhorat / r.wtot;
            g_wtot = g_wtot - g * rho / r.wtot;
        }
    }
    for (int k = 0; k < 39; ++k) g_wk[k] = g_wk[k] + g_wtot;
    *g_wbrod = g_wtot;
    // rhorat = (p / (t BOLTZ)) 1e3 / xn0, rp = p / 1013.25, rp2 = rp^2
    const float g_u = g_rhorat * K.inv_xn0 * K.k1000;
    const float g_rp = tot[A_RP] + 2.0f * r.rp * tot[A_RP2];
    *g_p = g_u / r.q + g_rp * K.inv_p0;
    *g_t = tot[A_T] - g_u * r.u / r.q * K.boltz;
}

}  // namespace prologue
