// Device math of the continuum and cloud kernels (continuum.cu): the
// MT_CKD sub-continua, Rayleigh, the two XINT stages, the radiation term
// and the TKC cloud of ops/continuum.py + ops/cloud.py, per (layer row,
// point), and their adjoint.
//
// Forward.  Every value is formed by the PyTorch version's float32
// operations in its order, so that the kernels' outputs are the eager CUDA
// path's bit for bit: a Python number meets a float32 tensor as
// float(number) (`fc`), a division by it is a multiply by float(1 /
// number), as PyTorch's CUDA division by a Python number does (`divc`;
// CONT_TRUE_SCALAR_DIV makes it a true division by float(number), as
// PyTorch's CPU kernel does, for the host tests), `rdiv` divides once,
// `x ** 2` is x * x, a `torch.where` selects, the XINT gather sums
// ((a0 + a1) + a2) + a3 and `index_add` adds that to the previous ABSRB
// value, sub-continuum by sub-continuum in the plan's order.  The
// column sum wtot = wbroad + sum(wk[:nmol]) follows PyTorch's CUDA
// reduction of fewer than 128 contiguous values (`torch_sum`).  Built
// without contraction (-fmad=false) and with IEEE division, expf and
// powf, as PyTorch's kernels are.
//
// Each sub-continuum, the radiation term and the cloud are written once,
// templates on their scalar: T = float is the forward; T = Dual (DualN<7>,
// double) carries the partials by the row's seven primaries p, t, wk[0],
// wk[1], wk[2], wk[6] and wtot, Dual1 those of the radiation term by xkt
// and of the cloud by t.  So the adjoint is the float32 formula
// differentiated in double, each product with a cotangent summed in
// double.  Float32 autograd through the eager stage is not that close:
// the cloud's numerator eps2 (eps1 + 2) - (eps1 - 1) eps2 cancels some
// 27-fold at microwave frequencies (more in the infrared), and so do its
// gradients, which autograd forms in float32; its gradient of t is a few
// 1e-6 (up to 2e-4 in the infrared) away from float64 autograd's, where
// this adjoint's is ~1e-7.
//
// Like linesum_math.cuh this header uses no CUDA runtime API, so a host
// compiler builds it too (tests/test_torch_continuum_kernel.py).

#pragma once

namespace cont {

// constants.py's numbers (Python doubles)
constexpr double PI_D = 3.1415926535898;
constexpr double CLIGHT = 2.99792458e+10;
constexpr double RADCN2 = 1.4387752;
constexpr double XLOSMT = 2.68675e+19;

// TKC's coefficients (ops/cloud.py)
constexpr double A1 = 8.110808e+01, B1 = 4.433736e-03, C1 = 1.301700e-13,
                 D1 = 6.627126e+02, A2 = 2.025164e+00, B2 = 1.072976e-02,
                 C2 = 1.011945e-14, D2 = 6.089168e+02, TC = 1.342433e+02;

// sub-continuum kinds, in ops/continuum_kernel.KINDS order
enum Kind {
    H2O_SELF, H2O_FRGN, CO2_FRGN, O3_CHAP, O3_HH, O3_UV, O2_FUND, O2_INF1,
    O2_INF2, O2_ABAND, O2_VIS, O2_HERZ, O2_FUV, N2_RT, N2_FUND, N2_OVERTONE
};
// h2o, co2, o3, o2, n2 on the ABSRB grid, then Rayleigh; + the cloud
constexpr int N_SPECIES = 6, RAY = 5, N_OUT = 7, N_WK = 39;
// the row's primaries, the partials a Dual carries
enum Prim { P_P, P_T, P_W0, P_W1, P_W2, P_W6, P_WTOT, N_PRIM };
// the adjoint kernel's block, whose sums the host tests repeat
constexpr int BWD_THREADS = 256;

// ---- forward-mode dual numbers (double) ----------------------------------

template <int N>
struct DualN {
    double v;
    double d[N];
    DualN() = default;
    __device__ DualN(double x) : v(x) {
        for (int k = 0; k < N; ++k) d[k] = 0.0;
    }
    friend __device__ __forceinline__ DualN operator+(DualN a, DualN b) {
        a.v += b.v;
        for (int k = 0; k < N; ++k) a.d[k] += b.d[k];
        return a;
    }
    friend __device__ __forceinline__ DualN operator-(DualN a, DualN b) {
        a.v -= b.v;
        for (int k = 0; k < N; ++k) a.d[k] -= b.d[k];
        return a;
    }
    friend __device__ __forceinline__ DualN operator-(DualN a) {
        a.v = -a.v;
        for (int k = 0; k < N; ++k) a.d[k] = -a.d[k];
        return a;
    }
    friend __device__ __forceinline__ DualN operator*(DualN a, DualN b) {
        DualN r;
        r.v = a.v * b.v;
        for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
        return r;
    }
    friend __device__ __forceinline__ DualN operator/(DualN a, DualN b) {
        DualN r;
        r.v = a.v / b.v;
        for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
        return r;
    }
    friend __device__ __forceinline__ DualN operator*(DualN a, double s) {
        a.v *= s;
        for (int k = 0; k < N; ++k) a.d[k] *= s;
        return a;
    }
    friend __device__ __forceinline__ DualN operator*(double s, DualN a) {
        return a * s;
    }
    friend __device__ __forceinline__ DualN operator/(DualN a, double s) {
        a.v /= s;
        for (int k = 0; k < N; ++k) a.d[k] /= s;
        return a;
    }
    friend __device__ __forceinline__ DualN operator/(double s, DualN b) {
        DualN r;
        r.v = s / b.v;
        const double q = -r.v / b.v;
        for (int k = 0; k < N; ++k) r.d[k] = q * b.d[k];
        return r;
    }
    friend __device__ __forceinline__ DualN operator+(DualN a, double s) {
        a.v += s;
        return a;
    }
    friend __device__ __forceinline__ DualN operator+(double s, DualN a) {
        return a + s;
    }
    friend __device__ __forceinline__ DualN operator-(DualN a, double s) {
        a.v -= s;
        return a;
    }
    friend __device__ __forceinline__ DualN operator-(double s, DualN a) {
        return -a + s;
    }
};
using Dual = DualN<N_PRIM>;
using Dual1 = DualN<1>;

template <int N>
__device__ __forceinline__ DualN<N> seed(double x, int k) {
    DualN<N> r(x);
    r.d[k] = 1.0;
    return r;
}

// the scalar of T's arithmetic: float for the forward, double for a Dual
template <class T> struct Num { using type = double; };
template <> struct Num<float> { using type = float; };

__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ double val(const DualN<N>& x) { return x.v; }

__device__ __forceinline__ float expv(float x) { return expf(x); }
template <int N>
__device__ __forceinline__ DualN<N> expv(DualN<N> x) {
    const double e = exp(x.v);
    x.v = e;
    for (int k = 0; k < N; ++k) x.d[k] *= e;
    return x;
}
// a tensor to a tensor's power: constant base (a table ratio) or constant
// exponent (a table exponent)
__device__ __forceinline__ float powv(float b, float e) { return powf(b, e); }
template <int N>
__device__ __forceinline__ DualN<N> powv(double b, DualN<N> e) {
    const double r = pow(b, e.v);
    const double q = r * log(b);
    e.v = r;
    for (int k = 0; k < N; ++k) e.d[k] *= q;
    return e;
}
template <int N>
__device__ __forceinline__ DualN<N> powv(DualN<N> b, double e) {
    const double q = e == 0.0 ? 0.0 : e * pow(b.v, e - 1.0);
    b.v = pow(b.v, e);
    for (int k = 0; k < N; ++k) b.d[k] *= q;
    return b;
}

// ---- PyTorch's float32 arithmetic with a Python number c -----------------

__device__ __forceinline__ float fc(double c) { return static_cast<float>(c); }

template <class T>
__device__ __forceinline__ T mulc(T a, double c) {
    return a * static_cast<typename Num<T>::type>(fc(c));
}
// a / c: on the card PyTorch multiplies by the reciprocal of c formed in
// double and rounded to float (for c = CLIGHT / 100 or 1 / 228 - 1 / 272
// that is not the float reciprocal of float(c))
template <class T>
__device__ __forceinline__ T divc(T a, double c) {
#ifdef CONT_TRUE_SCALAR_DIV
    return a / static_cast<typename Num<T>::type>(fc(c));
#else
    return a * static_cast<typename Num<T>::type>(fc(1.0 / c));
#endif
}
template <class T>
__device__ __forceinline__ T rdivc(double c, T a) {
    return static_cast<typename Num<T>::type>(fc(c)) / a;
}
template <class T>
__device__ __forceinline__ T addc(T a, double c) {
    return a + static_cast<typename Num<T>::type>(fc(c));
}
template <class T>
__device__ __forceinline__ T subc(T a, double c) {
    return a - static_cast<typename Num<T>::type>(fc(c));
}
template <class T>
__device__ __forceinline__ T rsubc(double c, T a) {
    return static_cast<typename Num<T>::type>(fc(c)) - a;
}

// torch.sum(x[:n]) of one row on the card, n < 128 contiguous floats:
// PyTorch's reduction gives the row bw = the largest power of two <= n
// lanes; lane l adds x[l] and x[l + bw] (each from the identity 0), then
// the lanes are folded by halving shuffles (Reduce.cuh, thread_reduce_impl
// and block_x_reduce)
__device__ __forceinline__ float torch_sum(const float* x, int n) {
    int bw = 1;
    while (bw * 2 <= n) bw *= 2;
    float lane[32];
    for (int l = 0; l < bw; ++l) {
        const float hi = l + bw < n ? 0.0f + x[l + bw] : 0.0f;
        lane[l] = (((0.0f + x[l]) + hi) + 0.0f) + 0.0f;
    }
    for (int off = bw / 2; off > 0; off /= 2)
        for (int l = 0; l < off; ++l) lane[l] = lane[l] + lane[l + off];
    return lane[0];
}

// ---- the row's derived scalars (continuum.py, _Layer) --------------------

template <class T>
struct Row {
    T p, t, w0, w1, w2, w6, wtot;
    T rhoave, amagat, xkt, x_h2o, x_o2, x_n2, wn2;
};

template <class T>
__device__ __forceinline__ Row<T> row_of(T p, T t, T w0, T w1, T w2, T w6,
                                         T wtot) {
    Row<T> L;
    L.p = p;
    L.t = t;
    L.w0 = w0;
    L.w1 = w1;
    L.w2 = w2;
    L.w6 = w6;
    L.wtot = wtot;
    const T p1 = divc(p, 1013.0);
    L.rhoave = p1 * rdivc(296.0, t);
    L.amagat = p1 * rdivc(273.0, t);
    L.xkt = divc(t, RADCN2);
    L.x_h2o = w0 / wtot;
    L.x_o2 = w6 / wtot;
    L.x_n2 = rsubc(1.0, L.x_h2o) - L.x_o2;
    L.wn2 = L.x_n2 * wtot;
    return L;
}

// the float row from a layer's state; with nmol < 22, _Layer puts wbroad
// into wk[21], which neither wtot (a sum over wk[:nmol]) nor any
// sub-continuum reads
__device__ __forceinline__ Row<float> row_in(float p, float t,
                                             const float* wk, float wbroad,
                                             int nmol) {
    return row_of<float>(p, t, wk[0], wk[1], wk[2], wk[6],
                         wbroad + torch_sum(wk, nmol));
}

// the same row as Duals of the primaries
__device__ __forceinline__ Row<Dual> row_dual(const Row<float>& L) {
    return row_of<Dual>(seed<N_PRIM>(L.p, P_P), seed<N_PRIM>(L.t, P_T),
                        seed<N_PRIM>(L.w0, P_W0), seed<N_PRIM>(L.w1, P_W1),
                        seed<N_PRIM>(L.w2, P_W2), seed<N_PRIM>(L.w6, P_W6),
                        seed<N_PRIM>(L.wtot, P_WTOT));
}

// ---- the radiation term and the sub-continua -----------------------------

// radfn(wn, xkt) of ops/planck.py
template <class T>
__device__ __forceinline__ T radfn(float wn, T xkt) {
    using S = typename Num<T>::type;
    const S w = wn;
    const bool kpos = val(xkt) > 0.0f;
    const T xv = kpos ? w / xkt : T(0.0f);
    // clamp(xv, 0, 80): NaN passes; outside, a constant
    T cl = xv;
    if (val(xv) < 0.0f) cl = T(0.0f);
    else if (val(xv) > 80.0f) cl = T(80.0f);
    const T e = expv(-cl);
    const T small = mulc(xv, 0.5) * w;
    const T mid = (w * rsubc(1.0, e)) / addc(e, 1.0);
    const T out = val(xv) <= fc(0.01) ? small
                  : (val(xv) <= fc(10.0) ? mid : T(w));
    return kpos ? out : T(w);
}

// one sub-continuum's window: its kind, length, table columns [ncol, nptc]
// (ops/continuum_kernel.COLUMNS), scale factor (ContinuumFactors, float)
struct SubView {
    int kind, nptc;
    const float* cols;
    float fac;
};

// the sub-continuum's value at window point m (its `fn`); teff is the CO2
// bandhead's t_eff
template <class T>
__device__ T sub_value(const SubView& s, int m, const Row<T>& L,
                       double teff) {
    using S = typename Num<T>::type;
    const int n = s.nptc;
    const float* c = s.cols + m;
    const T zero(0.0f);
    switch (s.kind) {
    case H2O_SELF: {
        const float c296 = c[0], c260 = c[n];
        const T tfac = divc(subc(L.t, 296.0), 260.0 - 296.0);
        const bool pos = c296 > 0.0f;
        const float r = (pos ? c260 : 1.0f) / (pos ? c296 : 1.0f);
        const T sh2o = pos ? S(c296) * powv(S(r), tfac) : zero;
        const T rself = mulc(mulc(L.x_h2o * L.rhoave, 1.0e-20), s.fac);
        return (L.w0 * sh2o) * rself;
    }
    case H2O_FRGN: {
        const float fh2o = c[0] * c[n];
        const T rfrgn =
            mulc(mulc(rsubc(1.0, L.x_h2o) * L.rhoave, 1.0e-20), s.fac);
        return (L.w0 * S(fh2o)) * rfrgn;
    }
    case CO2_FRGN: {
        const T trat = divc(L.t, teff);
        const T tcor = powv(trat, S(c[2 * n]));
        const T wco2 = mulc(mulc(L.w1 * L.rhoave, 1.0e-20), s.fac);
        return (S(c[0] * c[n]) * tcor) * wco2;
    }
    case O3_CHAP: {
        const T dt = subc(L.t, 273.15);
        const T wo3 = mulc(mulc(L.w2, 1.0e-20), s.fac);
        return (S(c[0]) + (S(c[n]) + S(c[2 * n]) * dt) * dt) * wo3;
    }
    case O3_HH: {
        const T tc = subc(L.t, 273.15);
        const T wo3 = mulc(mulc(L.w2, 1.0e-20), s.fac);
        const T cc = S(c[0]) * wo3;
        return cc * (addc(S(c[n]) * tc, 1.0) + (S(c[2 * n]) * tc) * tc);
    }
    case O3_UV:
        return S(c[0]) * mulc(L.w2, s.fac);
    case O2_FUND: {
        const T xktfac = rsubc(1.0 / 296.0, rdivc(1.0, L.t));
        const float vj = c[2 * n] != 0.0f ? c[2 * n] : 1.0f;
        const T tau_fac = mulc(mulc(L.w6 * L.amagat, 1.0e-20), s.fac);
        return ((mulc(tau_fac, 1.0e20 / XLOSMT) * S(c[0]))
                * expv(S(c[n]) * xktfac)) / S(vj);
    }
    case O2_INF1: {
        const T mix = (mulc(L.x_o2, 1.0 / 0.446) + mulc(L.x_n2, 0.3 / 0.446))
                      + mulc(L.x_h2o, 1.0);
        const T tau = mulc(divc(L.w6, XLOSMT) * L.amagat, s.fac) * mix;
        return tau * S(c[0]);
    }
    case O2_INF2: {
        const T wo2 = mulc(mulc(L.w6 * L.rhoave, 1.0e-20), s.fac);
        return S(c[0]) * (mulc(L.x_o2, 1.0 / 0.209) * wo2);
    }
    case O2_ABAND:
        return mulc(divc(L.w6, XLOSMT) * L.amagat, s.fac) * S(c[0]);
    case O2_VIS: {
        const T wo2 = mulc(mulc(L.w6, 1.0e-20) * L.amagat, s.fac);
        return S(c[0]) * (L.x_o2 * wo2);
    }
    case O2_HERZ: {
        const T prs =
            addc(divc(mulc(L.p, 0.83), 1013.0) * rdivc(273.16, L.t), 1.0);
        const T wo2 = mulc(mulc(L.w6, 1.0e-20), s.fac);
        return (S(c[0]) * prs) * wo2;
    }
    case O2_FUV:
        return S(c[0]) * mulc(mulc(L.w6, 1.0e-20), s.fac);
    case N2_RT: {
        const float c296 = c[0], c220 = c[n], sf296 = c[2 * n],
                    sf220 = c[3 * n];
        const T tfac = divc(subc(L.t, 296.0), 220.0 - 296.0);
        const bool pos = c296 > 0.0f, posf = sf296 > 0.0f;
        const float r = (pos ? c220 : 1.0f) / (pos ? c296 : 1.0f);
        const float rs = (posf ? sf220 : 1.0f) / (posf ? sf296 : 1.0f);
        const T cc = pos ? S(c296) * powv(S(r), tfac) : zero;
        const T sf_t = posf ? S(sf296) * powv(S(rs), tfac) : zero;
        const T fo2 = pos ? mulc(subc(sf_t, 1.0), 0.79 / 0.21) : zero;
        const T tau = mulc(divc(L.wn2, XLOSMT), s.fac) * L.amagat;
        return (tau * cc) * ((L.x_n2 + fo2 * L.x_o2) + mulc(L.x_h2o, 1.0));
    }
    case N2_FUND: {
        const float x272 = c[0], x228 = c[n], ah2o = c[2 * n];
        const float vj = c[3 * n] != 0.0f ? c[3 * n] : 1.0f;
        const T xtfac = divc(subc(rdivc(1.0, L.t), 1.0 / 272.0),
                             (1.0 / 228.0) - (1.0 / 272.0));
        const T xt_lin = divc(subc(L.t, 272.0), 228.0 - 272.0);
        const bool both = x272 > 0.0f && x228 > 0.0f;
        const float r = (both ? x228 : 1.0f) / (both ? x272 : 1.0f);
        const T c_log = both ? S(x272) * powv(S(r), xtfac) : zero;
        const T c_lin = S(x272) + S(x228 - x272) * xt_lin;
        const T cbase = (both ? c_log : c_lin) / S(vj);
        const T a_o2 = rsubc(1.294, divc(mulc(L.t, 0.4545), 296.0));
        const T c1 = a_o2 * cbase;
        const T c2 = S(ah2o * fc(9.0 / 7.0)) * cbase;
        const T tau = mulc(divc(L.wn2, XLOSMT), s.fac) * L.amagat;
        return tau * (((L.x_n2 * cbase) + (L.x_o2 * c1)) + (L.x_h2o * c2));
    }
    case N2_OVERTONE: {
        const T tau = (mulc(divc(L.wn2, XLOSMT), s.fac) * L.amagat)
                      * ((L.x_n2 + L.x_o2) + L.x_h2o);
        return tau * S(c[0]);
    }
    }
    return zero;
}

// Rayleigh on the ABSRB grid: base * wtot / radfn(v, xkt)
template <class T>
__device__ __forceinline__ T ray_value(float base, float v, const Row<T>& L) {
    using S = typename Num<T>::type;
    return (S(base) * L.wtot) / radfn(v, L.xkt);
}

// ---- the packed plan (ops/continuum_kernel.pack) -------------------------

// per sub-continuum, int32 [n_subs, META]: kind, species, window length,
// offset of its table columns, first ABSRB target and count of its
// stage-1 plan, offset of its plan entries, offset of its reverse map's
// row pointers, offset of its window in the flat window points
enum Meta { M_KIND, M_SPECIES, M_NPTC, M_COL, M_T0, M_NT, M_ENT, M_REV,
            M_WIN, META };

struct Plan {
    const int* meta;      // [n_subs, META]
    const int* s1_src;    // [n_ent] padded window index of A(J)
    const int* s1_rptr;   // per sub [nptc + 1], entries of each window point
    const int* s1_rev;    // [.] entry * 4 + tap, by window point
    const int* s2_src;    // [n_wn] padded ABSRB index of A(J), -1: none
    const int* s2_rptr;   // [nptabs + 1]
    const int* s2_rev;    // [.] wavenumber * 4 + tap, by ABSRB point
    const float* fac;     // [n_subs]
    const float* cols;    // the sub-continua's table columns
    const float* s1_w;    // [n_ent, 4]
    const float* s2_w;    // [n_wn, 4]
    const float* wn;      // [n_wn] the grid in float32
    const float* wnscale; // [n_wn] float32(wn / 1e4), Rayleigh's
    const float* ray_v;   // [nptabs] the ABSRB grid in float32
    const float* ray_base;  // [nptabs]
    int n_subs, n_wn, nptabs, nmol, has_ray, n_win;
    double teff;
};

// the packed plan's layout (ops/continuum_kernel.LAYOUT): offsets of the
// int32 arrays, of the float32 arrays, then the sizes
enum Layout {
    L_META, L_S1_SRC, L_S1_RPTR, L_S1_REV, L_S2_SRC, L_S2_RPTR, L_S2_REV,
    L_FAC, L_COLS, L_S1_W, L_S2_W, L_WN, L_WNSCALE, L_RAY_V, L_RAY_BASE,
    L_N_SUBS, L_N_WN, L_NPTABS, L_NMOL, L_HAS_RAY, L_N_WIN, N_LAYOUT
};

inline Plan plan_of(const int* ints, const float* flts, const long long* lay,
                    double teff) {
    Plan P;
    P.meta = ints + lay[L_META];
    P.s1_src = ints + lay[L_S1_SRC];
    P.s1_rptr = ints + lay[L_S1_RPTR];
    P.s1_rev = ints + lay[L_S1_REV];
    P.s2_src = ints + lay[L_S2_SRC];
    P.s2_rptr = ints + lay[L_S2_RPTR];
    P.s2_rev = ints + lay[L_S2_REV];
    P.fac = flts + lay[L_FAC];
    P.cols = flts + lay[L_COLS];
    P.s1_w = flts + lay[L_S1_W];
    P.s2_w = flts + lay[L_S2_W];
    P.wn = flts + lay[L_WN];
    P.wnscale = flts + lay[L_WNSCALE];
    P.ray_v = flts + lay[L_RAY_V];
    P.ray_base = flts + lay[L_RAY_BASE];
    P.n_subs = static_cast<int>(lay[L_N_SUBS]);
    P.n_wn = static_cast<int>(lay[L_N_WN]);
    P.nptabs = static_cast<int>(lay[L_NPTABS]);
    P.nmol = static_cast<int>(lay[L_NMOL]);
    P.has_ray = static_cast<int>(lay[L_HAS_RAY]);
    P.n_win = static_cast<int>(lay[L_N_WIN]);
    P.teff = teff;
    return P;
}

__device__ __forceinline__ SubView sub_view(const Plan& P, int s) {
    const int* m = P.meta + s * META;
    return SubView{m[M_KIND], m[M_NPTC], P.cols + m[M_COL], P.fac[s]};
}

// XINT's four taps of A(J) at padded index jj, zero outside [0, n)
__device__ __forceinline__ float gather4(const float* a, int n, int jj,
                                         const float* w) {
    float t[4];
    for (int i = 0; i < 4; ++i) {
        const int q = jj - 3 + i;
        t[i] = (q >= 0 && q < n ? a[q] : 0.0f) * w[i];
    }
    return ((t[0] + t[1]) + t[2]) + t[3];
}

// ABSRB value k of species sp (RAY: Rayleigh's term there): each
// sub-continuum of the species whose stage-1 plan targets k, in plan
// order, its window values gathered and added to the running value
__device__ __forceinline__ float absrb_value(const Plan& P,
                                             const Row<float>& L, int sp,
                                             int k) {
    if (sp == RAY)
        return P.has_ray ? ray_value(P.ray_base[k], P.ray_v[k], L) : 0.0f;
    float acc = 0.0f;
    for (int s = 0; s < P.n_subs; ++s) {
        const int* m = P.meta + s * META;
        const int e = k - m[M_T0];
        if (m[M_SPECIES] != sp || e < 0 || e >= m[M_NT]) continue;
        const SubView v = sub_view(P, s);
        const int ent = m[M_ENT] + e;
        const int jj = P.s1_src[ent];
        const float* w = P.s1_w + 4LL * ent;
        float t[4];
        for (int i = 0; i < 4; ++i) {
            const int q = jj - 3 + i;
            t[i] = (q >= 0 && q < v.nptc ? sub_value<float>(v, q, L, P.teff)
                                         : 0.0f) * w[i];
        }
        acc = acc + (((t[0] + t[1]) + t[2]) + t[3]);
    }
    return acc;
}

// stage 2 of species sp at wavenumber w, before the radiation term
__device__ __forceinline__ float stage2(const Plan& P, const float* absrb,
                                        int sp, int w) {
    const int jj = P.s2_src[w];
    return jj < 0 ? 0.0f
                  : 0.0f + gather4(absrb + sp * P.nptabs, P.nptabs, jj,
                                   P.s2_w + 4LL * w);
}

// ---- the cloud (ops/cloud.py, TKC) ---------------------------------------

// the row's part of tkc_mass_absorption, from its temperature
template <class T>
struct CloudRow {
    T eps_s, delta1, tau1, delta2, tau2, k1, k2, k3, k4;
};

template <class T>
__device__ __forceinline__ CloudRow<T> cloud_row(T temp) {
    CloudRow<T> c;
    const T t = subc(temp, 273.15);
    c.eps_s = (rsubc(87.9144, mulc(t, 0.404399)) + mulc(t * t, 9.58726e-4))
              - mulc((t * t) * t, 1.32802e-6);
    c.delta1 = mulc(expv(mulc(t, -B1)), A1);
    c.tau1 = mulc(expv(rdivc(D1, addc(t, TC))), C1);
    c.delta2 = mulc(expv(mulc(t, -B2)), A2);
    c.tau2 = mulc(expv(rdivc(D2, addc(t, TC))), C2);
    c.k1 = (c.tau1 * c.tau1) * c.delta1;
    c.k2 = (c.tau2 * c.tau2) * c.delta2;
    c.k3 = c.tau1 * c.delta1;
    c.k4 = c.tau2 * c.delta2;
    return c;
}

// the mass absorption coefficient at wavenumber wn (the cloud's OD is it
// times clw)
template <class T>
__device__ __forceinline__ T cloud_res(float wn, const CloudRow<T>& c) {
    using S = typename Num<T>::type;
    const float frq = mulc(divc(mulc(wn, CLIGHT), 1.0e9), 1.0e9);
    const float omf = mulc(frq, 2.0 * PI_D);
    const S om = omf;
    const T u1 = om * c.tau1;
    const T den1 = addc(u1 * u1, 1.0);
    const T u2 = om * c.tau2;
    const T den2 = addc(u2 * u2, 1.0);
    const T eps1 = c.eps_s - S(omf * omf) * (c.k1 / den1 + c.k2 / den2);
    const T eps2 = om * (c.k3 / den1 + c.k4 / den2);
    const T re_n = subc(eps1, 1.0);
    const T re_d = addc(eps1, 2.0);
    const T ratio =
        (eps2 * re_d - re_n * eps2) / (re_d * re_d + eps2 * eps2);
    return divc(mulc(mulc(ratio, 6.0 * PI_D) * S(frq), 1.0e-3),
                CLIGHT / 100.0);
}

// ---- the kernels' per-point work -----------------------------------------

// the seven outputs at wavenumber w of a row whose ABSRB values are absrb
// [N_SPECIES, nptabs]
__device__ __forceinline__ void col_values(const Plan& P, const float* absrb,
                                           int w, float xkt,
                                           const CloudRow<float>& c,
                                           float clw, float* out) {
    const float rf = radfn(P.wn[w], xkt);
    for (int sp = 0; sp < RAY; ++sp) out[sp] = stage2(P, absrb, sp, w) * rf;
    out[RAY] = P.has_ray ? stage2(P, absrb, RAY, w) * P.wnscale[w] : 0.0f;
    out[RAY + 1] = cloud_res(P.wn[w], c) * clw;
}

// the cotangents at one point (null: zero)
struct Cot {
    const float* g[N_OUT];
};

// the adjoint's sums over a row's wavenumbers, per thread: the gradients
// of xkt through the radiation term, of t through the cloud, and of clw
enum ColSum { C_XKT, C_T, C_CLW, N_COLSUM };
// the sums the adjoint's block folds at once: ColSum's, then the
// primaries'
constexpr int N_FOLD = int(N_PRIM) > int(N_COLSUM) ? int(N_PRIM) : int(N_COLSUM);

// the adjoint at wavenumber w (flat index ix of the row's point): adds to
// the sums, returns the radiation term for the ABSRB pass; cd is the
// row's cloud part as Duals of its temperature
__device__ __forceinline__ float col_adjoint(const Plan& P,
                                             const float* absrb, int w,
                                             long long ix, float xkt,
                                             const CloudRow<float>& c,
                                             const CloudRow<Dual1>& cd,
                                             float clw, const Cot& G,
                                             double* sum) {
    const Dual1 rf = radfn(P.wn[w], seed<1>(xkt, 0));
    double g_rf = 0.0;
    for (int sp = 0; sp < RAY; ++sp)
        if (G.g[sp])
            g_rf += static_cast<double>(G.g[sp][ix])
                    * stage2(P, absrb, sp, w);
    sum[C_XKT] += g_rf * rf.d[0];
    if (G.g[RAY + 1]) {
        const double g = G.g[RAY + 1][ix];
        sum[C_T] += g * clw * cloud_res(P.wn[w], cd).d[0];
        sum[C_CLW] += g * cloud_res(P.wn[w], c);
    }
    return radfn(P.wn[w], xkt);
}

// a lane's part of the gradient of ABSRB value k of species sp: entries
// lane, lane + WARP, ... of its stage-2 reverse map's (wavenumber, tap)
// entries, in order; rf is the row's radiation term.  cont_bwd then
// folds the warp's lanes by halving shuffles
constexpr int WARP = 32;
__device__ __forceinline__ double absrb_adjoint(const Plan& P, int sp, int k,
                                                const float* g,
                                                const float* rf, int lane) {
    double acc = 0.0;
    if (!g || (sp == RAY && !P.has_ray)) return acc;
    for (int i = P.s2_rptr[k] + lane; i < P.s2_rptr[k + 1]; i += WARP) {
        const int e = P.s2_rev[i];
        const int w = e >> 2;
        const double h = sp == RAY
            ? static_cast<double>(g[w]) * P.wnscale[w]
            : static_cast<double>(g[w]) * rf[w];
        acc += h * P.s2_w[e];
    }
    return acc;
}

// window point j of the flat windows (then the ABSRB points of Rayleigh):
// its gradient from its stage-1 reverse map, times its partials, added to
// the primaries' sums; gab is the row's [N_SPECIES, nptabs] ABSRB
// gradients
__device__ __forceinline__ void point_adjoint(const Plan& P, int j,
                                              const double* gab,
                                              const Row<Dual>& L,
                                              double* prim) {
    Dual v;
    double g = 0.0;
    if (j >= P.n_win) {
        const int k = j - P.n_win;
        g = gab[RAY * P.nptabs + k];
        v = ray_value(P.ray_base[k], P.ray_v[k], L);
    } else {
        int s = 0;
        while (j >= P.meta[s * META + M_WIN] + P.meta[s * META + M_NPTC]) ++s;
        const int* m = P.meta + s * META;
        const int pt = j - m[M_WIN];
        const double* ga = gab + m[M_SPECIES] * P.nptabs + m[M_T0];
        const int* rp = P.s1_rptr + m[M_REV] + pt;
        for (int i = rp[0]; i < rp[1]; ++i) {
            const int e = P.s1_rev[i];
            g += ga[(e >> 2) - m[M_ENT]] * P.s1_w[e];
        }
        v = sub_value<Dual>(sub_view(P, s), pt, L, P.teff);
    }
    for (int q = 0; q < N_PRIM; ++q) prim[q] += g * v.d[q];
}

// the row's gradients from the summed primaries and the column sums
__device__ __forceinline__ void row_grads(const Plan& P, const double* prim,
                                          const double* col, float* gp,
                                          float* gt, float* gwk,
                                          float* gwbrod, float* gclw) {
    const double xkt_t = static_cast<double>(fc(1.0 / RADCN2));
    *gp = static_cast<float>(prim[P_P]);
    *gt = static_cast<float>(prim[P_T] + col[C_XKT] * xkt_t + col[C_T]);
    for (int k = 0; k < N_WK; ++k) {
        double v = k < P.nmol ? prim[P_WTOT] : 0.0;
        if (k == 0) v += prim[P_W0];
        if (k == 1) v += prim[P_W1];
        if (k == 2) v += prim[P_W2];
        if (k == 6) v += prim[P_W6];
        gwk[k] = static_cast<float>(v);
    }
    *gwbrod = static_cast<float>(prim[P_WTOT]);
    *gclw = static_cast<float>(col[C_CLW]);
}

}  // namespace cont
