// Device math shared by the line-sum kernels (linesum.cu, linesum_bwd.cu):
// the Humlicek / speed-dependent Voigt line shapes of ops/voigt.py, the
// Lorentz shapes, and the per-(wavenumber, line) evaluation of the LSF
// branch trees (modm.f90:567-831), as the JAX kernel forms them
// (monortm_tpu/ops/linesum_pallas.py::_contrib_block).
//
// The shape functions are templates on their scalar type T.  T = float is
// the forward.  T = Dual (DualT<float>) carries, beside each value, its
// partial derivatives by the detuning, the Lorentz halfwidth and the
// Doppler halfwidth (forward-mode automatic differentiation): it
// differentiates the shipped rational approximations themselves, branch
// for branch, as jax.vjp of the Pallas kernel does, and not the analytic
// w(z).  Every branch decision is taken on the value part, and the value
// part of a Dual is computed by the same float operations in the same
// order as T = float, so forward and adjoint take the same branches.
//
// The adjoint has two per-pair evaluations (second half of this header):
//   - a Lorentz lane, nearly every pair, goes through
//     lorentz_class_adjoint: the value as the forward computes it (one
//     IEEE divide per shape), the partials in closed form from that value
//     (no further divide), everything that depends on the (layer, line)
//     alone taken from a LinePre computed once per thread (pedestal and
//     its derivative, Y factors at the window's edge, the Lorentz switch,
//     the branch-tree class), and the branch trees' adjoint written out
//     per class.  No dual number is formed there;
//   - an SD-Voigt lane goes through sd_pair_adjoint: value from T = float,
//     partials from T = Dual64 (DualT<double>; see sd_shape), then the
//     generic tree_adjoint.
// sweep_tile runs the first over a tile's wavenumbers, in a loop compiled
// once per class of the branch trees, and reports whether it met lanes of
// the second kind; deferred_tile revisits exactly those.  pair_adjoint,
// the all-dual evaluation of either lane, is what the tests hold the
// closed forms against.
//
// The forward (last section) walks a chunk of staged lines per thread
// (fwd_chunk): per-(layer, line) terms hoisted into FwdLine by the thread
// that stages the line, a loop per class of the branch trees, the SD-Voigt
// lane a call.  Its sums are bitwise those of pair_of -> shapes ->
// branch_trees, line by line.
//
// This header uses no CUDA runtime API; it needs only the math functions
// and the __device__ / __forceinline__ / __noinline__ qualifiers, so a
// host compiler builds it too (tests/test_torch_sd_partials.py,
// test_torch_bwd_math.py, test_torch_fwd_math.py).

#pragma once

#ifndef __noinline__
#define __noinline__ __attribute__((noinline))
#endif

namespace linesum {

#define F(x) (static_cast<float>(x))

// constants as the JAX package forms them, Python doubles; the shape
// functions take them through R(x) (below)
constexpr double PI_D = 3.1415926535898;               // constants.PI
constexpr double SQRT_LN2 = 0.8325546111576977;        // sqrt(ln 2)
constexpr double RSQRT_PI_LN2 = 0.46971863934982516;   // sqrt(ln2 / PI)
constexpr double INV_SQRT2 = 0.7071067811865475;
constexpr double QUARTER_INV_LN2 = 0.36067376022224085;  // 1/4/ln 2
constexpr float INV_PI = F(0.31830987334251404);       // f32(1/pi)
constexpr float CUT = 25.0f;                           // DELTNU_CUT
constexpr float CUT2 = 625.0f;

// line flags, bit per linesum_pallas.FLAGS entry
constexpr int FL_O2 = 1, FL_CO2 = 2, FL_CPL = 4, FL_XF1 = 8, FL_XF15 = 16,
              FL_VALID = 32;

// ---- forward-mode dual numbers -------------------------------------------

__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ double absv(double x) { return fabs(x); }
__device__ __forceinline__ float sqrts(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrts(double x) { return sqrt(x); }
__device__ __forceinline__ float exps(float x) { return expf(x); }
__device__ __forceinline__ double exps(double x) { return exp(x); }
__device__ __forceinline__ float coss(float x) { return cosf(x); }
__device__ __forceinline__ double coss(double x) { return cos(x); }
__device__ __forceinline__ float sins(float x) { return sinf(x); }
__device__ __forceinline__ double sins(double x) { return sin(x); }

// A value and its partial derivatives by (detuning, hw, ad), in scalar S.
template <typename S>
struct DualT {
    S v, dn, dh, da;
    DualT() = default;
    __device__ explicit DualT(S x) : v(x), dn(0), dh(0), da(0) {}
    __device__ DualT(S x, S a, S b, S c) : v(x), dn(a), dh(b), da(c) {}

    friend __device__ __forceinline__ DualT operator+(DualT x, DualT y) {
        return DualT(x.v + y.v, x.dn + y.dn, x.dh + y.dh, x.da + y.da);
    }
    friend __device__ __forceinline__ DualT operator-(DualT x, DualT y) {
        return DualT(x.v - y.v, x.dn - y.dn, x.dh - y.dh, x.da - y.da);
    }
    friend __device__ __forceinline__ DualT operator-(DualT x) {
        return DualT(-x.v, -x.dn, -x.dh, -x.da);
    }
    friend __device__ __forceinline__ DualT operator*(DualT x, DualT y) {
        return DualT(x.v * y.v, x.dn * y.v + x.v * y.dn,
                     x.dh * y.v + x.v * y.dh, x.da * y.v + x.v * y.da);
    }
    friend __device__ __forceinline__ DualT operator/(DualT x, DualT y) {
        const S q = x.v / y.v;
        return DualT(q, (x.dn - q * y.dn) / y.v, (x.dh - q * y.dh) / y.v,
                     (x.da - q * y.da) / y.v);
    }
    friend __device__ __forceinline__ DualT operator+(DualT x, S s) {
        return DualT(x.v + s, x.dn, x.dh, x.da);
    }
    friend __device__ __forceinline__ DualT operator+(S s, DualT x) {
        return DualT(s + x.v, x.dn, x.dh, x.da);
    }
    friend __device__ __forceinline__ DualT operator-(DualT x, S s) {
        return DualT(x.v - s, x.dn, x.dh, x.da);
    }
    friend __device__ __forceinline__ DualT operator-(S s, DualT x) {
        return DualT(s - x.v, -x.dn, -x.dh, -x.da);
    }
    friend __device__ __forceinline__ DualT operator*(DualT x, S s) {
        return DualT(x.v * s, x.dn * s, x.dh * s, x.da * s);
    }
    friend __device__ __forceinline__ DualT operator*(S s, DualT x) {
        return DualT(s * x.v, s * x.dn, s * x.dh, s * x.da);
    }
    friend __device__ __forceinline__ DualT operator/(DualT x, S s) {
        return DualT(x.v / s, x.dn / s, x.dh / s, x.da / s);
    }
    friend __device__ __forceinline__ DualT operator/(S s, DualT y) {
        const S q = s / y.v;
        const S r = -q / y.v;
        return DualT(q, r * y.dn, r * y.dh, r * y.da);
    }
};
using Dual = DualT<float>;      // the Lorentz lanes' partials
using Dual64 = DualT<double>;   // the SD-Voigt lanes' partials (sd_shape)

// The scalar of T's arithmetic, and R(x), the constant x in it: float for
// float and Dual, which round as the JAX package's float32 kernel does;
// double for Dual64, which evaluates the float64 formula of ops/voigt.py.
template <typename T> struct Real { using type = float; };
template <> struct Real<Dual64> { using type = double; };
#define R(x) (static_cast<typename Real<T>::type>(x))

__device__ __forceinline__ float val(float x) { return x; }
template <typename S> __device__ __forceinline__ S val(const DualT<S>& x) {
    return x.v;
}

__device__ __forceinline__ float sqrtv(float x) { return sqrtf(x); }
template <typename S> __device__ __forceinline__ DualT<S> sqrtv(DualT<S> x) {
    const S s = sqrts(x.v);
    const S r = S(0.5) / s;
    return DualT<S>(s, r * x.dn, r * x.dh, r * x.da);
}
__device__ __forceinline__ float expv(float x) { return expf(x); }
template <typename S> __device__ __forceinline__ DualT<S> expv(DualT<S> x) {
    const S e = exps(x.v);
    return DualT<S>(e, e * x.dn, e * x.dh, e * x.da);
}
__device__ __forceinline__ float cosv(float x) { return cosf(x); }
template <typename S> __device__ __forceinline__ DualT<S> cosv(DualT<S> x) {
    const S s = -sins(x.v);
    return DualT<S>(coss(x.v), s * x.dn, s * x.dh, s * x.da);
}

// x as a variable of the differentiation: axis 0 detuning, 1 hw, 2 ad
template <typename T> __device__ __forceinline__ T var(float x, int axis);
template <>
__device__ __forceinline__ float var<float>(float x, int) { return x; }
template <>
__device__ __forceinline__ Dual var<Dual>(float x, int axis) {
    return Dual(x, axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
                axis == 2 ? 1.0f : 0.0f);
}
template <>
__device__ __forceinline__ Dual64 var<Dual64>(float x, int axis) {
    return Dual64(x, axis == 0 ? 1.0 : 0.0, axis == 1 ? 1.0 : 0.0,
                  axis == 2 ? 1.0 : 0.0);
}

// ---- Humlicek rationals, real-pair complex arithmetic (ops/voigt.py) ----

template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& cr, T& ci) {
    cr = ar * br - ai * bi;
    ci = ar * bi + ai * br;
}

template <typename T>
__device__ __forceinline__ T cdiv_re(T ar, T ai, T br, T bi) {
    T d = br * br + bi * bi;
    return (ar * br + ai * bi) / d;
}

template <typename T> __device__ T w_region1(T tr, T ti) {
    T ur, ui;
    cmul(tr, ti, tr, ti, ur, ui);
    return cdiv_re(R(0.5641896) * tr, R(0.5641896) * ti, 0.5f + ur, ui);
}

template <typename T> __device__ T w_region2(T tr, T ti) {
    T ur, ui, nr, ni, dr, di;
    cmul(tr, ti, tr, ti, ur, ui);
    cmul(tr, ti, R(1.410474) + R(0.5641896) * ur, R(0.5641896) * ui, nr, ni);
    cmul(ur, ui, 3.0f + ur, ui, dr, di);
    return cdiv_re(nr, ni, 0.75f + dr, di);
}

template <typename T> __device__ T w_region3(T tr, T ti) {
    using S = typename Real<T>::type;
    const S num[5] = {S(0.5642236), S(3.778987), S(11.96482), S(20.20933),
                      S(16.4955)};
    const S den[6] = {S(1.0), S(6.699398), S(21.69274), S(39.27121),
                      S(38.82363), S(16.4955)};
    T nr(num[0]), ni(0.0f), dr(den[0]), di(0.0f), cr, ci;
#pragma unroll
    for (int k = 1; k < 5; ++k) {
        cmul(nr, ni, tr, ti, cr, ci);
        nr = cr + num[k];
        ni = ci;
    }
#pragma unroll
    for (int k = 1; k < 6; ++k) {
        cmul(dr, di, tr, ti, cr, ci);
        dr = cr + den[k];
        di = ci;
    }
    return cdiv_re(nr, ni, dr, di);
}

template <typename T> __device__ T w_region4(T tr, T ti) {
    using S = typename Real<T>::type;
    const S num[7] = {S(0.56419), S(1.320522), S(35.76683), S(219.0313),
                      S(1540.787), S(3321.9905), S(36183.31)};
    const S den[8] = {S(1.0), S(1.841439), S(61.57037), S(364.2191),
                      S(2186.181), S(9022.228), S(24322.84), S(32066.6)};
    T ur, ui, qr, qi;
    cmul(tr, ti, tr, ti, ur, ui);
    // alternating-sign polynomials in u as written in the reference
    T nr(num[0]), ni(0.0f);
#pragma unroll
    for (int k = 1; k < 7; ++k) {
        cmul(ur, ui, nr, ni, qr, qi);
        nr = num[k] - qr;
        ni = -qi;
    }
    T dr(den[0]), di(0.0f);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        cmul(ur, ui, dr, di, qr, qi);
        dr = den[k] - qr;
        di = -qi;
    }
    T d = dr * dr + di * di;
    T fr = (nr * dr + ni * di) / d;
    T fi = (ni * dr - nr * di) / d;
    T pr = tr * fr - ti * fi;   // Re[t * num / den]
    // Re[cexp(u) - t*num/den]
    return expv(ur) * cosv(ui) - pr;
}

// Re[w(x + i y)], Humlicek W4 (modm.f90:1100-1130): one region per point
template <typename T> __device__ T w4_real(T x, T y) {
    T tr = y, ti = -x;
    const auto s = absv(val(x)) + val(y);
    if (s >= 15.0f) return w_region1(tr, ti);
    if (s >= 5.5f) return w_region2(tr, ti);
    if (val(y) < R(0.195) * absv(val(x)) - R(0.176)) return w_region4(tr, ti);
    return w_region3(tr, ti);
}

// VOIGT (modm.f90:900-962)
template <typename T> __device__ T voigt(T dnu, T al, T ad) {
    if (!(val(ad) > 0.0f)) return al / (R(PI_D) * (al * al + dnu * dnu));
    T x = R(SQRT_LN2) * dnu / ad;
    T y = R(SQRT_LN2) * al / ad;
    return w4_real(x, y) * R(RSQRT_PI_LN2) / ad;
}

// SD_Humlicek region id (boundaries 15/6; modm.f90:1160-1179)
template <typename S>
__device__ __forceinline__ int sd_region(S s, S xh, S yh) {
    if (s >= 15.0f) return 1;
    if (s >= 6.0f) return 2;
    return (yh < S(0.195) * absv(xh) - S(0.176)) ? 4 : 3;
}

// Re[w] for combined region r, per-point 4 -> 3 fallback
// (modm.f90:1217-1247)
template <typename T>
__device__ T w_by_region(T tr, T ti, int r, bool own4) {
    if (r == 1) return w_region1(tr, ti);
    if (r == 2) return w_region2(tr, ti);
    if (r == 4 && own4) return w_region4(tr, ti);
    return w_region3(tr, ti);
}

// sqrt where u > 0, else 0 with a zero derivative (ops/voigt._safe_sqrt)
template <typename T> __device__ __forceinline__ T safe_sqrt(T u) {
    return val(u) > 0.0f ? sqrtv(u) : T(0.0f);
}

// SDVOIGT (modm.f90:965-1087), Boone et al. 2011 two-point form, with the
// f32 fallback to the plain Voigt where delta > 1e6 (ops/voigt.py)
template <typename T> __device__ T sdvoigt(T dnu, T al, T ad, float sdep) {
    bool use_sd = absv(sdep) > R(1.0e-4);
    float sdep_safe = use_sd ? sdep : 1.0f;
    T gamma2 = al * sdep_safe;
    T g2 = val(gamma2) != 0.0f ? gamma2 : T(1.0f);
    T alfa = al / g2 - 1.5f;
    T beta = dnu / g2;
    T delta = R(QUARTER_INV_LN2) * (ad * ad / g2 / g2);
    if (!(use_sd && val(delta) < 1.0e6f)) return voigt(dnu, al, ad);
    T ad_safe = val(ad) > 0.0f ? ad : T(1.0f);
    T alfadelta = alfa + delta;
    T tmp = safe_sqrt(alfadelta * alfadelta + beta * beta);
    T sqrt_delta = safe_sqrt(delta);
    T x1 = R(INV_SQRT2) * safe_sqrt(tmp + alfadelta) - sqrt_delta;
    T x2 = x1 + 2.0f * sqrt_delta;
    T h = (tmp - delta - alfa) / 2.0f;
    float sgn = val(beta) > 0.0f ? 1.0f : (val(beta) < 0.0f ? -1.0f : 0.0f);
    T y1 = sgn * safe_sqrt(val(h) > 0.0f ? h : T(0.0f));
    const auto s1 = absv(val(y1)) + val(x1);
    const auto s2 = absv(val(y1)) + val(x2);
    int r1 = sd_region(s1, val(y1), val(x1));
    int r2 = sd_region(s2, val(y1), val(x2));
    int r = r1 > r2 ? r1 : r2;
    T w1 = w_by_region(x1, -y1, r, r1 == 4);
    T w2 = w_by_region(x2, -y1, r, r2 == 4);
    return (w1 - w2) * R(RSQRT_PI_LN2) / ad_safe;
}

// Lorentz shape at detuning dd
template <typename T> __device__ __forceinline__ T lorentz(T dd, T h) {
    T hw_pi = h * INV_PI;
    T hw2 = h * h;
    return hw_pi / (hw2 + dd * dd);
}

// the pedestal k3 of a Lorentz lane: xlorentz(25/hw)/hw in the full
// kernel, the Lorentz shape at 25 cm^-1 in the all-Lorentz engine
template <bool VOIGT, typename T> __device__ __forceinline__ T pedestal(T h) {
    if (VOIGT) {
        T z = CUT / h;
        return 1.0f / (R(PI_D) * (1.0f + z * z)) / h;
    }
    return lorentz(T(CUT), h);
}

// ---- one (wavenumber, line) evaluation -----------------------------------

// The operands of one line in one layer.
struct Line {
    float nu_hi, nu_lo, sdep;                 // per line
    float shift, stild, hw, ad, k3v, ya, yb;  // per (layer, line)
    int flags;
};

// Detuning and the masks of one (wavenumber, line) pair.
struct Pair {
    float d1, dsum;
    bool mirror, within, o2, cpl, need_k2;
};

// The pair's geometry; false where the line is outside the 25 cm^-1
// window and not O2 (it contributes nothing there).
__device__ __forceinline__ bool pair_of(float whi, float wlo, const Line& ln,
                                        Pair& p) {
    const float xnu = ln.nu_hi + (ln.nu_lo + ln.shift);
    p.d1 = (whi - ln.nu_hi) + (wlo - ln.nu_lo) - ln.shift;
    p.dsum = whi + xnu;
    p.mirror = (p.dsum - CUT) <= 0.0f;
    p.within = fabsf(p.d1) <= CUT;
    p.o2 = ln.flags & FL_O2;
    if (!(p.within || p.o2)) return false;
    p.cpl = ln.flags & FL_CPL;
    p.need_k2 = p.mirror || (p.o2 && p.cpl);
    return true;
}

// The SD-Voigt shape of line ln at detuning dn.
template <typename T> __device__ __forceinline__ T sd_shape(float dn,
                                                           const Line& ln);
template <>
__device__ __forceinline__ float sd_shape<float>(float dn, const Line& ln) {
    return sdvoigt(dn, ln.hw, ln.ad, ln.sdep);
}
// Its value as the forward computes it, in float, and its partials in
// double.  In float the partials lose their digits where the speed-
// dependent width gamma2 is small against the Doppler width (delta >> 1,
// near vacuum): x1 is the difference of two square roots of size
// sqrt(delta), and its partials are differences of terms ~1/gamma2 in
// size.  The double evaluation runs the same rationals with the
// constants in double and takes its branches on its own values, so a
// lane at a region boundary may differentiate the neighbouring region.
template <>
__device__ __forceinline__ Dual sd_shape<Dual>(float dn, const Line& ln) {
    const Dual64 d = sdvoigt(var<Dual64>(dn, 0), var<Dual64>(ln.hw, 1),
                             var<Dual64>(ln.ad, 2), ln.sdep);
    return Dual(sdvoigt(dn, ln.hw, ln.ad, ln.sdep), static_cast<float>(d.dn),
                static_cast<float>(d.dh), static_cast<float>(d.da));
}

// k1 = K(d1), k2 = K(dsum) (only where the mirror term or coupled O2 needs
// it; 0 elsewhere) and the pedestal k3.  Each lane takes the Lorentz or
// the SD-Voigt branch (modm.f90:419-431); returns true for Lorentz.
template <bool VOIGT, typename T>
__device__ __forceinline__ bool shapes(const Pair& p, const Line& ln, T& k1,
                                       T& k2, T& k3) {
    bool use_lor = true;
    if (VOIGT) {
        const bool zlor = ln.hw * F(0.01) > ln.ad * F(0.99);
        use_lor = (fabsf(p.d1) > 100.0f * ln.ad) || zlor;
    }
    const T h = var<T>(ln.hw, 1);
    k2 = T(0.0f);
    if (use_lor) {
        k1 = lorentz(var<T>(p.d1, 0), h);
        if (p.need_k2) k2 = lorentz(var<T>(p.dsum, 0), h);
        k3 = pedestal<VOIGT>(h);
    } else {
        k1 = sd_shape<T>(p.d1, ln);
        if (p.need_k2) k2 = sd_shape<T>(p.dsum, ln);
        k3 = T(ln.k3v);
    }
    return use_lor;
}

// The LSF branch trees (modm.f90:567-831) -> sls.
__device__ __forceinline__ float branch_trees(const Pair& p, const Line& ln,
                                              float k1, float k2, float k3) {
    const float ya = ln.ya, yb = ln.yb;
    const float y1 = 1.0f + ya * p.d1 + yb;
    if (p.o2) {
        if (p.cpl) {
            const float y2 = 1.0f - ya * p.dsum + yb;
            return (ln.flags & FL_XF1) ? k1 * y1 + k2 * y2 : k1 + k2;
        }
        return p.within ? k1 + (p.mirror ? k2 : 0.0f) : 0.0f;
    }
    if (ln.flags & FL_CO2) {
        const float ped = 2.0f - (p.d1 * p.d1) / CUT2;
        const float xp4 = k3 * ped;
        return (p.cpl && (ln.flags & FL_XF15))
                   ? k1 * y1 - xp4 - k3 * ((y1 - 1.0f) * ped)
                   : k1 - xp4;
    }
    if (p.cpl) {
        const float y2 = 1.0f - ya * p.dsum + yb;
        const float y1p = 1.0f + ya * CUT + yb;
        const float y2p = 1.0f - ya * CUT + yb;
        return y1 * k1 - y1p * k3 + (p.mirror ? y2 * k2 - y2p * k3 : 0.0f);
    }
    return k1 - k3 + (p.mirror ? k2 - k3 : 0.0f);
}

// ---- the adjoint of one (wavenumber, line) evaluation ---------------------

// indices of the seven per-(layer, line) cotangents, in PER_LN order
enum { D_SHIFT, D_STILD, D_HW, D_AD, D_K3V, D_YA, D_YB, N_COT };

// The adjoint of sls * stild given the shapes as dual numbers: adds gb
// times its partial derivatives by the seven per-(layer, line) operands to
// acc.  The branch trees' adjoint is written out by hand.
template <bool VOIGT>
__device__ __forceinline__ void tree_adjoint(const Pair& p, const Line& ln,
                                             const Dual& k1, const Dual& k2,
                                             const Dual& k3, bool use_lor,
                                             float gb, float* acc) {
    const float sls = branch_trees(p, ln, k1.v, k2.v, k3.v);

    // partials of sls by k1, k2, k3, the Y factors and the pedestal
    const float ya = ln.ya, yb = ln.yb;
    const float y1 = 1.0f + ya * p.d1 + yb;
    const float y2 = 1.0f - ya * p.dsum + yb;
    float a_k1 = 0.0f, a_k2 = 0.0f, a_k3 = 0.0f, a_y1 = 0.0f, a_y2 = 0.0f,
          a_y1p = 0.0f, a_y2p = 0.0f, a_ped = 0.0f;
    if (p.o2) {
        if (p.cpl) {
            if (ln.flags & FL_XF1) {      // k1*y1 + k2*y2
                a_k1 = y1; a_k2 = y2; a_y1 = k1.v; a_y2 = k2.v;
            } else {                      // k1 + k2
                a_k1 = 1.0f; a_k2 = 1.0f;
            }
        } else if (p.within) {            // k1 + (mirror ? k2 : 0)
            a_k1 = 1.0f;
            if (p.mirror) a_k2 = 1.0f;
        }
    } else if (ln.flags & FL_CO2) {
        const float ped = 2.0f - (p.d1 * p.d1) / CUT2;
        if (p.cpl && (ln.flags & FL_XF15)) {
            // k1*y1 - k3*ped - k3*((y1 - 1)*ped)
            a_k1 = y1;
            a_k3 = -ped - (y1 - 1.0f) * ped;
            a_y1 = k1.v - k3.v * ped;
            a_ped = -k3.v - k3.v * (y1 - 1.0f);
        } else {                          // k1 - k3*ped
            a_k1 = 1.0f; a_k3 = -ped; a_ped = -k3.v;
        }
    } else if (p.cpl) {
        // y1*k1 - y1p*k3 + (mirror ? y2*k2 - y2p*k3 : 0)
        const float y1p = 1.0f + ya * CUT + yb;
        a_k1 = y1; a_y1 = k1.v; a_k3 = -y1p; a_y1p = -k3.v;
        if (p.mirror) {
            const float y2p = 1.0f - ya * CUT + yb;
            a_k2 = y2; a_y2 = k2.v; a_k3 -= y2p; a_y2p = -k3.v;
        }
    } else {                              // k1 - k3 + (mirror ? k2 - k3 : 0)
        a_k1 = 1.0f; a_k3 = -1.0f;
        if (p.mirror) { a_k2 = 1.0f; a_k3 -= 1.0f; }
    }

    // y1 = 1 + ya*d1 + yb, y2 = 1 - ya*dsum + yb, y1p/y2p = 1 +- ya*25 + yb,
    // ped = 2 - d1^2/625; d1 moves with -shift, dsum with +shift
    const float s_d1 = a_k1 * k1.dn + a_y1 * ya
                       + a_ped * (-2.0f * p.d1 / CUT2);
    const float s_dsum = a_k2 * k2.dn - a_y2 * ya;
    const float gs = gb * ln.stild;       // cotangent of sls
    acc[D_SHIFT] += gs * (s_dsum - s_d1);
    acc[D_STILD] += gb * sls;
    acc[D_HW] += gs * (a_k1 * k1.dh + a_k2 * k2.dh + a_k3 * k3.dh);
    if (VOIGT) {
        acc[D_AD] += gs * (a_k1 * k1.da + a_k2 * k2.da);
        if (!use_lor) acc[D_K3V] += gs * a_k3;
    }
    acc[D_YA] += gs * (a_y1 * p.d1 - a_y2 * p.dsum + (a_y1p - a_y2p) * CUT);
    acc[D_YB] += gs * (a_y1 + a_y2 + a_y1p + a_y2p);
}

// The all-dual adjoint of one pair, Lorentz or SD-Voigt lane alike: the
// shapes' partials from the Dual instantiation of `shapes`.  No kernel
// calls it; the closed forms below are held against it.
template <bool VOIGT>
__device__ __forceinline__ void pair_adjoint(const Pair& p, const Line& ln,
                                             float gb, float* acc) {
    Dual k1, k2, k3;
    const bool use_lor = shapes<VOIGT>(p, ln, k1, k2, k3);
    tree_adjoint<VOIGT>(p, ln, k1, k2, k3, use_lor, gb, acc);
}

// The adjoint of one pair on an SD-Voigt lane.
__device__ __forceinline__ void sd_pair_adjoint(const Pair& p, const Line& ln,
                                                float gb, float* acc) {
    const Dual k1 = sd_shape<Dual>(p.d1, ln);
    const Dual k2 = p.need_k2 ? sd_shape<Dual>(p.dsum, ln) : Dual(0.0f);
    tree_adjoint<true>(p, ln, k1, k2, Dual(ln.k3v), false, gb, acc);
}

// The class of a line in the LSF branch trees: which formula gives sls.
// It depends on the line's flags alone.
enum TreeClass {
    T_O2_CPL_XF1,   // k1*y1 + k2*y2
    T_O2_CPL,       // k1 + k2
    T_O2,           // within ? k1 + (mirror ? k2 : 0) : 0
    T_CO2_XF15,     // k1*y1 - k3*ped - k3*((y1 - 1)*ped)
    T_CO2,          // k1 - k3*ped
    T_CPL,          // y1*k1 - y1p*k3 + (mirror ? y2*k2 - y2p*k3 : 0)
    T_PLAIN,        // k1 - k3 + (mirror ? k2 - k3 : 0)
    N_TREE_CLASS
};

__device__ __forceinline__ int tree_class(int flags) {
    const bool cpl = flags & FL_CPL;
    if (flags & FL_O2)
        return cpl ? ((flags & FL_XF1) ? T_O2_CPL_XF1 : T_O2_CPL) : T_O2;
    if (flags & FL_CO2)
        return (cpl && (flags & FL_XF15)) ? T_CO2_XF15 : T_CO2;
    return cpl ? T_CPL : T_PLAIN;
}

// The line with the flags of its class alone: pair_of and branch_trees
// take the same path on it as on the line's own flags, and where CLS is a
// compile-time constant their flag tests fold away.
template <int CLS>
__device__ __forceinline__ Line class_line(const Line& ln) {
    Line lc = ln;
    lc.flags = FL_VALID
               | (CLS == T_O2_CPL_XF1 ? FL_O2 | FL_CPL | FL_XF1
                  : CLS == T_O2_CPL   ? FL_O2 | FL_CPL
                  : CLS == T_O2       ? FL_O2
                  : CLS == T_CO2_XF15 ? FL_CO2 | FL_CPL | FL_XF15
                  : CLS == T_CO2      ? FL_CO2
                  : CLS == T_CPL      ? FL_CPL
                                      : 0);
    return lc;
}

// f.template operator()<CLS>() for the class cls: how one thread enters
// the code specialised for its line's class
template <typename F>
__device__ __forceinline__ auto for_class(int cls, F f) {
    switch (cls) {
        case T_O2_CPL_XF1: return f.template operator()<T_O2_CPL_XF1>();
        case T_O2_CPL: return f.template operator()<T_O2_CPL>();
        case T_O2: return f.template operator()<T_O2>();
        case T_CO2_XF15: return f.template operator()<T_CO2_XF15>();
        case T_CO2: return f.template operator()<T_CO2>();
        case T_CPL: return f.template operator()<T_CPL>();
        default: return f.template operator()<T_PLAIN>();
    }
}

// What a Lorentz lane's adjoint needs of its line and layer but not of
// the wavenumber: one thread of the adjoint kernel owns one (layer, line)
// for its whole sweep and computes this once.
struct LinePre {
    float hw_pi, hw2;         // the forward's hw/pi and hw^2
    float two_hw, inv_hw_pi;  // for the closed-form partials
    float k3, k3_dh;          // a Lorentz lane's pedestal, its d/d hw
    float y1p, y2p;           // the Y factors at +-25 cm^-1
    float ad100;              // 100 aD
    bool zlor;                // zeta > 0.99: every lane is Lorentz
    int cls;                  // TreeClass
};

template <bool VOIGT>
__device__ __forceinline__ LinePre line_pre(const Line& ln) {
    LinePre pre;
    pre.hw_pi = ln.hw * INV_PI;
    pre.hw2 = ln.hw * ln.hw;
    pre.two_hw = 2.0f * ln.hw;
    pre.inv_hw_pi = pre.hw_pi > 0.0f ? 1.0f / pre.hw_pi : 0.0f;
    const Dual k3 = pedestal<VOIGT>(var<Dual>(ln.hw, 1));
    pre.k3 = k3.v;
    pre.k3_dh = k3.dh;
    pre.y1p = 1.0f + ln.ya * CUT + ln.yb;
    pre.y2p = 1.0f - ln.ya * CUT + ln.yb;
    pre.ad100 = 100.0f * ln.ad;
    pre.zlor = VOIGT ? ln.hw * F(0.01) > ln.ad * F(0.99) : true;
    pre.cls = tree_class(ln.flags);
    return pre;
}

// The lane's switch (modm.f90:419-431), as `shapes` takes it.
template <bool VOIGT>
__device__ __forceinline__ bool lorentz_lane(float d1, const LinePre& pre) {
    return !VOIGT || fabsf(d1) > pre.ad100 || pre.zlor;
}

// a * b + c in one rounding, for the partials and their sums.  Values (the
// shapes, sls, d_stild) never go through it: they round as the forward
// does, whose sources are built without contraction.
__device__ __forceinline__ float mad(float a, float b, float c) {
#ifdef __CUDA_ARCH__
    return __fmaf_rn(a, b, c);
#else
    return fmaf(a, b, c);
#endif
}

// The Lorentz shape at detuning dd as the forward computes it, and its
// partials by dd and hw from the value: with r = 1/(hw^2 + dd^2) =
// k / (hw/pi), dk/ddd = -2 dd k r and dk/dhw = (1/pi - 2 hw k) r.
__device__ __forceinline__ void lorentz_partials(float dd, const LinePre& pre,
                                                 float& k, float& k_dn,
                                                 float& k_dh) {
    k = pre.hw_pi / (pre.hw2 + dd * dd);
    const float r = k * pre.inv_hw_pi;
    k_dn = -2.0f * dd * k * r;
    k_dh = mad(-pre.two_hw, k, INV_PI) * r;
}

// The adjoint of one pair on a Lorentz lane of a line of class CLS; lc is
// class_line<CLS> of the line.  sls is the forward's (branch_trees on the
// forward's values); the partials are those tree_adjoint forms for the
// class, with the terms that are zero for it left out.  A Lorentz lane
// gives aD and k3v no cotangent.
template <int CLS>
__device__ __forceinline__ void lorentz_class_adjoint(const Pair& p,
                                                      const Line& lc,
                                                      const LinePre& pre,
                                                      float gb, float* acc) {
    if (CLS == T_O2 && !p.within) return;     // sls = 0 and so its partials
    float k1, k1_dn, k1_dh, k2 = 0.0f, k2_dn = 0.0f, k2_dh = 0.0f;
    lorentz_partials(p.d1, pre, k1, k1_dn, k1_dh);
    if (CLS != T_CO2 && CLS != T_CO2_XF15 && p.need_k2)
        lorentz_partials(p.dsum, pre, k2, k2_dn, k2_dh);
    const float k3 = pre.k3, ya = lc.ya;
    const float sls = branch_trees(p, lc, k1, k2, k3);

    // the partials of sls by d1, dsum, hw, ya and yb
    float s_d1, s_dsum = 0.0f, s_hw, s_ya = 0.0f, s_yb = 0.0f;
    constexpr bool has_y = CLS == T_O2_CPL_XF1 || CLS == T_CPL
                           || CLS == T_CO2_XF15;
    if (CLS == T_PLAIN) {
        s_d1 = k1_dn;
        s_dsum = k2_dn;
        s_hw = mad(p.mirror ? -2.0f : -1.0f, pre.k3_dh, k1_dh + k2_dh);
    } else if (CLS == T_O2_CPL || CLS == T_O2) {
        s_d1 = k1_dn;
        s_dsum = k2_dn;
        s_hw = k1_dh + k2_dh;
    } else if (CLS == T_O2_CPL_XF1) {
        const float y1 = 1.0f + ya * p.d1 + lc.yb;
        const float y2 = 1.0f - ya * p.dsum + lc.yb;
        s_d1 = mad(y1, k1_dn, k1 * ya);
        s_dsum = mad(y2, k2_dn, -(k2 * ya));
        s_hw = mad(y1, k1_dh, y2 * k2_dh);
        s_ya = mad(k1, p.d1, -(k2 * p.dsum));
        s_yb = k1 + k2;
    } else if (CLS == T_CPL) {
        const float y1 = 1.0f + ya * p.d1 + lc.yb;
        s_d1 = mad(y1, k1_dn, k1 * ya);
        if (p.mirror) {
            const float y2 = 1.0f - ya * p.dsum + lc.yb;
            s_dsum = mad(y2, k2_dn, -(k2 * ya));
            s_hw = mad(-pre.y1p - pre.y2p, pre.k3_dh,
                       mad(y1, k1_dh, y2 * k2_dh));
            s_ya = mad(k1, p.d1, -(k2 * p.dsum));
            s_yb = k1 + k2 - k3 - k3;
        } else {
            s_hw = mad(y1, k1_dh, -(pre.y1p * pre.k3_dh));
            s_ya = mad(k1, p.d1, -(k3 * CUT));
            s_yb = k1 - k3;
        }
    } else {                                  // CO2
        const float ped = 2.0f - (p.d1 * p.d1) / CUT2;
        const float ped_d1 = -2.0f * p.d1 / CUT2;
        if (CLS == T_CO2_XF15) {
            const float y1 = 1.0f + ya * p.d1 + lc.yb;
            const float a_y1 = k1 - k3 * ped;
            s_d1 = mad(-k3 - k3 * (y1 - 1.0f), ped_d1,
                       mad(y1, k1_dn, a_y1 * ya));
            s_hw = mad(-ped - (y1 - 1.0f) * ped, pre.k3_dh, y1 * k1_dh);
            s_ya = a_y1 * p.d1;
            s_yb = a_y1;
        } else {
            s_d1 = mad(-k3, ped_d1, k1_dn);
            s_hw = mad(-ped, pre.k3_dh, k1_dh);
        }
    }
    const float gs = gb * lc.stild;           // cotangent of sls
    acc[D_SHIFT] = mad(gs, s_dsum - s_d1, acc[D_SHIFT]);
    acc[D_STILD] += gb * sls;
    acc[D_HW] = mad(gs, s_hw, acc[D_HW]);
    if (has_y) {
        acc[D_YA] = mad(gs, s_ya, acc[D_YA]);
        acc[D_YB] = mad(gs, s_yb, acc[D_YB]);
    }
}

// ---- one thread's run over a tile of wavenumbers --------------------------

// Adds to acc the adjoint of every Lorentz-lane pair of line ln with the
// wt wavenumbers (whi + wlo), in wavenumber order; g[w * g_stride] is the
// cotangent at wavenumber w and the line's molecule.  Returns true where
// the tile holds SD-Voigt lanes of this line, which it leaves out.  The
// loop is compiled once per class of the branch trees, so that inside it
// only what varies with the wavenumber branches (the window, the mirror
// term, the lane switch); the lines of a tile are mostly of one class,
// and a warp that holds several runs the loop of each in turn.
template <bool VOIGT>
struct SweepTile {
    const float* whi;
    const float* wlo;
    const float* g;
    int g_stride, wt;
    const Line& ln;
    const LinePre& pre;
    float* acc;
    template <int CLS> __device__ __forceinline__ bool operator()() const {
        const Line lc = class_line<CLS>(ln);
        bool deferred = false;
#pragma unroll 2
        for (int w = 0; w < wt; ++w) {
            Pair p;
            if (!pair_of(whi[w], wlo[w], lc, p)) continue;
            if (!lorentz_lane<VOIGT>(p.d1, pre)) {
                deferred = true;
                continue;
            }
            lorentz_class_adjoint<CLS>(p, lc, pre, g[w * g_stride], acc);
        }
        return deferred;
    }
};
template <bool VOIGT>
__device__ __forceinline__ bool sweep_tile(const float* whi, const float* wlo,
                                           const float* g, int g_stride,
                                           int wt, const Line& ln,
                                           const LinePre& pre, float* acc) {
    return for_class(pre.cls, SweepTile<VOIGT>{whi, wlo, g, g_stride, wt, ln,
                                               pre, acc});
}

// The pairs sweep_tile left out: the adjoint of every SD-Voigt-lane pair
// of the same tile, in wavenumber order.
__device__ __forceinline__ void deferred_tile(const float* whi,
                                              const float* wlo,
                                              const float* g, int g_stride,
                                              int wt, const Line& ln,
                                              const LinePre& pre,
                                              float* acc) {
    for (int w = 0; w < wt; ++w) {
        Pair p;
        if (!pair_of(whi[w], wlo[w], ln, p)) continue;
        if (lorentz_lane<true>(p.d1, pre)) continue;
        sd_pair_adjoint(p, ln, g[w * g_stride], acc);
    }
}

// ---- the forward: one thread's run over a chunk of staged lines -----------
//
// The forward kernel (linesum.cu) stages a chunk of a candidate tile's
// lines in shared memory for a block of wavenumbers; every thread then
// walks the staged lines in order for its NW wavenumbers.  What depends on
// the (layer, line) alone is computed once, by the thread that stages the
// line (FwdLine), and the walk is compiled once per class of the branch
// trees (for_class), over runs of consecutive lines of one class and
// molecule.  The sum of each (wavenumber, molecule) takes the same adds of
// the same values, formed by the same float operations, in the same order
// as the unhoisted evaluation (pair_of, shapes, branch_trees, then
// acc[m] += sls * stild, line by line): the results are bitwise those of
// that loop (tests/test_torch_fwd_math.py holds them so).

// One staged line in one layer: the raw operands the walk reads and what
// it would otherwise recompute at every wavenumber.
struct alignas(16) FwdLine {
    float nu_hi, nu_lo, shift, xnu;   // d1 and dsum as pair_of forms them
    float hw_pi, hw2, k3, stild;      // lorentz's hw/pi and hw^2; pedestal
    float ya, yb, y1pk3, y2pk3;       // Y factors; y1p * k3 and y2p * k3
    float ad100;                      // the lane switch: 100 aD ...
    int zlor;                         // ... and zeta > 0.99 (VOIGT)
    int flags;
    int key;                          // fwd_key
};
// The operands an SD-Voigt lane reads beside them (VOIGT).
struct FwdSd {
    float hw, ad, sdep, k3v;
};

template <bool VOIGT>
__device__ __forceinline__ FwdLine fwd_line(const Line& ln) {
    FwdLine f;
    f.nu_hi = ln.nu_hi;
    f.nu_lo = ln.nu_lo;
    f.shift = ln.shift;
    f.xnu = ln.nu_hi + (ln.nu_lo + ln.shift);
    f.hw_pi = ln.hw * INV_PI;
    f.hw2 = ln.hw * ln.hw;
    f.k3 = pedestal<VOIGT>(ln.hw);
    f.stild = ln.stild;
    f.ya = ln.ya;
    f.yb = ln.yb;
    f.y1pk3 = (1.0f + ln.ya * CUT + ln.yb) * f.k3;
    f.y2pk3 = (1.0f - ln.ya * CUT + ln.yb) * f.k3;
    f.ad100 = 100.0f * ln.ad;
    f.zlor = VOIGT ? ln.hw * F(0.01) > ln.ad * F(0.99) : 1;
    f.flags = ln.flags;
    f.key = -1;
    return f;
}

__device__ __forceinline__ FwdSd fwd_sd(const Line& ln) {
    return FwdSd{ln.hw, ln.ad, ln.sdep, ln.k3v};
}

// The key of a line staged for the wavenumbers [wmin, wmax]: molecule * 8
// + class of the branch trees, or -1 for a line that adds nothing to any
// of them: invalid, of no molecule in [0, n_mol), or (all but coupled O2)
// outside the 25 cm^-1 window of every one of them by a margin far wider
// than d1's rounding (a few ulps of |wn| + |nu| + |shift|).  An uncoupled
// O2 line adds sls = 0 there, 0 * stild, which changes no bit of a sum
// that is never -0 (stild finite).
__device__ __forceinline__ int fwd_key(int fl, int m, int n_mol, float xnu,
                                       float shift, float wmin, float wmax) {
    if (!(fl & FL_VALID) || m < 0 || m >= n_mol) return -1;
    const int cls = tree_class(fl);
    if (cls != T_O2_CPL_XF1 && cls != T_O2_CPL) {
        const float tol = 1.0e-3f + 1.0e-5f * (fabsf(wmin) + fabsf(wmax)
                                               + fabsf(xnu) + fabsf(shift));
        if (xnu < wmin - (CUT + tol) || xnu > wmax + (CUT + tol)) return -1;
    }
    return m * 8 + cls;
}

// sls of an SD-Voigt lane, as `shapes` and `branch_trees` form it.  Not
// inlined: nearly no lane takes it, and inlined, the Humlicek regions'
// registers would be the whole walk's.
inline __device__ __noinline__ float sd_lane_sls(const FwdLine& f,
                                                 const FwdSd& sd, float d1,
                                                 float dsum) {
    const Line ln{f.nu_hi, f.nu_lo, sd.sdep, f.shift, f.stild,
                  sd.hw, sd.ad, sd.k3v, f.ya, f.yb, f.flags};
    Pair p;
    p.d1 = d1;
    p.dsum = dsum;
    p.mirror = (dsum - CUT) <= 0.0f;
    p.within = fabsf(d1) <= CUT;
    p.o2 = ln.flags & FL_O2;
    p.cpl = ln.flags & FL_CPL;
    p.need_k2 = p.mirror || (p.o2 && p.cpl);
    const float k1 = sd_shape<float>(d1, ln);
    const float k2 = p.need_k2 ? sd_shape<float>(dsum, ln) : 0.0f;
    return branch_trees(p, ln, k1, k2, ln.k3v);
}

// branch_trees for class CLS on a Lorentz lane inside the window (coupled
// O2: anywhere), with the products of per-line terms taken from f.
template <int CLS>
__device__ __forceinline__ float fwd_tree(const FwdLine& f, float d1,
                                          float dsum, bool mirror, float k1,
                                          float k2) {
    const float k3 = f.k3;
    if (CLS == T_O2_CPL_XF1) {
        const float y1 = 1.0f + f.ya * d1 + f.yb;
        const float y2 = 1.0f - f.ya * dsum + f.yb;
        return k1 * y1 + k2 * y2;
    }
    if (CLS == T_O2_CPL) return k1 + k2;
    if (CLS == T_O2) return k1 + (mirror ? k2 : 0.0f);
    if (CLS == T_CO2_XF15 || CLS == T_CO2) {
        const float ped = 2.0f - (d1 * d1) / CUT2;
        const float xp4 = k3 * ped;
        if (CLS == T_CO2) return k1 - xp4;
        const float y1 = 1.0f + f.ya * d1 + f.yb;
        return k1 * y1 - xp4 - k3 * ((y1 - 1.0f) * ped);
    }
    if (CLS == T_CPL) {
        const float y1 = 1.0f + f.ya * d1 + f.yb;
        const float y2 = 1.0f - f.ya * dsum + f.yb;
        return y1 * k1 - f.y1pk3 + (mirror ? y2 * k2 - f.y2pk3 : 0.0f);
    }
    return k1 - k3 + (mirror ? k2 - k3 : 0.0f);
}

// acc += sls * stild for line f, staged at s[q] and sd[q], of class CLS
// at wavenumber whi + wlo, where it is kept.  (dsum - 25) <= 0 is
// dsum <= 25 exactly: for dsum in [12.5, 50] the difference is exact,
// outside that range it has dsum's side.
template <bool VOIGT, int CLS>
__device__ __forceinline__ void fwd_pair(const FwdLine& f, const FwdLine* s,
                                         const FwdSd* sd, int q, float whi,
                                         float wlo, float& acc) {
    constexpr bool o2_cpl = CLS == T_O2_CPL_XF1 || CLS == T_O2_CPL;
    const float d1 = (whi - f.nu_hi) + (wlo - f.nu_lo) - f.shift;
    // outside the window only coupled O2 adds (uncoupled O2: see fwd_key)
    if (!o2_cpl && !(fabsf(d1) <= CUT)) return;
    const float dsum = whi + f.xnu;
    const bool mirror = dsum <= CUT;
    float sls;
    if (VOIGT && !(fabsf(d1) > f.ad100 || f.zlor)) {
        sls = sd_lane_sls(s[q], sd[q], d1, dsum);
    } else {
        const float k1 = f.hw_pi / (f.hw2 + d1 * d1);
        float k2 = 0.0f;
        if (CLS != T_CO2 && CLS != T_CO2_XF15 && (o2_cpl || mirror))
            k2 = f.hw_pi / (f.hw2 + dsum * dsum);
        sls = fwd_tree<CLS>(f, d1, dsum, mirror, k1, k2);
    }
    acc += sls * f.stild;
}

// The run of staged lines [q, ...) that share line q's key, each at the
// thread's NW wavenumbers; leaves q at the run's end.  The lines are
// read through a pointer carried from one iteration to the next (through
// s[q], ptxas re-derives the shared window's base in every iteration,
// behind the divide's slow-path call), and q is counted beside it (p - s
// is a difference of generic pointers).
template <bool VOIGT, int NW>
struct FwdRun {
    const FwdLine* s;
    const FwdSd* sd;
    const float* whi;
    const float* wlo;
    float* acc;
    int& q;
    template <int CLS> __device__ __forceinline__ void operator()() const {
        const FwdLine* p = s + q;
        const int k = p->key;
#pragma unroll 2
        do {
            const FwdLine f = *p;
#pragma unroll
            for (int r = 0; r < NW; ++r)
                fwd_pair<VOIGT, CLS>(f, s, sd, q, whi[r], wlo[r], acc[r]);
            ++q;
        } while ((++p)->key == k);
    }
};

// Writes the running sums acc[r] of molecule cur_m back to rows[r].
template <int NW>
__device__ __forceinline__ void fwd_flush(float* acc, int cur_m,
                                          float* const* rows) {
    if (cur_m < 0) return;
#pragma unroll
    for (int r = 0; r < NW; ++r)
        if (rows[r]) rows[r][cur_m] = acc[r];
}

// One thread's walk over the n lines staged in s / sd, their keys in
// s[].key (none -1) and s[n].key = -1, for its NW wavenumbers
// whi[r] + wlo[r].  acc[r] is the running sum of molecule cur_m (-1: none
// yet) at wavenumber r, whose sums live at rows[r][0, n_mol) (null: a
// lane without a wavenumber): the sum is written back and the next
// molecule's read where the molecule changes, which the catalog's order
// makes rare.  Call fwd_flush after the last chunk.
template <bool VOIGT, int NW>
__device__ __forceinline__ void fwd_chunk(const FwdLine* s, const FwdSd* sd,
                                          int n, const float* whi,
                                          const float* wlo, float* acc,
                                          int& cur_m, float* const* rows) {
    int q = 0;
    while (q < n) {
        const int key = s[q].key;
        const int m = key >> 3;
        if (m != cur_m) {
            fwd_flush<NW>(acc, cur_m, rows);
#pragma unroll
            for (int r = 0; r < NW; ++r) acc[r] = rows[r] ? rows[r][m] : 0.0f;
            cur_m = m;
        }
        for_class(key & 7, FwdRun<VOIGT, NW>{s, sd, whi, wlo, acc, q});
    }
}

#undef R
#undef F

}  // namespace linesum
