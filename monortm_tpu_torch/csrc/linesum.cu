// Block-sparse line-by-line sum for NVIDIA Hopper (sm_90a).
//
// Replaces monortm_tpu/ops/linesum_pallas.py::_kernel (the Pallas TPU
// forward line sum) and, instantiated with VOIGT=false,
// monortm_tpu/ops/linesum_lorentz.py::line_od_lorentz_xla (the all-Lorentz
// engine, plain XLA in the JAX package).  Both compute
//
//   sf[l, w, m] = sum over candidate line tiles k of wn tile w/wt,
//                 sum over lines n of tile k with mol[n] == m,
//                 keep(l, w, n) * SLS(l, w, n) * stild[l, n]
//
// with the reference's shape switch (Lorentz / speed-dependent Voigt,
// modm.f90:419-431), 25 cm^-1 window and pedestal, line coupling and the
// O2 / CO2 / other branch trees (modm.f90:567-831), evaluated in the same
// operation order as the JAX kernel.
//
// What bounds it: FP32 arithmetic, not memory.  Each (layer, wavenumber,
// line) evaluation reads nothing from device memory (a tile's 12 operands
// per line are staged once in shared memory for the whole block) and
// costs one IEEE divide on the Lorentz path, or the rationals, exp and
// sincos of the Humlicek regions on the SD-Voigt path.  So the design
// spends its effort on doing less arithmetic, not on moving bytes:
//   - every thread branches: Lorentz or SD-Voigt per lane, exactly one
//     W4 / SD-Humlicek region per point, the plain Voigt alone where the
//     speed dependence is off, and no k2 = K(wn + nu) evaluation unless
//     the mirror term or coupled O2 needs it (the per-lane form of the
//     TPU kernel's block-level gates);
//   - a masked line (outside the 25 cm^-1 window, invalid, or attributed
//     to no molecule) costs a compare and nothing else;
//   - VOIGT=false compiles the Voigt branch out for the all-Lorentz layers.
// Division, sqrt, exp, expm1, sin and cos stay IEEE (no fast math), and
// multiply-adds are not contracted (-fmad=false), so the kernel rounds
// like the plain PyTorch version beside it.
//
// Work split: one block per (wn tile, layer), one thread per wavenumber.
// The block walks its own candidate-map row in order (replacing the TPU's
// scalar prefetch), stages each valid tile's lines in shared memory, and
// every thread adds its contributions into its own row of a shared
// [wt, n_mol] accumulator.  No atomics and no split over lines, so the
// summation order is fixed and results are reproducible run to run.
//
// Built by monortm_tpu_torch/ops/linesum_kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

#define F(x) (static_cast<float>(x))

// constants as the JAX package forms them: a Python double rounded to f32
constexpr float PI_F = F(3.1415926535898);             // constants.PI
constexpr float SQRT_LN2 = F(0.8325546111576977);      // sqrt(ln 2)
constexpr float RSQRT_PI_LN2 = F(0.46971863934982516); // sqrt(ln2 / PI)
constexpr float INV_SQRT2 = F(0.7071067811865475);
constexpr float QUARTER_INV_LN2 = F(0.36067376022224085);  // 1/4/ln 2
constexpr float INV_PI = F(0.31830987334251404);       // f32(1/pi)
constexpr float CUT = 25.0f;                           // DELTNU_CUT
constexpr float CUT2 = 625.0f;

// line flags, bit per linesum_pallas.FLAGS entry
constexpr int FL_O2 = 1, FL_CO2 = 2, FL_CPL = 4, FL_XF1 = 8, FL_XF15 = 16,
              FL_VALID = 32;

constexpr int CHUNK = 256;   // lines staged in shared memory at a time
constexpr int N_STAGED = 12; // staged arrays: 3 per line, 7 per (layer,
                             // line), flags, molecule

// ---- Humlicek rationals, real-pair complex arithmetic (ops/voigt.py) ----

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
    cr = ar * br - ai * bi;
    ci = ar * bi + ai * br;
}

__device__ __forceinline__ float cdiv_re(float ar, float ai, float br,
                                         float bi) {
    float d = br * br + bi * bi;
    return (ar * br + ai * bi) / d;
}

__device__ float w_region1(float tr, float ti) {
    float ur, ui;
    cmul(tr, ti, tr, ti, ur, ui);
    return cdiv_re(F(0.5641896) * tr, F(0.5641896) * ti, 0.5f + ur, ui);
}

__device__ float w_region2(float tr, float ti) {
    float ur, ui, nr, ni, dr, di;
    cmul(tr, ti, tr, ti, ur, ui);
    cmul(tr, ti, F(1.410474) + F(0.5641896) * ur, F(0.5641896) * ui, nr, ni);
    cmul(ur, ui, 3.0f + ur, ui, dr, di);
    return cdiv_re(nr, ni, 0.75f + dr, di);
}

__device__ float w_region3(float tr, float ti) {
    const float num[5] = {F(0.5642236), F(3.778987), F(11.96482),
                          F(20.20933), F(16.4955)};
    const float den[6] = {F(1.0), F(6.699398), F(21.69274), F(39.27121),
                          F(38.82363), F(16.4955)};
    float nr = num[0], ni = 0.0f, dr = den[0], di = 0.0f, cr, ci;
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

__device__ float w_region4(float tr, float ti) {
    const float num[7] = {F(0.56419), F(1.320522), F(35.76683), F(219.0313),
                          F(1540.787), F(3321.9905), F(36183.31)};
    const float den[8] = {F(1.0), F(1.841439), F(61.57037), F(364.2191),
                          F(2186.181), F(9022.228), F(24322.84),
                          F(32066.6)};
    float ur, ui, qr, qi;
    cmul(tr, ti, tr, ti, ur, ui);
    // alternating-sign polynomials in u as written in the reference
    float nr = num[0], ni = 0.0f;
#pragma unroll
    for (int k = 1; k < 7; ++k) {
        cmul(ur, ui, nr, ni, qr, qi);
        nr = num[k] - qr;
        ni = -qi;
    }
    float dr = den[0], di = 0.0f;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        cmul(ur, ui, dr, di, qr, qi);
        dr = den[k] - qr;
        di = -qi;
    }
    float d = dr * dr + di * di;
    float fr = (nr * dr + ni * di) / d;
    float fi = (ni * dr - nr * di) / d;
    float pr = tr * fr - ti * fi;   // Re[t * num / den]
    // Re[cexp(u) - t*num/den]
    return expf(ur) * cosf(ui) - pr;
}

// Re[w(x + i y)], Humlicek W4 (modm.f90:1100-1130): one region per point
__device__ float w4_real(float x, float y) {
    float tr = y, ti = -x;
    float s = fabsf(x) + y;
    if (s >= 15.0f) return w_region1(tr, ti);
    if (s >= 5.5f) return w_region2(tr, ti);
    if (y < F(0.195) * fabsf(x) - F(0.176)) return w_region4(tr, ti);
    return w_region3(tr, ti);
}

// VOIGT (modm.f90:900-962)
__device__ float voigt(float dnu, float al, float ad) {
    if (!(ad > 0.0f)) return al / (PI_F * (al * al + dnu * dnu));
    float x = SQRT_LN2 * dnu / ad;
    float y = SQRT_LN2 * al / ad;
    return w4_real(x, y) * RSQRT_PI_LN2 / ad;
}

// SD_Humlicek region id (boundaries 15/6; modm.f90:1160-1179)
__device__ __forceinline__ int sd_region(float s, float xh, float yh) {
    if (s >= 15.0f) return 1;
    if (s >= 6.0f) return 2;
    return (yh < F(0.195) * fabsf(xh) - F(0.176)) ? 4 : 3;
}

// Re[w] for combined region r, per-point 4 -> 3 fallback
// (modm.f90:1217-1247)
__device__ float w_by_region(float tr, float ti, int r, bool own4) {
    if (r == 1) return w_region1(tr, ti);
    if (r == 2) return w_region2(tr, ti);
    if (r == 4 && own4) return w_region4(tr, ti);
    return w_region3(tr, ti);
}

__device__ __forceinline__ float safe_sqrt(float u) {
    return u > 0.0f ? sqrtf(u) : 0.0f;
}

// SDVOIGT (modm.f90:965-1087), Boone et al. 2011 two-point form, with the
// f32 fallback to the plain Voigt where delta > 1e6 (ops/voigt.py)
__device__ float sdvoigt(float dnu, float al, float ad, float sdep) {
    bool use_sd = fabsf(sdep) > F(1.0e-4);
    float sdep_safe = use_sd ? sdep : 1.0f;
    float gamma2 = al * sdep_safe;
    float g2 = gamma2 != 0.0f ? gamma2 : 1.0f;
    float alfa = al / g2 - 1.5f;
    float beta = dnu / g2;
    float delta = QUARTER_INV_LN2 * (ad * ad / g2 / g2);
    if (!(use_sd && delta < 1.0e6f)) return voigt(dnu, al, ad);
    float ad_safe = ad > 0.0f ? ad : 1.0f;
    float alfadelta = alfa + delta;
    float tmp = safe_sqrt(alfadelta * alfadelta + beta * beta);
    float sqrt_delta = safe_sqrt(delta);
    float x1 = INV_SQRT2 * safe_sqrt(tmp + alfadelta) - sqrt_delta;
    float x2 = x1 + 2.0f * sqrt_delta;
    float h = (tmp - delta - alfa) / 2.0f;
    float sgn = beta > 0.0f ? 1.0f : (beta < 0.0f ? -1.0f : 0.0f);
    float y1 = sgn * safe_sqrt(h > 0.0f ? h : 0.0f);
    float s1 = fabsf(y1) + x1;
    float s2 = fabsf(y1) + x2;
    int r1 = sd_region(s1, y1, x1);
    int r2 = sd_region(s2, y1, x2);
    int r = r1 > r2 ? r1 : r2;
    float w1 = w_by_region(x1, -y1, r, r1 == 4);
    float w2 = w_by_region(x2, -y1, r, r2 == 4);
    return (w1 - w2) * RSQRT_PI_LN2 / ad_safe;
}

// ---- the line sum --------------------------------------------------------

template <bool VOIGT>
__global__ void linesum_kernel(
    const int* __restrict__ cmap, const int* __restrict__ cvalid,
    int n_cand,
    const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
    const float* __restrict__ nu_hi, const float* __restrict__ nu_lo,
    const float* __restrict__ sdep, const int* __restrict__ flags,
    const int* __restrict__ mol,
    const float* __restrict__ shift, const float* __restrict__ stild,
    const float* __restrict__ hw, const float* __restrict__ ad,
    const float* __restrict__ k3v, const float* __restrict__ ya,
    const float* __restrict__ yb,
    int n_lines, int nt, int n_tiles, int n_mol, int acc_stride, int wp,
    float* __restrict__ out) {
    extern __shared__ float smem[];
    const int wt = blockDim.x;
    float* acc = smem;                              // [wt][acc_stride]
    float* s_nu_hi = acc + wt * acc_stride;
    float* s_nu_lo = s_nu_hi + CHUNK;
    float* s_sdep = s_nu_lo + CHUNK;
    float* s_shift = s_sdep + CHUNK;
    float* s_stild = s_shift + CHUNK;
    float* s_hw = s_stild + CHUNK;
    float* s_ad = s_hw + CHUNK;
    float* s_k3v = s_ad + CHUNK;
    float* s_ya = s_k3v + CHUNK;
    float* s_yb = s_ya + CHUNK;
    int* s_flags = reinterpret_cast<int*>(s_yb + CHUNK);
    int* s_mol = s_flags + CHUNK;

    const int i = blockIdx.x;        // wavenumber tile
    const int l = blockIdx.y;        // flat layer
    const int w = threadIdx.x;       // wavenumber within the tile
    const float whi = wn_hi[i * wt + w];
    const float wlo = wn_lo[i * wt + w];
    float* my_acc = acc + w * acc_stride;
    for (int m = 0; m < n_mol; ++m) my_acc[m] = 0.0f;
    const size_t row = static_cast<size_t>(l) * n_lines;

    for (int j = 0; j < n_cand; ++j) {
        if (!cvalid[i * n_cand + j]) continue;
        const int k = cmap[i * n_cand + j];
        if (k < 0 || k >= n_tiles) continue;
        for (int c0 = 0; c0 < nt; c0 += CHUNK) {
            const int nc = min(CHUNK, nt - c0);
            __syncthreads();             // the previous chunk is consumed
            for (int q = w; q < nc; q += wt) {
                const size_t n = static_cast<size_t>(k) * nt + c0 + q;
                s_nu_hi[q] = nu_hi[n];
                s_nu_lo[q] = nu_lo[n];
                s_sdep[q] = sdep[n];
                s_flags[q] = flags[n];
                s_mol[q] = mol[n];
                s_shift[q] = shift[row + n];
                s_stild[q] = stild[row + n];
                s_hw[q] = hw[row + n];
                s_ad[q] = ad[row + n];
                s_k3v[q] = k3v[row + n];
                s_ya[q] = ya[row + n];
                s_yb[q] = yb[row + n];
            }
            __syncthreads();
            for (int q = 0; q < nc; ++q) {
                const int fl = s_flags[q];
                const int m = s_mol[q];
                // block-uniform: invalid lines and lines of molecules
                // outside [0, n_mol) contribute nothing (the one-hot row
                // of the JAX kernel is zero there)
                if (!(fl & FL_VALID) || m < 0 || m >= n_mol) continue;
                const float nhi = s_nu_hi[q], nlo = s_nu_lo[q];
                const float sh = s_shift[q];
                const float xnu = nhi + (nlo + sh);
                const float d1 = (whi - nhi) + (wlo - nlo) - sh;
                const float dsum = whi + xnu;
                const bool mirror = (dsum - CUT) <= 0.0f;
                const bool within = fabsf(d1) <= CUT;
                const bool is_o2 = fl & FL_O2;
                if (!(within || is_o2)) continue;     // 25 cm^-1 window
                const bool cpl = fl & FL_CPL;
                const bool need_k2 = mirror || (is_o2 && cpl);
                const float h = s_hw[q];

                float k1, k2 = 0.0f, k3;
                bool use_lor = true;
                float a = 0.0f;
                if (VOIGT) {
                    a = s_ad[q];
                    const bool zlor = h * F(0.01) > a * F(0.99);
                    use_lor = (fabsf(d1) > 100.0f * a) || zlor;
                }
                if (use_lor) {
                    const float hw_pi = h * INV_PI;
                    const float hw2 = h * h;
                    k1 = hw_pi / (hw2 + d1 * d1);
                    if (need_k2) k2 = hw_pi / (hw2 + dsum * dsum);
                    if (VOIGT) {
                        const float z = CUT / h;
                        k3 = 1.0f / (PI_F * (1.0f + z * z)) / h;
                    } else {
                        k3 = hw_pi / (hw2 + CUT2);
                    }
                } else {
                    const float sd = s_sdep[q];
                    k1 = sdvoigt(d1, h, a, sd);
                    if (need_k2) k2 = sdvoigt(dsum, h, a, sd);
                    k3 = s_k3v[q];
                }

                const float yav = s_ya[q], ybv = s_yb[q];
                const float y1 = 1.0f + yav * d1 + ybv;
                float sls;
                if (is_o2) {
                    if (cpl) {
                        const float y2 = 1.0f - yav * dsum + ybv;
                        sls = (fl & FL_XF1) ? k1 * y1 + k2 * y2 : k1 + k2;
                    } else {
                        sls = within ? k1 + (mirror ? k2 : 0.0f) : 0.0f;
                    }
                } else if (fl & FL_CO2) {
                    const float ped = 2.0f - (d1 * d1) / CUT2;
                    const float xp4 = k3 * ped;
                    sls = (cpl && (fl & FL_XF15))
                              ? k1 * y1 - xp4 - k3 * ((y1 - 1.0f) * ped)
                              : k1 - xp4;
                } else if (cpl) {
                    const float y2 = 1.0f - yav * dsum + ybv;
                    const float y1p = 1.0f + yav * CUT + ybv;
                    const float y2p = 1.0f - yav * CUT + ybv;
                    sls = y1 * k1 - y1p * k3
                          + (mirror ? y2 * k2 - y2p * k3 : 0.0f);
                } else {
                    sls = k1 - k3 + (mirror ? k2 - k3 : 0.0f);
                }
                my_acc[m] += sls * s_stild[q];
            }
        }
    }
    __syncthreads();
    // the tile's [wt, n_mol] block of out [L, wp, n_mol] is contiguous:
    // write it with consecutive threads on consecutive addresses
    float* o = out + (static_cast<size_t>(l) * wp
                      + static_cast<size_t>(i) * wt) * n_mol;
    for (int e = w; e < wt * n_mol; e += wt)
        o[e] = acc[(e / n_mol) * acc_stride + e % n_mol];
}

template <bool VOIGT>
int launch(const int* cmap, const int* cvalid, int n_wt, int n_cand,
           const float* wn_hi, const float* wn_lo, const float* nu_hi,
           const float* nu_lo, const float* sdep, const int* flags,
           const int* mol, const float* shift, const float* stild,
           const float* hw, const float* ad, const float* k3v,
           const float* ya, const float* yb, int n_layers, int n_lines,
           int nt, int wt, int n_mol, float* out, cudaStream_t stream) {
    const int acc_stride = n_mol | 1;    // odd: no shared-bank conflicts
    const size_t smem = (static_cast<size_t>(wt) * acc_stride
                         + static_cast<size_t>(N_STAGED) * CHUNK)
                        * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        linesum_kernel<VOIGT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(n_wt, n_layers);
    linesum_kernel<VOIGT><<<grid, wt, smem, stream>>>(
        cmap, cvalid, n_cand, wn_hi, wn_lo, nu_hi, nu_lo, sdep, flags, mol,
        shift, stild, hw, ad, k3v, ya, yb, n_lines, nt, n_lines / nt,
        n_mol, acc_stride, n_wt * wt, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous arrays: cmap/cvalid int32 [n_wt, n_cand]; wn_hi/wn_lo f32
// [n_wt*wt]; nu_hi/nu_lo/sdep f32 and flags/mol int32 [n_lines];
// shift..yb f32 [n_layers, n_lines]; out f32 [n_layers, n_wt*wt, n_mol].
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int monortm_linesum_forward(
    int voigt, const int* cmap, const int* cvalid, int n_wt, int n_cand,
    const float* wn_hi, const float* wn_lo, const float* nu_hi,
    const float* nu_lo, const float* sdep, const int* flags, const int* mol,
    const float* shift, const float* stild, const float* hw,
    const float* ad, const float* k3v, const float* ya, const float* yb,
    int n_layers, int n_lines, int nt, int wt, int n_mol, float* out,
    void* stream) {
    if (n_wt == 0 || n_layers == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (voigt)
        return launch<true>(cmap, cvalid, n_wt, n_cand, wn_hi, wn_lo, nu_hi,
                            nu_lo, sdep, flags, mol, shift, stild, hw, ad,
                            k3v, ya, yb, n_layers, n_lines, nt, wt, n_mol,
                            out, s);
    return launch<false>(cmap, cvalid, n_wt, n_cand, wn_hi, wn_lo, nu_hi,
                         nu_lo, sdep, flags, mol, shift, stild, hw, ad, k3v,
                         ya, yb, n_layers, n_lines, nt, wt, n_mol, out, s);
}
