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
// The line shapes and the per-(wavenumber, line) evaluation live in
// linesum_math.cuh, shared with the adjoint kernel (linesum_bwd.cu).
// Built by monortm_tpu_torch/ops/linesum_kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <stddef.h>

#include "linesum_math.cuh"

namespace {

using namespace linesum;

constexpr int CHUNK = 256;   // lines staged in shared memory at a time
constexpr int N_STAGED = 12; // staged arrays: 3 per line, 7 per (layer,
                             // line), flags, molecule

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
                const Line ln{s_nu_hi[q], s_nu_lo[q], s_sdep[q],
                              s_shift[q], s_stild[q], s_hw[q], s_ad[q],
                              s_k3v[q], s_ya[q], s_yb[q], fl};
                Pair pr;
                if (!pair_of(whi, wlo, ln, pr)) continue;  // 25 cm^-1 window
                float k1, k2, k3;
                shapes<VOIGT>(pr, ln, k1, k2, k3);
                const float sls = branch_trees(pr, ln, k1, k2, k3);
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
