// Adjoint of the block-sparse line sum for NVIDIA Hopper (sm_90a).
//
// Replaces monortm_tpu/ops/linesum_pallas.py::_bwd_kernel (the Pallas TPU
// adjoint of the forward line sum, launched by line_od_pallas.bwd_call)
// and, instantiated with VOIGT=false, the autodiff of the JAX package's
// all-Lorentz engine (linesum_lorentz.py::line_od_lorentz_xla).  For a
// cotangent g [L, Wp, n_mol] of sf it computes the cotangents of the seven
// per-(layer, line) operands
//
//   d_x[l, n] = sum over wn tiles i listing n's tile as a candidate,
//               sum over wavenumbers w of tile i,
//               g[l, w, mol[n]] * d(keep * SLS * stild)(l, w, n) / d x[l, n]
//
// for x in (shift, stild, hw, ad, k3v, ya, yb): the transpose of the
// forward's one-hot attribution is a gather of g at the line's molecule,
// and the derivative is that of the branch each lane took in the forward
// (Lorentz or SD-Voigt, one Humlicek region), which is what the vjp of
// the Pallas kernel's selects gives.  With VOIGT=false, ad and k3v enter
// nothing and get no cotangent.
//
// What bounds it: FP32 arithmetic, as the forward.  An evaluation carries
// the value and three partial derivatives of each shape function (the
// Dual instantiation of linesum_math.cuh) plus the hand-written adjoint
// of the branch trees; an SD-Voigt lane also evaluates its shape in
// double for the partials (sd_shape), about 4x the forward's arithmetic
// on that lane and the most of the VOIGT=true kernel's registers.  It
// reads nothing from device memory but the cotangent tile staged in
// shared memory.  The design:
//   - work split: one block per (catalog line tile k, flat layer l), one
//     thread per line of the tile.  The block walks row k of the reverse
//     candidate map (the wn tiles whose candidate lists hold tile k, in
//     ascending order) and stages each tile's g[l, tile, :] and its
//     wavenumbers in shared memory; every thread then runs over the
//     tile's wavenumbers with its line's operands and seven sums in
//     registers, and writes each sum once;
//   - no atomics and no split over wavenumbers, so the summation order is
//     fixed and results are reproducible run to run;
//   - per-lane branches as in the forward: a line outside the window costs
//     a compare, k2 is evaluated only where the mirror term or coupled O2
//     needs it, and an invalid line (or one of no molecule) skips the
//     whole sweep.
// Built like linesum.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -fmad=false -shared) and called through ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

#include "linesum_math.cuh"

namespace {

using namespace linesum;

template <bool VOIGT>
__global__ void linesum_bwd_kernel(
    const int* __restrict__ rmap, const int* __restrict__ rvalid,
    int n_rev, int n_wt,
    const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
    const float* __restrict__ nu_hi, const float* __restrict__ nu_lo,
    const float* __restrict__ sdep, const int* __restrict__ flags,
    const int* __restrict__ mol,
    const float* __restrict__ shift, const float* __restrict__ stild,
    const float* __restrict__ hw, const float* __restrict__ ad,
    const float* __restrict__ k3v, const float* __restrict__ ya,
    const float* __restrict__ yb, const float* __restrict__ g,
    int n_lines, int wt, int n_mol, int wp,
    float* __restrict__ d_shift, float* __restrict__ d_stild,
    float* __restrict__ d_hw, float* __restrict__ d_ad,
    float* __restrict__ d_k3v, float* __restrict__ d_ya,
    float* __restrict__ d_yb) {
    extern __shared__ float smem[];
    float* g_s = smem;                      // [wt][n_mol]
    float* s_whi = g_s + wt * n_mol;        // [wt]
    float* s_wlo = s_whi + wt;              // [wt]

    const int nt = blockDim.x;
    const int k = blockIdx.x;               // catalog line tile
    const int l = blockIdx.y;               // flat layer
    const int q = threadIdx.x;              // line within the tile
    const size_t n = static_cast<size_t>(k) * nt + q;
    const size_t ln_idx = static_cast<size_t>(l) * n_lines + n;
    const int fl = flags[n];
    const int m = mol[n];
    const bool active = (fl & FL_VALID) && m >= 0 && m < n_mol;
    const Line ln{nu_hi[n], nu_lo[n], sdep[n], shift[ln_idx], stild[ln_idx],
                  hw[ln_idx], VOIGT ? ad[ln_idx] : 0.0f,
                  VOIGT ? k3v[ln_idx] : 0.0f, ya[ln_idx], yb[ln_idx], fl};
    float acc[N_COT];
#pragma unroll
    for (int c = 0; c < N_COT; ++c) acc[c] = 0.0f;

    for (int s = 0; s < n_rev; ++s) {
        if (!rvalid[k * n_rev + s]) continue;       // block-uniform
        const int i = rmap[k * n_rev + s];
        if (i < 0 || i >= n_wt) continue;
        __syncthreads();                 // the previous tile is consumed
        // g's [wt, n_mol] block of tile i is contiguous in [L, wp, n_mol]
        const float* gt = g + (static_cast<size_t>(l) * wp
                               + static_cast<size_t>(i) * wt) * n_mol;
        for (int e = q; e < wt * n_mol; e += nt) g_s[e] = gt[e];
        for (int e = q; e < wt; e += nt) {
            s_whi[e] = wn_hi[i * wt + e];
            s_wlo[e] = wn_lo[i * wt + e];
        }
        __syncthreads();
        if (!active) continue;
        for (int w = 0; w < wt; ++w) {
            Pair pr;
            if (!pair_of(s_whi[w], s_wlo[w], ln, pr)) continue;
            pair_adjoint<VOIGT>(pr, ln, g_s[w * n_mol + m], acc);
        }
    }
    d_shift[ln_idx] = acc[D_SHIFT];
    d_stild[ln_idx] = acc[D_STILD];
    d_hw[ln_idx] = acc[D_HW];
    if (VOIGT) {
        d_ad[ln_idx] = acc[D_AD];
        d_k3v[ln_idx] = acc[D_K3V];
    }
    d_ya[ln_idx] = acc[D_YA];
    d_yb[ln_idx] = acc[D_YB];
}

template <bool VOIGT>
int launch(const int* rmap, const int* rvalid, int k_tiles, int n_rev,
           int n_wt, const float* wn_hi, const float* wn_lo,
           const float* nu_hi, const float* nu_lo, const float* sdep,
           const int* flags, const int* mol, const float* shift,
           const float* stild, const float* hw, const float* ad,
           const float* k3v, const float* ya, const float* yb,
           const float* g, int n_layers, int n_lines, int nt, int wt,
           int n_mol, float* d_shift, float* d_stild, float* d_hw,
           float* d_ad, float* d_k3v, float* d_ya, float* d_yb,
           cudaStream_t stream) {
    const size_t smem = (static_cast<size_t>(wt) * n_mol + 2 * wt)
                        * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        linesum_bwd_kernel<VOIGT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(k_tiles, n_layers);
    linesum_bwd_kernel<VOIGT><<<grid, nt, smem, stream>>>(
        rmap, rvalid, n_rev, n_wt, wn_hi, wn_lo, nu_hi, nu_lo, sdep, flags,
        mol, shift, stild, hw, ad, k3v, ya, yb, g, n_lines, wt, n_mol,
        n_wt * wt, d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya, d_yb);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous arrays: rmap/rvalid int32 [k_tiles, n_rev]; wn_hi/wn_lo f32
// [n_wt*wt]; nu_hi/nu_lo/sdep f32 and flags/mol int32 [n_lines];
// shift..yb f32 [n_layers, n_lines]; g f32 [n_layers, n_wt*wt, n_mol];
// d_* f32 [n_layers, n_lines] (d_ad, d_k3v, ad and k3v are not read or
// written, and may be null, when voigt == 0).  n_lines = k_tiles * nt.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int monortm_linesum_backward(
    int voigt, const int* rmap, const int* rvalid, int k_tiles, int n_rev,
    int n_wt, const float* wn_hi, const float* wn_lo, const float* nu_hi,
    const float* nu_lo, const float* sdep, const int* flags, const int* mol,
    const float* shift, const float* stild, const float* hw,
    const float* ad, const float* k3v, const float* ya, const float* yb,
    const float* g, int n_layers, int n_lines, int nt, int wt, int n_mol,
    float* d_shift, float* d_stild, float* d_hw, float* d_ad, float* d_k3v,
    float* d_ya, float* d_yb, void* stream) {
    if (k_tiles == 0 || n_layers == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (voigt)
        return launch<true>(rmap, rvalid, k_tiles, n_rev, n_wt, wn_hi, wn_lo,
                            nu_hi, nu_lo, sdep, flags, mol, shift, stild, hw,
                            ad, k3v, ya, yb, g, n_layers, n_lines, nt, wt,
                            n_mol, d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya,
                            d_yb, s);
    return launch<false>(rmap, rvalid, k_tiles, n_rev, n_wt, wn_hi, wn_lo,
                         nu_hi, nu_lo, sdep, flags, mol, shift, stild, hw, ad,
                         k3v, ya, yb, g, n_layers, n_lines, nt, wt, n_mol,
                         d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya, d_yb, s);
}
