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
// What bounds it: instruction issue, not memory.  Each (layer,
// wavenumber, line) evaluation reads nothing from device memory (a chunk
// of a tile's lines is staged once in shared memory for the whole block)
// and costs one IEEE divide on a Lorentz lane (two for coupled O2 and the
// mirror term), or the rationals, exp and sincos of the Humlicek regions
// on the rare SD-Voigt lane.  So the design spends its effort on issuing
// fewer instructions per evaluation:
//   - hoisted per staged line: the thread that stages a line also forms
//     what depends on the (layer, line) alone (linesum_math.cuh, FwdLine:
//     hw/pi, hw^2, the pedestal, xnu, the Y factors' products, 100 aD,
//     the zeta switch), once per block instead of once per wavenumber;
//   - packed: staging drops the lines that add nothing to any of the
//     block's wavenumbers (invalid, of no molecule, or outside every
//     window by a safe margin; fwd_key) and packs the rest, in order, so
//     the walk never visits them;
//   - one loop per class of the branch trees (for_class), over runs of
//     consecutive lines of one class and molecule: the flag tests fold
//     away and the shapes a class does not read are never formed (CO2 no
//     k2; the window test comes before any shape);
//   - each run of lines of one molecule is summed in a register and
//     added to its row in device memory where the molecule changes and
//     at the end of each staged chunk: a sum of per-chunk partial sums,
//     whose rounding grows with the chunks, not the lines (fwd_chunk);
//   - NW wavenumbers per thread share each staged line's shared loads and
//     the loop's control;
//   - the SD-Voigt lane is a call (sd_lane_sls, not inlined), so that its
//     registers are not the walk's.
// Division, sqrt, exp, expm1, sin and cos stay IEEE (no fast math), and
// multiply-adds are not contracted (-fmad=false): the kernel rounds like
// the plain PyTorch version beside it, and every sum is bitwise the one
// the unhoisted evaluation gives, summed in the same runs
// (tests/test_torch_fwd_math.py).
//
// Work split: one block per (sub-tile of THREADS * NW wavenumbers of a
// plan tile, layer); thread t owns wavenumbers t, t + THREADS, ... of the
// sub-tile.  The block walks its tile's candidate-map row in order
// (replacing the TPU's scalar prefetch) and stages each candidate tile's
// lines in chunks.  The sums of a wavenumber live in its row of `out`,
// which only its thread reads and writes: no atomics and no split over
// lines, so the summation order is fixed (each (wavenumber, molecule) sum
// takes its lines in catalog order, in runs within a chunk) and results
// are reproducible.
//
// The line shapes and the per-(wavenumber, line) evaluation live in
// linesum_math.cuh, shared with the adjoint kernel (linesum_bwd.cu).
// Built by monortm_tpu_torch/ops/linesum_kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// and called through ctypes (plain C entry point below).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "linesum_math.cuh"

namespace {

using namespace linesum;

constexpr int CHUNK = 128;   // lines staged in shared memory at a time

// Threads per block and wavenumbers per thread, by instantiation.
template <bool VOIGT> struct Shape {
    static constexpr int THREADS = VOIGT ? 128 : 64;
    static constexpr int NW = VOIGT ? 1 : 2;
};

// ---- the line sum --------------------------------------------------------

template <bool VOIGT>
__global__ void __launch_bounds__(Shape<VOIGT>::THREADS) linesum_kernel(
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
    int n_lines, int nt, int n_tiles, int n_mol, int wt, int n_sub, int wp,
    float* __restrict__ out) {
    constexpr int S = Shape<VOIGT>::THREADS, NW = Shape<VOIGT>::NW;
    __shared__ FwdLine s_line[CHUNK + 1];      // + the walk's sentinel
    __shared__ FwdSd s_sd[VOIGT ? CHUNK : 1];
    __shared__ int s_raw[CHUNK], s_cnt[CHUNK / 32];
    __shared__ float s_lo[S / 32], s_hi[S / 32];

    const int i = blockIdx.x / n_sub;                 // wavenumber tile
    const int w0 = (blockIdx.x % n_sub) * (S * NW);   // its sub-tile
    const int l = blockIdx.y;                         // flat layer
    const int t = threadIdx.x, lane = t & 31;

    // this thread's wavenumbers; a lane past the tile's end takes the
    // last one's value and writes nothing
    float whi[NW], wlo[NW];
    float* rows[NW];
    float lo = INFINITY, hi = -INFINITY;
#pragma unroll
    for (int r = 0; r < NW; ++r) {
        const int w = w0 + t + r * S;
        const int wc = min(w, wt - 1);
        whi[r] = wn_hi[i * wt + wc];
        wlo[r] = wn_lo[i * wt + wc];
        lo = fminf(lo, whi[r]);
        hi = fmaxf(hi, whi[r]);
        rows[r] = w < wt ? out + (static_cast<size_t>(l) * wp
                                  + static_cast<size_t>(i) * wt + w) * n_mol
                         : nullptr;
        if (rows[r])
            for (int m = 0; m < n_mol; ++m) rows[r][m] = 0.0f;
    }
    // the block's range of wavenumbers, for fwd_key
    for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(~0u, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(~0u, hi, o));
    }
    if (lane == 0) {
        s_lo[t >> 5] = lo;
        s_hi[t >> 5] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < S / 32; ++v) {
        lo = fminf(lo, s_lo[v]);
        hi = fmaxf(hi, s_hi[v]);
    }

    const size_t row = static_cast<size_t>(l) * n_lines;
    for (int j = 0; j < n_cand; ++j) {
        if (!cvalid[i * n_cand + j]) continue;
        const int k = cmap[i * n_cand + j];
        if (k < 0 || k >= n_tiles) continue;
        for (int c0 = 0; c0 < nt; c0 += CHUNK) {
            const int nc = min(CHUNK, nt - c0);
            const int nq = (nc + 31) & ~31;   // whole warps: ballots below
            const size_t n0 = static_cast<size_t>(k) * nt + c0;
            __syncthreads();             // the previous chunk is consumed
            // each line's key, and the lines kept in each 32-line slice
            for (int q = t; q < nq; q += S) {
                int key = -1;
                if (q < nc) {
                    const size_t n = n0 + q;
                    const float sh = shift[row + n];
                    key = fwd_key(flags[n], mol[n], n_mol,
                                  nu_hi[n] + (nu_lo[n] + sh), sh, lo, hi);
                }
                s_raw[q] = key;
                const unsigned b = __ballot_sync(~0u, key >= 0);
                if (lane == 0) s_cnt[q >> 5] = __popc(b);
            }
            __syncthreads();
            // stage the kept lines, hoisted, in order, packed at the front
            for (int q = t; q < nq; q += S) {
                const int key = s_raw[q];
                const unsigned b = __ballot_sync(~0u, key >= 0);
                if (key < 0) continue;
                int pos = __popc(b & ((1u << lane) - 1u));
                for (int v = 0; v < (q >> 5); ++v) pos += s_cnt[v];
                const size_t n = n0 + q;
                const size_t ln_idx = row + n;
                const Line ln{nu_hi[n], nu_lo[n], VOIGT ? sdep[n] : 0.0f,
                              shift[ln_idx], stild[ln_idx], hw[ln_idx],
                              VOIGT ? ad[ln_idx] : 0.0f,
                              VOIGT ? k3v[ln_idx] : 0.0f, ya[ln_idx],
                              yb[ln_idx], flags[n]};
                FwdLine f = fwd_line<VOIGT>(ln);
                f.key = key;
                s_line[pos] = f;
                if (VOIGT) s_sd[pos] = fwd_sd(ln);
            }
            int n_kept = 0;
            for (int v = 0; v < nq / 32; ++v) n_kept += s_cnt[v];
            if (t == 0) s_line[n_kept].key = -1;
            __syncthreads();
            fwd_chunk<VOIGT, NW>(s_line, s_sd, n_kept, whi, wlo, rows);
        }
    }
}

// blocks per plan tile of wt wavenumbers
template <bool VOIGT> int n_sub(int wt) {
    constexpr int sw = Shape<VOIGT>::THREADS * Shape<VOIGT>::NW;
    return (wt + sw - 1) / sw;
}

template <bool VOIGT>
int launch(const int* cmap, const int* cvalid, int n_wt, int n_cand,
           const float* wn_hi, const float* wn_lo, const float* nu_hi,
           const float* nu_lo, const float* sdep, const int* flags,
           const int* mol, const float* shift, const float* stild,
           const float* hw, const float* ad, const float* k3v,
           const float* ya, const float* yb, int n_layers, int n_lines,
           int nt, int wt, int n_mol, float* out, cudaStream_t stream) {
    const int ns = n_sub<VOIGT>(wt);
    dim3 grid(n_wt * ns, n_layers);
    linesum_kernel<VOIGT><<<grid, Shape<VOIGT>::THREADS, 0, stream>>>(
        cmap, cvalid, n_cand, wn_hi, wn_lo, nu_hi, nu_lo, sdep, flags, mol,
        shift, stild, hw, ad, k3v, ya, yb, n_lines, nt, n_lines / nt,
        n_mol, wt, ns, n_wt * wt, out);
    return static_cast<int>(cudaGetLastError());
}

template <bool VOIGT> int kernel_info(int wt, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, linesum_kernel<VOIGT>);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = Shape<VOIGT>::THREADS;
    out[1] = attr.numRegs;
    out[3] = static_cast<int>(attr.sharedSizeBytes);
    out[4] = Shape<VOIGT>::NW;
    out[5] = n_sub<VOIGT>(wt);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], linesum_kernel<VOIGT>, Shape<VOIGT>::THREADS, 0));
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

// How the kernel of one instantiation is built and how many of its blocks
// an SM holds.  Fills the host array out[6]: threads per block, registers
// per thread, resident blocks per SM, static shared memory in bytes,
// wavenumbers per thread, blocks per plan tile of wt wavenumbers.  nt and
// n_mol do not change them.  Returns a CUDA error code.
extern "C" int monortm_linesum_forward_info(int voigt, int nt, int wt,
                                            int n_mol, int* out) {
    (void)nt;
    (void)n_mol;
    return voigt ? kernel_info<true>(wt, out) : kernel_info<false>(wt, out);
}
