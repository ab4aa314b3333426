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
// What bounds it: FP32 arithmetic and its latency, not memory.  A block
// reads 11 KB of cotangent per wavenumber tile (about 90 KB over its
// sweep, out of the L2) and evaluates 128 wavenumbers per line on it, one
// IEEE divide each.  Bulk copies (TMA, cp.async) and tensor cores have
// nothing to do here.  The design spends its effort on arithmetic per
// pair and on resident warps:
//   - work split: linesum_bwd_sweep runs one block per (part of a catalog
//     line tile k, flat layer l), one thread per line.  The block walks
//     row k of the reverse candidate map (the wn tiles whose candidate
//     lists hold tile k, in ascending order) and stages each tile's
//     g[l, tile, :] and its wavenumbers in shared memory; every thread
//     then runs over the tile's wavenumbers with its line's operands and
//     its sums in registers, and writes each sum once.  The block is
//     128 lines wide where the plan's line tile nt is a multiple of that
//     (else 32), so the grid is fine enough to fill the card;
//   - hoisted: everything of a pair that depends on the (layer, line)
//     alone (linesum_math.cuh, LinePre) is computed once per thread,
//     before the sweep;
//   - Lorentz lanes, nearly every pair, take their value as the forward
//     does and their partials in closed form from it: one divide per
//     shape and no dual numbers;
//   - the loop over a tile's wavenumbers is compiled once per class of
//     the branch trees (a line's flags decide its class), so that only
//     what varies with the wavenumber branches inside it; a thread enters
//     the loop of its line's class, and a warp whose lines are of several
//     classes runs their loops in turn;
//   - SD-Voigt lanes (VOIGT=true) are left out of the sweep, whose
//     registers would otherwise be those of the double-precision
//     Humlicek partials.  A thread that meets one records the first and
//     last slot of the reverse map that hold such lanes in its word of
//     `defer` (defer_mark; a line's SD-Voigt lanes lie within 100 aD of
//     its centre, in consecutive slots); a second kernel,
//     linesum_bwd_deferred, launched behind the sweep on the same
//     stream, one thread per (layer, line), returns at once where the
//     word is 0 and otherwise revisits those slots alone, evaluates the
//     SD-Voigt lanes alone and adds their sums to its own d_x[l, n];
//   - no atomics and no split over wavenumbers: each d_x[l, n] has one
//     owner thread in either kernel.  Each slot's pairs are summed in
//     wavenumber order from zero and that partial is added to the
//     thread's total, slot by slot (sweep_slot, deferred_row), the order
//     of the Pallas kernel and the plain adjoint, which add one block's
//     vjp at a time; the Lorentz pairs first, then the SD-Voigt pairs.
//     Results are the same run to run;
//   - per-lane branches as in the forward: a line outside the window costs
//     a compare, k2 is evaluated only where the mirror term or coupled O2
//     needs it, and an invalid line (or one of no molecule) skips the
//     whole sweep.
// Built like linesum.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -fmad=false -shared) and called through ctypes.  Without contraction
// the values round as the forward's do; the partials and their sums use
// explicit fused multiply-adds (linesum_math.cuh, mad).

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

#include "linesum_math.cuh"

namespace {

using namespace linesum;

constexpr int SWEEP_THREADS = 128;      // lines (threads) per sweep block
// Resident blocks per SM the sweep is compiled for.  The sweep fits more
// (6 at its 78 registers), but without this bound ptxas trades registers
// for occupancy (71 and 64 registers, 7 and 8 blocks) and the kernels
// run 2-3% slower.
constexpr int SWEEP_MIN_BLOCKS = 4;
constexpr int DEFERRED_THREADS = 128;

// kernels started by the entry point so far, by instantiation [voigt]
std::atomic<int> kernels_started[2];

// The operands of line n in layer l.
template <bool VOIGT>
__device__ __forceinline__ Line load_line(
    size_t n, size_t ln_idx, int fl, const float* __restrict__ nu_hi,
    const float* __restrict__ nu_lo, const float* __restrict__ sdep,
    const float* __restrict__ shift, const float* __restrict__ stild,
    const float* __restrict__ hw, const float* __restrict__ ad,
    const float* __restrict__ k3v, const float* __restrict__ ya,
    const float* __restrict__ yb) {
    return Line{nu_hi[n], nu_lo[n], sdep[n], shift[ln_idx], stild[ln_idx],
                hw[ln_idx], VOIGT ? ad[ln_idx] : 0.0f,
                VOIGT ? k3v[ln_idx] : 0.0f, ya[ln_idx], yb[ln_idx], fl};
}

template <bool VOIGT>
__global__ void __launch_bounds__(SWEEP_THREADS, SWEEP_MIN_BLOCKS)
linesum_bwd_sweep(
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
    int n_lines, int nt, int wt, int n_mol, int wp,
    float* __restrict__ d_shift, float* __restrict__ d_stild,
    float* __restrict__ d_hw, float* __restrict__ d_ad,
    float* __restrict__ d_k3v, float* __restrict__ d_ya,
    float* __restrict__ d_yb, unsigned* __restrict__ defer) {
    extern __shared__ float smem[];
    float* g_s = smem;                      // [wt][n_mol]
    float* s_whi = g_s + wt * n_mol;        // [wt]
    float* s_wlo = s_whi + wt;              // [wt]

    const int bt = blockDim.x;
    const int q = threadIdx.x;
    // blockIdx.x counts blocks of bt lines; nt is a multiple of bt
    const size_t n = static_cast<size_t>(blockIdx.x) * bt + q;
    const int k = static_cast<int>(n / nt);     // catalog line tile
    const int l = blockIdx.y;                   // flat layer
    const size_t ln_idx = static_cast<size_t>(l) * n_lines + n;
    const int fl = flags[n];
    const int m = mol[n];
    const bool active = (fl & FL_VALID) && m >= 0 && m < n_mol;
    const Line ln = load_line<VOIGT>(n, ln_idx, fl, nu_hi, nu_lo, sdep, shift,
                                     stild, hw, ad, k3v, ya, yb);
    const LinePre pre = line_pre<VOIGT>(ln);
    float acc[N_COT];
#pragma unroll
    for (int c = 0; c < N_COT; ++c) acc[c] = 0.0f;
    unsigned marked = 0;

    for (int s = 0; s < n_rev; ++s) {
        if (!rvalid[k * n_rev + s]) continue;       // block-uniform
        const int i = rmap[k * n_rev + s];
        if (i < 0 || i >= n_wt) continue;
        __syncthreads();                 // the previous tile is consumed
        // g's [wt, n_mol] block of tile i is contiguous in [L, wp, n_mol]
        const float* gt = g + (static_cast<size_t>(l) * wp
                               + static_cast<size_t>(i) * wt) * n_mol;
        for (int e = q; e < wt * n_mol; e += bt) g_s[e] = gt[e];
        for (int e = q; e < wt; e += bt) {
            s_whi[e] = wn_hi[i * wt + e];
            s_wlo[e] = wn_lo[i * wt + e];
        }
        __syncthreads();
        if (!active) continue;
        sweep_slot<VOIGT>(s, s_whi, s_wlo, g_s + m, n_mol, wt, ln, pre, acc,
                          marked);
    }
    d_shift[ln_idx] = acc[D_SHIFT];
    d_stild[ln_idx] = acc[D_STILD];
    d_hw[ln_idx] = acc[D_HW];
    if (VOIGT) {
        d_ad[ln_idx] = 0.0f;             // SD-Voigt lanes alone reach these
        d_k3v[ln_idx] = 0.0f;
        defer[ln_idx] = marked;
    }
    d_ya[ln_idx] = acc[D_YA];
    d_yb[ln_idx] = acc[D_YB];
}

// The SD-Voigt lanes the sweep left out: one thread per (layer, line),
// reading the cotangent and the wavenumbers from device memory.
__global__ void __launch_bounds__(DEFERRED_THREADS) linesum_bwd_deferred(
    const unsigned* __restrict__ defer,
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
    int n_lines, int nt, int wt, int n_mol, int wp,
    float* __restrict__ d_shift, float* __restrict__ d_stild,
    float* __restrict__ d_hw, float* __restrict__ d_ad,
    float* __restrict__ d_k3v, float* __restrict__ d_ya,
    float* __restrict__ d_yb) {
    const size_t n = static_cast<size_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
    if (n >= static_cast<size_t>(n_lines)) return;
    const int l = blockIdx.y;
    const size_t ln_idx = static_cast<size_t>(l) * n_lines + n;
    const unsigned marked = defer[ln_idx];
    if (!marked) return;                 // nearly every thread
    const int k = static_cast<int>(n / nt);
    const int m = mol[n];                // in range: the sweep marked it
    const Line ln = load_line<true>(n, ln_idx, flags[n], nu_hi, nu_lo, sdep,
                                    shift, stild, hw, ad, k3v, ya, yb);
    const LinePre pre = line_pre<true>(ln);
    float acc[N_COT];
#pragma unroll
    for (int c = 0; c < N_COT; ++c) acc[c] = 0.0f;
    const auto tile = [&](int s, const float*& whi, const float*& wlo,
                          const float*& gt) {
        if (s >= n_rev || !rvalid[k * n_rev + s]) return false;
        const int i = rmap[k * n_rev + s];
        if (i < 0 || i >= n_wt) return false;
        whi = wn_hi + i * wt;
        wlo = wn_lo + i * wt;
        gt = g + (static_cast<size_t>(l) * wp
                  + static_cast<size_t>(i) * wt) * n_mol + m;
        return true;
    };
    deferred_row(marked, tile, n_mol, wt, ln, pre, acc);
    d_shift[ln_idx] += acc[D_SHIFT];
    d_stild[ln_idx] += acc[D_STILD];
    d_hw[ln_idx] += acc[D_HW];
    d_ad[ln_idx] += acc[D_AD];
    d_k3v[ln_idx] += acc[D_K3V];
    d_ya[ln_idx] += acc[D_YA];
    d_yb[ln_idx] += acc[D_YB];
}

// threads per block of the sweep; a block lies in one line tile (nt is a
// multiple of 32)
int sweep_threads(int nt) { return nt % SWEEP_THREADS ? 32 : SWEEP_THREADS; }

size_t sweep_smem(int wt, int n_mol) {
    return (static_cast<size_t>(wt) * n_mol + 2 * wt) * sizeof(float);
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
           unsigned* defer, cudaStream_t stream) {
    const size_t smem = sweep_smem(wt, n_mol);
    cudaError_t err = cudaFuncSetAttribute(
        linesum_bwd_sweep<VOIGT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int bt = sweep_threads(nt);
    dim3 grid(k_tiles * (nt / bt), n_layers);
    linesum_bwd_sweep<VOIGT><<<grid, bt, smem, stream>>>(
        rmap, rvalid, n_rev, n_wt, wn_hi, wn_lo, nu_hi, nu_lo, sdep, flags,
        mol, shift, stild, hw, ad, k3v, ya, yb, g, n_lines, nt, wt, n_mol,
        n_wt * wt, d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya, d_yb, defer);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++kernels_started[VOIGT];
    if (!VOIGT || err != cudaSuccess) return static_cast<int>(err);
    dim3 grid2((n_lines + DEFERRED_THREADS - 1) / DEFERRED_THREADS, n_layers);
    linesum_bwd_deferred<<<grid2, DEFERRED_THREADS, 0, stream>>>(
        defer, rmap, rvalid, n_rev, n_wt, wn_hi, wn_lo, nu_hi, nu_lo, sdep,
        flags, mol, shift, stild, hw, ad, k3v, ya, yb, g, n_lines, nt, wt,
        n_mol, n_wt * wt, d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya, d_yb);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++kernels_started[VOIGT];
    return static_cast<int>(err);
}

template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int* regs, int* blocks) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, threads, smem));
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device pointers of
// contiguous arrays: rmap/rvalid int32 [k_tiles, n_rev]; wn_hi/wn_lo f32
// [n_wt*wt]; nu_hi/nu_lo/sdep f32 and flags/mol int32 [n_lines];
// shift..yb f32 [n_layers, n_lines]; g f32 [n_layers, n_wt*wt, n_mol];
// d_* f32 [n_layers, n_lines]; defer int32 [n_layers, n_lines], scratch
// that the call overwrites with each (layer, line)'s deferral word
// (defer_mark; n_rev < 65535) (d_ad, d_k3v, ad, k3v and defer are not read or
// written, and may be null, when voigt == 0).  n_lines = k_tiles * nt.
// Launches on `stream` (two kernels when voigt != 0), does not
// synchronise, returns cudaGetLastError().
extern "C" int monortm_linesum_backward(
    int voigt, const int* rmap, const int* rvalid, int k_tiles, int n_rev,
    int n_wt, const float* wn_hi, const float* wn_lo, const float* nu_hi,
    const float* nu_lo, const float* sdep, const int* flags, const int* mol,
    const float* shift, const float* stild, const float* hw,
    const float* ad, const float* k3v, const float* ya, const float* yb,
    const float* g, int n_layers, int n_lines, int nt, int wt, int n_mol,
    float* d_shift, float* d_stild, float* d_hw, float* d_ad, float* d_k3v,
    float* d_ya, float* d_yb, unsigned* defer, void* stream) {
    if (k_tiles == 0 || n_layers == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (voigt)
        return launch<true>(rmap, rvalid, k_tiles, n_rev, n_wt, wn_hi, wn_lo,
                            nu_hi, nu_lo, sdep, flags, mol, shift, stild, hw,
                            ad, k3v, ya, yb, g, n_layers, n_lines, nt, wt,
                            n_mol, d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya,
                            d_yb, defer, s);
    return launch<false>(rmap, rvalid, k_tiles, n_rev, n_wt, wn_hi, wn_lo,
                         nu_hi, nu_lo, sdep, flags, mol, shift, stild, hw, ad,
                         k3v, ya, yb, g, n_layers, n_lines, nt, wt, n_mol,
                         d_shift, d_stild, d_hw, d_ad, d_k3v, d_ya, d_yb,
                         defer, s);
}

// How the kernels of one instantiation are built and how many blocks of
// each an SM holds at these tile sizes.  Fills the host array out[6]:
// threads per block of the sweep, its registers per thread, its resident
// blocks per SM, its dynamic shared memory in bytes, then the registers
// and resident blocks per SM of the deferred kernel (0, 0 when
// voigt == 0).  Returns a CUDA error code.
extern "C" int monortm_linesum_backward_info(int voigt, int nt, int wt,
                                             int n_mol, int* out) {
    const int bt = sweep_threads(nt);
    const size_t smem = sweep_smem(wt, n_mol);
    out[0] = bt;
    out[3] = static_cast<int>(smem);
    out[4] = out[5] = 0;
    if (!voigt)
        return kernel_info(linesum_bwd_sweep<false>, bt, smem, &out[1],
                           &out[2]);
    int rc = kernel_info(linesum_bwd_sweep<true>, bt, smem, &out[1], &out[2]);
    if (rc) return rc;
    return kernel_info(linesum_bwd_deferred, DEFERRED_THREADS, 0, &out[4],
                       &out[5]);
}

// The kernels that monortm_linesum_backward has started in this process
// for one instantiation (every successful <<<>>> counts one).
extern "C" int monortm_linesum_backward_kernels_started(int voigt) {
    return kernels_started[voigt ? 1 : 0];
}
