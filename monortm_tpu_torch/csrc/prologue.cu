// The LINES prologue of the line sum and its adjoint for NVIDIA Hopper
// (sm_90a): every O(layer rows x lines) operand of the line-sum kernels
// (shift, stild, hw, ad, k3v, ya, yb) from the rows' state, in one launch,
// and the state's gradients from the operands' cotangents, in two.
//
// Replaces no TPU kernel: the JAX package leaves the prologue
// (monortm_tpu/ops/lineshape.py::line_params and the pedestal of
// monortm_tpu/ops/linesum_pallas.py) to XLA, which fuses it.  The port's
// plain PyTorch version (ops/lineshape.line_params +
// ops/linesum.precompute_plain, with its autograd) issues each of its
// ~100 elementwise operations, the Humlicek regions of the pedestal's
// speed-dependent Voigt and their backward as launches of their own:
// ~2500 launches forward and ~2400 backward in one retrieval step of
// 8 profiles x 40 layers, where the device work is microseconds.  So
// what bounds the prologue on this card is the host's launch rate; this
// file does the same work in one launch forward and two backward.
// At the capacity envelope (200 rows x 250k lines) it is bound by its
// writes: seven float32 [rows, lines] arrays, each byte once.
//
// Forward (prologue_fwd): one thread per (row, line); the row on
// blockIdx.x, so that consecutive blocks read one tile of the packed
// per-line columns from L2.  The arithmetic is prologue_math.cuh's
// pair_fwd, the PyTorch version's operations in its order.
//
// Adjoint: the per-row sums run over lines in runs of one isotopologue
// (ops/linesum.line_constants: lines sorted stably by their flat
// isotopologue, in catalog order within it, cut into runs of at most
// RUN_LINES).  prologue_bwd_runs: one block per (row, run); each thread
// adds its lines' pair_adj contributions in order, then the block sums
// its threads by a fixed tree (warp shuffles, then the warps in order)
// into part[row, run, :].  prologue_bwd_rows: one thread per row sums its
// runs in order and applies the row's own chain (row_adj).  No atomics:
// the gradients are the same bits from run to run.

#include <cuda_runtime.h>

#include <cstring>

#include "prologue_math.cuh"

using namespace prologue;

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 256;
constexpr int ROW_THREADS = 64;
constexpr int N_WK = 39, N_SCOR = 351;

static_assert(sizeof(Consts) == N_CONSTS * sizeof(float),
              "Consts holds N_CONSTS floats");

Consts consts_of(const float* k) {
    Consts c;
    std::memcpy(&c, k, sizeof(Consts));
    return c;
}

template <bool IBRD>
__global__ void __launch_bounds__(FWD_THREADS)
prologue_fwd(Consts K, const float* __restrict__ cols,
             const int* __restrict__ words, const float* __restrict__ p,
             const float* __restrict__ t, const float* __restrict__ wtot,
             const float* __restrict__ wk, const float* __restrict__ scor,
             int n_lines, float* shift, float* stild, float* hw, float* ad,
             float* k3v, float* ya, float* yb) {
    const int r = blockIdx.x;
    const long long n =
        static_cast<long long>(blockIdx.y) * FWD_THREADS + threadIdx.x;
    if (n >= n_lines) return;
    const RowVals rv = row_vals(p[r], t[r], wtot[r], K);
    LineCols ln;
    load_line<IBRD>(cols, words, n_lines, n, ln);
    Pair q;
    pair_fwd<IBRD>(rv, wk + static_cast<long long>(r) * N_WK,
                   scor + static_cast<long long>(r) * N_SCOR, ln, K, q);
    const long long i = static_cast<long long>(r) * n_lines + n;
    shift[i] = q.shift;
    stild[i] = q.stild;
    hw[i] = q.hw;
    ad[i] = q.ad;
    k3v[i] = q.k3v;
    ya[i] = q.ya;
    yb[i] = q.yb;
}

struct Cotangents {
    const float* g[7];   // PER_LN order; null: zero
};

template <bool IBRD>
__global__ void __launch_bounds__(BWD_THREADS)
prologue_bwd_runs(Consts K, const float* __restrict__ cols,
                  const int* __restrict__ words, const float* __restrict__ p,
                  const float* __restrict__ t,
                  const float* __restrict__ wtot,
                  const float* __restrict__ wk,
                  const float* __restrict__ scor, int n_lines, Cotangents G,
                  const int* __restrict__ perm, const int* __restrict__ runs,
                  int n_runs, float* __restrict__ part) {
    constexpr int NA = NAdj<IBRD>::value;
    const int r = blockIdx.x, run = blockIdx.y;
    const int start = runs[run], count = runs[n_runs + run];
    const RowVals rv = row_vals(p[r], t[r], wtot[r], K);
    const float* wk_row = wk + static_cast<long long>(r) * N_WK;
    const float* scor_row = scor + static_cast<long long>(r) * N_SCOR;
    float acc[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) acc[k] = 0.0f;
    for (int i = threadIdx.x; i < count; i += BWD_THREADS) {
        const long long n = perm[start + i];
        const long long ix = static_cast<long long>(r) * n_lines + n;
        float g[7];
        bool any = false;
#pragma unroll
        for (int k = 0; k < 7; ++k) {
            g[k] = G.g[k] ? G.g[k][ix] : 0.0f;
            any = any || g[k] != 0.0f;
        }
        if (!any) continue;
        LineCols ln;
        load_line<IBRD>(cols, words, n_lines, n, ln);
        Pair q;
        pair_fwd<IBRD, false>(rv, wk_row, scor_row, ln, K, q);
        pair_adj<IBRD>(rv, ln, K, q, g, acc);
    }
    // the block's sum, in a fixed order: a shuffle tree in each warp, then
    // the warps in order
    __shared__ float red[BWD_THREADS / 32][NA];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NA; ++k) {
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < NA) {
        float s = red[0][threadIdx.x];
        for (int w = 1; w < BWD_THREADS / 32; ++w) s += red[w][threadIdx.x];
        part[(static_cast<long long>(r) * n_runs + run) * NA + threadIdx.x] =
            s;
    }
}

template <bool IBRD>
__global__ void __launch_bounds__(ROW_THREADS)
prologue_bwd_rows(Consts K, const float* __restrict__ p,
                  const float* __restrict__ t,
                  const float* __restrict__ wtot,
                  const float* __restrict__ wk, const int* __restrict__ runs,
                  int n_runs, const float* __restrict__ part, int n_rows,
                  float* g_p, float* g_t, float* g_wk, float* g_wbrod,
                  float* g_scor) {
    constexpr int NA = NAdj<IBRD>::value;
    const int r = blockIdx.x * ROW_THREADS + threadIdx.x;
    if (r >= n_rows) return;
    const RowVals rv = row_vals(p[r], t[r], wtot[r], K);
    const long long rl = r;
    row_adj<IBRD>(rv, wk + rl * N_WK, K, part + rl * n_runs * NA,
                  runs + 2 * n_runs, n_runs, g_p + r, g_t + r,
                  g_wk + rl * N_WK, g_wbrod + r, g_scor + rl * N_SCOR);
}

template <bool IBRD>
int launch_fwd(const Consts& K, const float* cols, const int* words,
               const float* p, const float* t, const float* wtot,
               const float* wk, const float* scor, int n_rows, int n_lines,
               float* shift, float* stild, float* hw, float* ad, float* k3v,
               float* ya, float* yb, cudaStream_t stream) {
    dim3 grid(n_rows, (n_lines + FWD_THREADS - 1) / FWD_THREADS);
    prologue_fwd<IBRD><<<grid, FWD_THREADS, 0, stream>>>(
        K, cols, words, p, t, wtot, wk, scor, n_lines, shift, stild, hw, ad,
        k3v, ya, yb);
    return static_cast<int>(cudaGetLastError());
}

template <bool IBRD>
int launch_bwd(const Consts& K, const float* cols, const int* words,
               const float* p, const float* t, const float* wtot,
               const float* wk, const float* scor, int n_rows, int n_lines,
               const Cotangents& G, const int* perm, const int* runs,
               int n_runs, float* part, float* g_p, float* g_t, float* g_wk,
               float* g_wbrod, float* g_scor, cudaStream_t stream) {
    if (n_runs > 0) {
        prologue_bwd_runs<IBRD>
            <<<dim3(n_rows, n_runs), BWD_THREADS, 0, stream>>>(
                K, cols, words, p, t, wtot, wk, scor, n_lines, G, perm, runs,
                n_runs, part);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    prologue_bwd_rows<IBRD>
        <<<(n_rows + ROW_THREADS - 1) / ROW_THREADS, ROW_THREADS, 0, stream>>>(
            K, p, t, wtot, wk, runs, n_runs, part, n_rows, g_p, g_t, g_wk,
            g_wbrod, g_scor);
    return static_cast<int>(cudaGetLastError());
}

template <typename Kern>
int registers(Kern kernel, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    *out = attr.numRegs;
    return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device pointers of
// contiguous arrays, except `consts`, a host array of N_CONSTS floats
// (Consts): cols f32 [N_COLS, n_lines] and words int32 [n_lines] (the
// packed catalog of ops/linesum.line_constants); p, t, wtot f32
// [n_rows]; wk f32 [n_rows, 39]; scor f32 [n_rows, 351]; the seven
// operands and their cotangents f32 [n_rows, n_lines] (a null cotangent
// is zero); perm int32 [n_lines]; runs int32 [3, n_runs] (first index
// into perm, count of lines, flat isotopologue of each run); part f32
// scratch [n_rows, n_runs, 6 or 13 with ibrd]; g_p, g_t, g_wbrod f32
// [n_rows], g_wk [n_rows, 39], g_scor [n_rows, 351].  n_lines /
// FWD_THREADS and n_runs must be below 65536 (gridDim.y).  Each launches
// on `stream`, does not synchronise and returns cudaGetLastError().
extern "C" int monortm_prologue_forward(
    int ibrd, const float* consts, const float* cols, const int* words,
    const float* p, const float* t, const float* wtot, const float* wk,
    const float* scor, int n_rows, int n_lines, float* shift, float* stild,
    float* hw, float* ad, float* k3v, float* ya, float* yb, void* stream) {
    if (n_rows == 0 || n_lines == 0) return 0;
    const Consts K = consts_of(consts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return ibrd ? launch_fwd<true>(K, cols, words, p, t, wtot, wk, scor,
                                   n_rows, n_lines, shift, stild, hw, ad, k3v,
                                   ya, yb, s)
                : launch_fwd<false>(K, cols, words, p, t, wtot, wk, scor,
                                    n_rows, n_lines, shift, stild, hw, ad,
                                    k3v, ya, yb, s);
}

extern "C" int monortm_prologue_backward(
    int ibrd, const float* consts, const float* cols, const int* words,
    const float* p, const float* t, const float* wtot, const float* wk,
    const float* scor, int n_rows, int n_lines, const float* g_shift,
    const float* g_stild, const float* g_hw, const float* g_ad,
    const float* g_k3v, const float* g_ya, const float* g_yb,
    const int* perm, const int* runs, int n_runs, float* part, float* g_p,
    float* g_t, float* g_wk, float* g_wbrod, float* g_scor, void* stream) {
    if (n_rows == 0) return 0;
    const Consts K = consts_of(consts);
    const Cotangents G{{g_shift, g_stild, g_hw, g_ad, g_k3v, g_ya, g_yb}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return ibrd ? launch_bwd<true>(K, cols, words, p, t, wtot, wk, scor,
                                   n_rows, n_lines, G, perm, runs, n_runs,
                                   part, g_p, g_t, g_wk, g_wbrod, g_scor, s)
                : launch_bwd<false>(K, cols, words, p, t, wtot, wk, scor,
                                    n_rows, n_lines, G, perm, runs, n_runs,
                                    part, g_p, g_t, g_wk, g_wbrod, g_scor, s);
}

// Registers per thread of the IBRD=0 kernels: forward, the runs' pass and
// the rows' pass, into out[3].
extern "C" int monortm_prologue_info(int* out) {
    int rc = registers(prologue_fwd<false>, &out[0]);
    if (rc) return rc;
    rc = registers(prologue_bwd_runs<false>, &out[1]);
    if (rc) return rc;
    return registers(prologue_bwd_rows<false>, &out[2]);
}
