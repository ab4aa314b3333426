// The continuum and cloud stage of the optical-depth model for NVIDIA
// Hopper (sm_90a): the MT_CKD sub-continua, Rayleigh and the TKC cloud of
// every (layer row, wavenumber) of a call in one call of two kernels, and
// the rows' gradients in one kernel.
//
// Replaces no TPU kernel: the JAX package's continuum
// (monortm_tpu/ops/continuum.py, ContinuumPlan.__call__) and cloud
// (monortm_tpu/ops/cloud.py, od_clw) are plain jnp code that XLA fuses.
// The port's eager PyTorch version (ops/continuum.py + ops/cloud.py, with
// its autograd) issues each elementwise operation, gather and index_add
// as a launch of its own: 337 launches forward and 580 backward in one
// retrieval step of 8 profiles x 40 layers on the microwave grid, 917 of
// the step's 2082, where the device work is a fraction of a microsecond.
// So what bounds this stage on the card is the host's launch rate, and
// this file does it in one call each way.  The kernels themselves are
// bound by their writes: seven float32 [rows, wavenumbers] outputs, each
// byte once (7 x R x W x 4 against 3.35e12 B/s: ~0.3 us at the
// retrieval's 320 x 101, ~0.13 ms at the envelope's 200 x 80000), the
// adjoint by reading as many cotangents; at the retrieval's shape a
// launch's latency is all either takes.  Their times are in PERF.md.
//
// Forward: cont_absrb, one thread per (row, species, ABSRB point): the
// stage-1 XINT of each sub-continuum of the species that reaches the
// point, in the plan's order, each window value evaluated where the
// gather reads it (continuum_math.cuh, absrb_value), and Rayleigh's
// ABSRB term; the row's values go to a scratch [rows, 6, nptabs], which
// the adjoint reads again.  cont_cols, one thread per (row, wavenumber):
// the stage-2 XINT of the six, the radiation term and the cloud
// (col_values).  Both keep the eager path's order, operation by
// operation (the header says how), so the outputs are its bits.
//
// Adjoint: cont_bwd, one block per row, in four passes separated by
// __syncthreads:
//   (A) the wavenumbers, strided over the block's threads: the radiation
//       term into a scratch [rows, wavenumbers], and each thread's sums
//       of the gradients of xkt (through the radiation term), of t
//       (through the cloud) and of clw;
//   (B) the ABSRB points, a warp each: the gradient of each, a walk of
//       its stage-2 reverse map strided over the lanes, the lanes folded
//       by halving shuffles, into a scratch [rows, 6, nptabs] (double);
//   (C) the sub-continua's window points, then Rayleigh's ABSRB points:
//       each one's gradient from its stage-1 reverse map, times its
//       partials by the row's primaries (Dual);
//   (D) thread 0 forms the row's gradients.
// The thread sums of (A) and (C) are folded by a fixed tree in shared
// memory.  No atomics: the gradients are the same bits from run to run,
// whatever rows share the launch.

#include <cuda_runtime.h>

#include <cstring>

#include "continuum_math.cuh"

using namespace cont;

namespace {

constexpr int ABS_THREADS = 128;
constexpr int COL_THREADS = 256;
struct Outs {
    float* o[N_OUT];
};

__global__ void __launch_bounds__(ABS_THREADS)
cont_absrb(Plan P, const float* __restrict__ p, const float* __restrict__ t,
           const float* __restrict__ wk, const float* __restrict__ wbrod,
           float* __restrict__ absrb) {
    const int r = blockIdx.x;
    __shared__ Row<float> L;
    if (threadIdx.x == 0)
        L = row_in(p[r], t[r], wk + static_cast<long long>(r) * N_WK,
                   wbrod[r], P.nmol);
    __syncthreads();
    const int i = blockIdx.y * ABS_THREADS + threadIdx.x;
    if (i >= N_SPECIES * P.nptabs) return;
    const int sp = i / P.nptabs;
    absrb[static_cast<long long>(r) * N_SPECIES * P.nptabs + i] =
        absrb_value(P, L, sp, i - sp * P.nptabs);
}

__global__ void __launch_bounds__(COL_THREADS)
cont_cols(Plan P, const float* __restrict__ t, const float* __restrict__ clw,
          const float* __restrict__ absrb, Outs O) {
    const int r = blockIdx.x;
    __shared__ CloudRow<float> c;
    __shared__ float xkt;
    if (threadIdx.x == 0) {
        c = cloud_row(t[r]);
        xkt = divc(t[r], RADCN2);
    }
    __syncthreads();
    const int w = blockIdx.y * COL_THREADS + threadIdx.x;
    if (w >= P.n_wn) return;
    float out[N_OUT];
    col_values(P, absrb + static_cast<long long>(r) * N_SPECIES * P.nptabs,
               w, xkt, c, clw[r], out);
    const long long ix = static_cast<long long>(r) * P.n_wn + w;
    for (int q = 0; q < N_OUT; ++q) O.o[q][ix] = out[q];
}

// the block's sums of n values per thread, folded by a fixed tree;
// red[q][0] holds sum q after the call
__device__ __forceinline__ void fold(double (*red)[BWD_THREADS],
                                     const double* v, int n) {
    const int i = threadIdx.x;
    for (int q = 0; q < n; ++q) red[q][i] = v[q];
    __syncthreads();
    for (int s = BWD_THREADS / 2; s > 0; s >>= 1) {
        if (i < s)
            for (int q = 0; q < n; ++q) red[q][i] += red[q][i + s];
        __syncthreads();
    }
}

__global__ void __launch_bounds__(BWD_THREADS)
cont_bwd(Plan P, const float* __restrict__ p, const float* __restrict__ t,
         const float* __restrict__ wk, const float* __restrict__ wbrod,
         const float* __restrict__ clw, const float* __restrict__ absrb,
         Cot G, float* __restrict__ rf_s, double* __restrict__ gab,
         float* __restrict__ gp, float* __restrict__ gt,
         float* __restrict__ gwk, float* __restrict__ gwbrod,
         float* __restrict__ gclw) {
    __shared__ double red[N_FOLD][BWD_THREADS];
    __shared__ double col[N_COLSUM];
    const int r = blockIdx.x, i = threadIdx.x;
    const long long row = static_cast<long long>(r) * P.n_wn;
    const long long rab = static_cast<long long>(r) * N_SPECIES * P.nptabs;
    const Row<float> L = row_in(p[r], t[r], wk + static_cast<long long>(r)
                                * N_WK, wbrod[r], P.nmol);
    const CloudRow<float> c = cloud_row(t[r]);
    const CloudRow<Dual1> cd = cloud_row(seed<1>(t[r], 0));
    Cot Gr;
    for (int q = 0; q < N_OUT; ++q) Gr.g[q] = G.g[q] ? G.g[q] + row : nullptr;

    // (A) the wavenumbers
    double acc[N_COLSUM];
    for (int q = 0; q < N_COLSUM; ++q) acc[q] = 0.0;
    for (int w = i; w < P.n_wn; w += BWD_THREADS)
        rf_s[row + w] = col_adjoint(P, absrb + rab, w, w, L.xkt, c, cd,
                                    clw[r], Gr, acc);
    fold(red, acc, N_COLSUM);
    if (i < N_COLSUM) col[i] = red[i][0];

    // (B) the ABSRB points, a warp each
    const int lane = i % WARP;
    for (int j = i / WARP; j < N_SPECIES * P.nptabs;
         j += BWD_THREADS / WARP) {
        const int sp = j / P.nptabs;
        double v = absrb_adjoint(P, sp, j - sp * P.nptabs, Gr.g[sp],
                                 rf_s + row, lane);
        for (int off = WARP / 2; off > 0; off /= 2)
            v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) gab[rab + j] = v;
    }
    __syncthreads();

    // (C) the window points, then Rayleigh's
    const Row<Dual> LD = row_dual(L);
    double prim[N_PRIM];
    for (int q = 0; q < N_PRIM; ++q) prim[q] = 0.0;
    const int n_pts = P.n_win + (P.has_ray ? P.nptabs : 0);
    for (int j = i; j < n_pts; j += BWD_THREADS)
        point_adjoint(P, j, gab + rab, LD, prim);
    fold(red, prim, N_PRIM);

    // (D) the row's gradients
    if (i == 0) {
        for (int q = 0; q < N_PRIM; ++q) prim[q] = red[q][0];
        row_grads(P, prim, col, gp + r, gt + r,
                  gwk + static_cast<long long>(r) * N_WK, gwbrod + r,
                  gclw + r);
    }
}

template <typename Kern>
int registers(Kern kernel, int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    *out = attr.numRegs;
    return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes.  `ints` (int32) and `flts` (float32)
// are the device arrays of the packed plan, `layout` a host array of
// N_LAYOUT int64 (ops/continuum_kernel.pack: offsets, then n_subs, n_wn,
// nptabs, nmol, has_ray, n_win); teff is the CO2 bandhead's t_eff.  p, t, wbrod, clw f32 [n_rows]; wk f32 [n_rows, 39]; absrb f32
// scratch [n_rows, 6, nptabs]; the seven outputs and their cotangents f32
// [n_rows, n_wn] (h2o, co2, o3, o2, n2, rayleigh, cloud; a null cotangent
// is zero); rf f32 scratch [n_rows, n_wn]; gab f64 scratch [n_rows, 6,
// nptabs]; gp, gt, gwbrod, gclw f32 [n_rows], gwk [n_rows, 39].  The
// rows lie on gridDim.x; n_wn / 256 and 6 nptabs / 128 must be below
// 65536 (gridDim.y).  Each launches on `stream`, does not synchronise and
// returns cudaGetLastError().
extern "C" int monortm_continuum_forward(
    const int* ints, const float* flts, const long long* layout, double teff,
    const float* p, const float* t, const float* wk, const float* wbrod,
    const float* clw, int n_rows, float* absrb, float* o_h2o, float* o_co2,
    float* o_o3, float* o_o2, float* o_n2, float* o_ray, float* o_clw,
    void* stream) {
    if (n_rows == 0) return 0;
    const Plan P = plan_of(ints, flts, layout, teff);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_abs = N_SPECIES * P.nptabs;
    cont_absrb<<<dim3(n_rows, (n_abs + ABS_THREADS - 1) / ABS_THREADS),
                 ABS_THREADS, 0, s>>>(P, p, t, wk, wbrod, absrb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || P.n_wn == 0) return static_cast<int>(err);
    const Outs O{{o_h2o, o_co2, o_o3, o_o2, o_n2, o_ray, o_clw}};
    cont_cols<<<dim3(n_rows, (P.n_wn + COL_THREADS - 1) / COL_THREADS),
                COL_THREADS, 0, s>>>(P, t, clw, absrb, O);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int monortm_continuum_backward(
    const int* ints, const float* flts, const long long* layout, double teff,
    const float* p, const float* t, const float* wk, const float* wbrod,
    const float* clw, int n_rows, const float* absrb, const float* g_h2o,
    const float* g_co2, const float* g_o3, const float* g_o2,
    const float* g_n2, const float* g_ray, const float* g_clw, float* rf,
    double* gab, float* gp, float* gt, float* gwk, float* gwbrod,
    float* gclw, void* stream) {
    if (n_rows == 0) return 0;
    const Plan P = plan_of(ints, flts, layout, teff);
    const Cot G{{g_h2o, g_co2, g_o3, g_o2, g_n2, g_ray, g_clw}};
    cont_bwd<<<n_rows, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        P, p, t, wk, wbrod, clw, absrb, G, rf, gab, gp, gt, gwk, gwbrod,
        gclw);
    return static_cast<int>(cudaGetLastError());
}

// Registers per thread of cont_absrb, cont_cols and cont_bwd, into out[3].
extern "C" int monortm_continuum_info(int* out) {
    int rc = registers(cont_absrb, &out[0]);
    if (rc) return rc;
    rc = registers(cont_cols, &out[1]);
    if (rc) return rc;
    return registers(cont_bwd, &out[2]);
}
