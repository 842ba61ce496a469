// Fused whole-solve batched MPPI (K13): one launch runs every importance-
// sampling round of every scenario: the T-step rollout of all K samples
// through the plant, the quadratic stage costs, the softmax weights and the
// effective sample size, and the nominal update.
//
// Replaces the TPU kernel numpower_tpu/kernels/mppi.py mppi_pallas
// (_mppi_kernel), in its order of operations. Per round, for sample k:
//     u_t = clip(u_nom_t + eps_t,k)                       (the candidate)
//     S_k = sum_t c(x_t, u_t) + c_T(x_T) + lam sum_t sum_a (u - u_nom) (sig_a^-2 u_nom)
//     x_{t+1} = f(x_t, u_t)
//     w_k = exp(-(S_k - min S) / lam) / sum,   ess = 1 / sum w^2
//     u_nom <- clip(u_nom + sum_k w_k (u_k - u_nom))
// with c(x, u) = sum_ij Q_ij dx_i dx_j + sum_ab R_ab u_a u_b (dx = x - goal)
// and c_T the same with QF, each sum over i, then j, in row-major order, as
// the JAX cost's rows form sums them (its skipped zero entries add exact
// zeros here). Every product and sum is one IEEE operation (plants.cuh), so
// none is contracted into an FMA, as the eager plain version runs them.
// It writes us (N, T, m) and ess (N, iters).
//
// Design. One block per scenario, one thread per sample (K <= 1024): the
// state, the candidate and S in registers; the nominal u_nom (T*m floats),
// the weights and the plant parameters in shared memory, read by all
// threads at once. eps[r, s, :] is contiguous along the samples, so the
// warp's loads coalesce; each thread stages its own samples' rows of a chunk
// of Tc steps in shared memory with cp.async, double-buffered, so the next
// chunk is in flight while this one rolls out and no thread waits on
// another. The update's T*m weighted sums take one warp-shuffle tree per
// entry in every warp, one barrier, and the warps' partials summed in warp
// order by one thread per entry: a round costs five barriers, not T*m block
// reductions. The candidates are re-staged from eps for the update (the
// round's slice of one scenario, T*m*K*4 bytes, comes back from the L2).
//
// What bounds it: at the bench's shape (N = 256, K = 256, T = 40, 8 rounds)
// reading eps once is 84 MB, ~25 us of HBM time, against ~12 us of fp32
// operations; the chain of T dependent plant steps per round (sinf in the
// pendulum) is what the staging hides the loads behind.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "plants.cuh"

namespace mppi {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTM = 1024;                  // kernels/mppi.py MAX_TM
constexpr int kMaxTc = 16;                    // steps per staged chunk
constexpr size_t kStageBudget = 64 * 1024;    // bytes of the two eps chunks
constexpr size_t kSmemMax = 227 * 1024;

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Args {
  const float *consts, *x0s, *eps, *us0;
  float *us, *ess;
  int N, K, T, iters;
  float lam, inv_lam;
  int clip;
  float lo, hi;
};

struct Sum {
  __device__ float operator()(float a, float b) const { return plants::add(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

__device__ __forceinline__ float clipu(float u, const Args& a) {
  return a.clip ? fminf(fmaxf(u, a.lo), a.hi) : u;
}

// The value of v reduced over the block, the same on every thread: a
// shuffle tree per warp, the warps' results combined in warp order.
template <class Op>
__device__ float block_reduce(float v, float* red, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = op(r, red[w]);
  __syncthreads();  // red is written again by the next reduction
  return r;
}

// Floats of shared memory before the eps stage.
inline size_t head_floats(int n, int m, int TM, int nw) {
  return static_cast<size_t>(2 * n * n + m * m + n + m + plants::kMaxParams) + TM + 32 +
         static_cast<size_t>(nw) * TM;
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads) mppi_kernel(PlantParams params, Args a, int Tc) {
  using F = plants::Plant<P>;
  using plants::add;
  using plants::mul;
  using plants::sub;
  constexpr int n = F::n, m = F::m;
  extern __shared__ __align__(16) float smem[];
  const int TM = a.T * m, nw = blockDim.x >> 5, Kp = blockDim.x;
  float* const wQ = smem;                      // (n, n)
  float* const wR = wQ + n * n;                // (m, m)
  float* const wQF = wR + m * m;               // (n, n)
  float* const goal = wQF + n * n;             // (n)
  float* const isig = goal + n;                // (m) sigma^-2
  float* const par = isig + m;                 // plant parameters
  float* const u_nom = par + plants::kMaxParams;  // (T*m)
  float* const red = u_nom + TM;               // (32) block reductions
  float* const part = red + 32;                // (nw, T*m) the update's warp partials
  float* const stage = part + nw * TM;         // (2, Tc*m, Kp) eps chunks
  const int nconst = 2 * n * n + m * m + n + m;

  const int k = threadIdx.x, s = blockIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool live = k < a.K;
  for (int e = k; e < nconst; e += blockDim.x) smem[e] = a.consts[e];
  for (int e = k; e < plants::kMaxParams; e += blockDim.x) par[e] = params.v[e];
  for (int e = k; e < TM; e += blockDim.x) u_nom[e] = a.us0[e];
  float x0[n];
#pragma unroll
  for (int j = 0; j < n; ++j) x0[j] = a.x0s[static_cast<size_t>(s) * n + j];
  __syncthreads();

  const size_t NK = static_cast<size_t>(a.N) * a.K;
  const float* const eps_s = a.eps + static_cast<size_t>(s) * a.K + k;  // + row * NK
  const int nchunks = (a.T + Tc - 1) / Tc;
  // Stage the rows of this thread's sample for the steps of chunk c of round
  // it into buffer c & 1, as one cp.async batch (empty past the last chunk).
  auto issue = [&](int it, int c) {
    if (live && c < nchunks) {
      const int t0 = c * Tc, rows = min(Tc, a.T - t0) * m;
      float* const buf = stage + (c & 1) * Tc * m * Kp + k;
      const size_t r0 = (static_cast<size_t>(it) * a.T + t0) * m;
      for (int q = 0; q < rows; ++q)
        __pipeline_memcpy_async(buf + q * Kp, eps_s + (r0 + q) * NK, sizeof(float));
    }
    __pipeline_commit();
  };

  for (int it = 0; it < a.iters; ++it) {
    // -- rollout of every candidate: stage costs, terminal cost, coupling --
    float x[n];
#pragma unroll
    for (int j = 0; j < n; ++j) x[j] = x0[j];
    float S = 0.0f, couple = 0.0f;
    issue(it, 0);
    for (int c = 0; c < nchunks; ++c) {
      issue(it, c + 1);
      __pipeline_wait_prior(1);  // this thread's chunk c has landed
      if (!live) continue;
      const float* const buf = stage + (c & 1) * Tc * m * Kp + k;
      const int t0 = c * Tc, steps = min(Tc, a.T - t0);
      for (int tt = 0; tt < steps; ++tt) {
        const float* const un = u_nom + (t0 + tt) * m;
        float u[m], dx[n], xn[n];
#pragma unroll
        for (int b = 0; b < m; ++b) u[b] = clipu(add(un[b], buf[(tt * m + b) * Kp]), a);
#pragma unroll
        for (int i = 0; i < n; ++i) dx[i] = sub(x[i], goal[i]);
        float cst = 0.0f;
#pragma unroll
        for (int i = 0; i < n; ++i)
#pragma unroll
          for (int j = 0; j < n; ++j) cst = add(cst, mul(mul(wQ[i * n + j], dx[i]), dx[j]));
#pragma unroll
        for (int i = 0; i < m; ++i)
#pragma unroll
          for (int j = 0; j < m; ++j) cst = add(cst, mul(mul(wR[i * m + j], u[i]), u[j]));
        S = add(S, cst);
#pragma unroll
        for (int b = 0; b < m; ++b) couple = add(couple, mul(sub(u[b], un[b]), mul(isig[b], un[b])));
        F::step(x, u, par, xn);
#pragma unroll
        for (int j = 0; j < n; ++j) x[j] = xn[j];
      }
    }
    if (live) {
      float cst = 0.0f;
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j)
          cst = add(cst, mul(mul(wQF[i * n + j], sub(x[i], goal[i])), sub(x[j], goal[j])));
      S = add(add(S, cst), mul(a.lam, couple));
    }

    // -- softmax weights over the samples, and the ESS --
    const float Smin = block_reduce(live ? S : CUDART_INF_F, red, Min());
    float w = live ? expf(mul(-sub(S, Smin), a.inv_lam)) : 0.0f;
    w = plants::dvd(w, block_reduce(w, red, Sum()));
    const float ss = block_reduce(mul(w, w), red, Sum());
    if (k == 0) a.ess[static_cast<size_t>(s) * a.iters + it] = plants::dvd(1.0f, ss);

    // -- the update: sum_k w_k (cand_k - u_nom) per entry, warps then block --
    issue(it, 0);
    for (int c = 0; c < nchunks; ++c) {
      issue(it, c + 1);
      __pipeline_wait_prior(1);
      const float* const buf = stage + (c & 1) * Tc * m * Kp + k;
      const int r0 = c * Tc * m, rows = min(Tc, a.T - c * Tc) * m;
      for (int q = 0; q < rows; ++q) {
        const float un = u_nom[r0 + q];
        float v = live ? mul(w, sub(clipu(add(un, buf[q * Kp]), a), un)) : 0.0f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
        if (lane == 0) part[warp * TM + r0 + q] = v;
      }
    }
    __syncthreads();  // every warp's partials are written
    for (int r = k; r < TM; r += blockDim.x) {
      float du = part[r];
      for (int wp = 1; wp < nw; ++wp) du = add(du, part[wp * TM + r]);
      u_nom[r] = clipu(add(u_nom[r], du), a);
    }
    __syncthreads();  // the new nominal is in place for the next round
  }
  for (int r = k; r < TM; r += blockDim.x) a.us[static_cast<size_t>(s) * TM + r] = u_nom[r];
}

template <int P>
int launch(const PlantParams& params, const Args& a, cudaStream_t stream) {
  constexpr int n = plants::Plant<P>::n, m = plants::Plant<P>::m;
  const int threads = (a.K + 31) / 32 * 32, TM = a.T * m;
  if (TM > kMaxTM) return static_cast<int>(cudaErrorInvalidValue);
  int Tc = kMaxTc < a.T ? kMaxTc : a.T;
  while (Tc > 1 && 2 * static_cast<size_t>(Tc) * m * threads * sizeof(float) > kStageBudget) --Tc;
  const size_t smem = sizeof(float) * (head_floats(n, m, TM, threads / 32) +
                                       2 * static_cast<size_t>(Tc) * m * threads);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mppi_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_kernel<P><<<a.N, threads, smem, stream>>>(params, a, Tc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mppi

// us (N, T, m) and ess (N, iters) from the plant index and its parameter
// floats p0..p7 (plants::kMaxParams, by value); consts = Q (n, n), R (m, m),
// QF (n, n), goal (n), sigma^-2 (m) packed; x0s (N, n); eps (iters*T*m, N, K);
// us0 (T*m); all fp32, row-major contiguous, on the device. lam and 1/lam as
// the caller rounds them; clip != 0 clips candidates and nominal to [lo, hi].
// n and m are the plant's; the caller checks the shapes against them.
// Returns the CUDA error code of the launch.
extern "C" int npt_mppi(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                        float p6, float p7, const float* consts, const float* x0s,
                        const float* eps, const float* us0, float* us, float* ess, int N, int K,
                        int T, int iters, float lam, float inv_lam, int clip, float lo, float hi,
                        void* stream) {
  using namespace mppi;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (N < 1 || K < 1 || K > kMaxThreads || T < 1 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const Args a{consts, x0s, eps, us0, us, ess, N, K, T, iters, lam, inv_lam, clip, lo, hi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant) {
#define NPT_CASE(P) \
  case P:           \
    return launch<P>(params, a, st);
    NPT_CASE(0) NPT_CASE(1) NPT_CASE(2) NPT_CASE(3)
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
