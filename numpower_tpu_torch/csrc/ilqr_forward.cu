// Fused iLQR forward line search (K8): closed-loop rollouts of every
// line-search alpha for every scenario, the plant in the kernel, the
// quadratic cost accumulated per (alpha, scenario).
//
// Replaces the TPU kernel numpower_tpu/kernels/ilqr_forward.py
// ilqr_forward_pallas (_fwd_kernel). For alpha a and scenario s, from x = x0_s:
//     u_t = u_nom_t + alpha_a k_t + K_t (x_t - x_nom_t)
//     cost += (x_t - goal)'Q(x_t - goal) + u_t'R u_t     (symmetric Q, R)
//     x_{t+1} = f(x_t, u_t)
// and the terminal (x_T - goal)'QF(x_T - goal). The quadratic forms are
// summed as the TPU kernel sums them: for i, for j >= i, w_ij di dj with
// w = Q_ij (i = j) or 2 Q_ij (j > i), stage cost before the step, into one
// running sum. It writes us (A, N, T, m), xs (A, N, T+1, n) and costs
// (A, N); the argmin over alphas stays outside, as in the JAX package.
//
// What bounds it: one thread's chain of T dependent steps (feedback, plant
// with sinf/cosf and IEEE divisions), not device memory (the nominal is
// read once per block, the outputs written once) nor the pipes. On the H100
// a cartpole step at config #3b's shape takes ~0.9 us: ~830 cycles write
// the outputs back, ~440 run the plant (its dependent path is 122 cycles in
// the SASS), the rest the feedback, cost and staging
// (probes/ilqr_chain.py). The slow sinf path of diverging alphas costs
// their warps up to ~30% more plant time; it does not set the kernel's.
//
// Design. One thread per (alpha, scenario): its state, its control and its
// cost stay in registers for the whole horizon, and n, m are the plant's
// compile-time constants (plants.cuh), so every loop unrolls. A block holds
// 32 scenarios (the lanes of a warp) and W <= 4 alphas, one warp each, so
// each warp has an SM scheduler to itself; the grid's y covers the alphas in
// groups of W (a warp past the last alpha recomputes it and stores nothing,
// as a ragged scenario does). The weights, the goal and the plant's
// parameters are the block's, in shared memory: kept in registers they stay
// live across the division's and sinf's slow-path calls, which then spill.
//  - Inputs. The nominal trajectory and the gains of a chunk of Tc steps are,
//    per scenario, four contiguous runs in device memory. Thread (w, lane)
//    copies run w of scenario lane with 16-byte cp.async (async_copy.cuh) into
//    a ring of kRing chunk buffers, kRing - 1 chunks ahead of the rollout;
//    one barrier a chunk makes them the block's and frees the oldest buffer.
//  - Outputs. A thread writes its u and x of each step to its warp's
//    staging rows in shared memory; after the chunk the warp writes them back
//    run by run (per (alpha, scenario), one run of us and one of xs),
//    neighbouring lanes on neighbouring floats, eight runs' loads issued
//    before their stores, and the stores drain while the next chunk runs.
//    (Stores straight from registers, one 4-byte sector per lane, choke L1
//    at N = 4096: probes/ilqr_chain.py measured 0.124 ms on the H100.)

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "plants.cuh"

#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_STAMP_END
#endif

namespace ilqr_fwd {

constexpr int kScen = 32;        // scenarios per block: the lanes of a warp
constexpr int kMaxAlphas = 32;
constexpr int kWarps = 4;        // alphas per block at most
constexpr int kRing = 3;         // chunk buffers of the inputs
constexpr int kMaxTc = 16;       // steps per chunk
constexpr int kSmemBudget = 64 * 1024;

struct PlantParams {
  float v[plants::kMaxParams];
};

template <int n, int m, int Tc>
struct Shape {
  // One scenario's slots in a chunk buffer (floats; each 16-byte aligned):
  // x_nom, u_nom, k, K of the chunk's steps.
  static constexpr int oX = 0;
  static constexpr int oU = oX + async_copy::slot_floats(Tc * n);
  static constexpr int oK = oU + async_copy::slot_floats(Tc * m);
  static constexpr int oG = oK + async_copy::slot_floats(Tc * m);
  static constexpr int kSlots = oG + async_copy::slot_floats(Tc * m * n);
  static constexpr int kRegion = kSlots + (36 - kSlots % 32) % 32;  // = 4 mod 32 floats
  static constexpr int kOutLd = (Tc * (m + n)) | 1;  // odd: a warp's 32 rows hit 32 banks
  static constexpr size_t smem_bytes =
      sizeof(float) * (static_cast<size_t>(kRing) * kScen * kRegion +
                       static_cast<size_t>(kWarps) * kScen * kOutLd);
};

// The longest chunk whose block fits the budget.
template <int n, int m, int Tc = kMaxTc>
struct ChunkFor {
  static constexpr int value =
      (Tc == 1 || Shape<n, m, Tc>::smem_bytes <= kSmemBudget) ? Tc : ChunkFor<n, m, Tc - 1>::value;
};
template <int n, int m>
struct ChunkFor<n, m, 0> {
  static constexpr int value = 1;
};

template <int P>
__global__ void __launch_bounds__(kWarps * kScen, 1)  // ilqr_backward.cu says why the 1
    ilqr_forward_kernel(PlantParams params, const float* __restrict__ Q,
                        const float* __restrict__ R, const float* __restrict__ QF,
                        const float* __restrict__ goal, const float* __restrict__ alphas,
                        const float* __restrict__ x0s, const float* __restrict__ xs_nom,
                        const float* __restrict__ us_nom, const float* __restrict__ ks,
                        const float* __restrict__ Ks, float* __restrict__ us,
                        float* __restrict__ xs, float* __restrict__ costs, int N, int T, int A,
                        int xs_rows) {
  NPT_STAMP_BEGIN;
  using F = plants::Plant<P>;
  constexpr int n = F::n, m = F::m;
  constexpr int Tc = ChunkFor<n, m>::value;
  using S = Shape<n, m, Tc>;
  extern __shared__ __align__(16) float smem[];  // the ring, then the staging rows
  float* const out_s = smem + kRing * kScen * S::kRegion;  // (warps, kScen, kOutLd)
  __shared__ float wQ[n * n];   // Q_ij on the diagonal, 2 Q_ij above, 0 below
  __shared__ float wQF[n * n];  // the same for QF
  __shared__ float wR[m * m];   // the same for R
  __shared__ float goal_s[n];
  __shared__ float par_s[plants::kMaxParams];

  const int lane = threadIdx.x % kScen, w = threadIdx.x / kScen, nw = blockDim.x / kScen;
  const int a_raw = blockIdx.y * nw + w;
  const bool alpha_live = a_raw < A;
  const int a = alpha_live ? a_raw : A - 1;
  const int s0 = blockIdx.x * kScen;
  const int s_raw = s0 + lane;
  const bool live = alpha_live && s_raw < N;
  const int s = s_raw < N ? s_raw : N - 1;  // a ragged tail recomputes a real scenario

  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e % n;
    wQ[e] = c < r ? 0.0f : (c == r ? Q[e] : Q[e] * 2.0f);
    wQF[e] = c < r ? 0.0f : (c == r ? QF[e] : QF[e] * 2.0f);
  }
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int r = e / m, c = e % m;
    wR[e] = c < r ? 0.0f : (c == r ? R[e] : R[e] * 2.0f);
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) goal_s[e] = goal[e];
  for (int e = threadIdx.x; e < plants::kMaxParams; e += blockDim.x) par_s[e] = params.v[e];
  __syncthreads();

  // Thread (w, lane) stages runs r = w, w + nw, .. of scenario s: 0 x_nom,
  // 1 u_nom, 2 k, 3 K; chunk c into its buffer as one commit group (empty
  // past the last chunk).
  const int nch = (T + Tc - 1) / Tc;
  const size_t ss = static_cast<size_t>(s);
  auto issue = [&](int c) {
    if (c < nch) {
      const int t0 = c * Tc, steps = min(Tc, T - t0);
      float* const reg = smem + ((c % kRing) * kScen + lane) * S::kRegion;
      for (int r = w; r < 4; r += nw) {
        if (r == 0) async_copy::copy_run(reg + S::oX, xs_nom + (ss * xs_rows + t0) * n, steps * n);
        if (r == 1) async_copy::copy_run(reg + S::oU, us_nom + (ss * T + t0) * m, steps * m);
        if (r == 2) async_copy::copy_run(reg + S::oK, ks + (ss * T + t0) * m, steps * m);
        if (r == 3) async_copy::copy_run(reg + S::oG, Ks + (ss * T + t0) * m * n, steps * m * n);
      }
    }
    __pipeline_commit();
  };
  for (int c = 0; c < kRing - 1; ++c) issue(c);

  const float alpha = alphas[a];
  float x[n];
  const size_t out_row = static_cast<size_t>(a) * N + s;  // (alpha, scenario)
#pragma unroll
  for (int j = 0; j < n; ++j) x[j] = x0s[ss * n + j];
  if (live) {
#pragma unroll
    for (int j = 0; j < n; ++j) xs[out_row * (T + 1) * n + j] = x[j];
  }
  float cost = 0.0f;
  float* const my_out = out_s + (w * kScen + lane) * S::kOutLd;
  NPT_STAMP(5);

  for (int c = 0; c < nch; ++c) {
    const int t0 = c * Tc, steps = min(Tc, T - t0);
    __pipeline_wait_prior(kRing - 2);  // this thread's runs of chunk c have landed
    __syncthreads();  // every thread's have; every warp is done with chunk c - 1
    issue(c + kRing - 1);  // into the buffer chunk c - 1 left
    const float* const reg = smem + ((c % kRing) * kScen + lane) * S::kRegion;
    const float* const pX = reg + S::oX + async_copy::run_offset(xs_nom + (ss * xs_rows + t0) * n);
    const float* const pU = reg + S::oU + async_copy::run_offset(us_nom + (ss * T + t0) * m);
    const float* const pK = reg + S::oK + async_copy::run_offset(ks + (ss * T + t0) * m);
    const float* const pG = reg + S::oG + async_copy::run_offset(Ks + (ss * T + t0) * m * n);
    NPT_STAMP(0);

    for (int tt = 0; tt < steps; ++tt) {
      const float* xn = pX + tt * n;
      const float* un = pU + tt * m;
      const float* kk = pK + tt * m;
      const float* KK = pG + tt * m * n;
      float dx[n], u[m], xnext[n];
#pragma unroll
      for (int j = 0; j < n; ++j) dx[j] = x[j] - xn[j];
#pragma unroll
      for (int b = 0; b < m; ++b) {
        float acc = un[b] + alpha * kk[b];
#pragma unroll
        for (int j = 0; j < n; ++j) acc = acc + KK[b * n + j] * dx[j];
        u[b] = acc;
      }
      NPT_STAMP(1);
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float di = x[i] - goal_s[i];
#pragma unroll
        for (int j = i; j < n; ++j) cost = cost + wQ[i * n + j] * di * (x[j] - goal_s[j]);
      }
#pragma unroll
      for (int i = 0; i < m; ++i)
#pragma unroll
        for (int j = i; j < m; ++j) cost = cost + wR[i * m + j] * u[i] * u[j];
      NPT_STAMP(2);
      F::step(x, u, par_s, xnext);
#pragma unroll
      for (int j = 0; j < n; ++j) x[j] = xnext[j];
      NPT_STAMP(3);
#pragma unroll
      for (int b = 0; b < m; ++b) my_out[tt * m + b] = u[b];
#pragma unroll
      for (int j = 0; j < n; ++j) my_out[Tc * m + tt * n + j] = x[j];
      NPT_STAMP(4);
    }
    __syncwarp();  // the warp's staging rows of the chunk are complete

    // Write the chunk back: per (alpha, scenario) of this warp one run of us
    // and one of xs, neighbouring lanes on neighbouring floats of a run,
    // eight runs at a time, their loads all issued before their stores.
    if (alpha_live) {
      constexpr int QU = (Tc * m + kScen - 1) / kScen, QX = (Tc * n + kScen - 1) / kScen;
      constexpr int kGroup = 8;
      const int live_scen = min(kScen, N - s0);
      const float* const src = out_s + w * kScen * S::kOutLd;
      float* const ud = us + ((static_cast<size_t>(a) * N + s0) * T + t0) * m;
      float* const xd = xs + ((static_cast<size_t>(a) * N + s0) * (T + 1) + 1 + t0) * n;
#pragma unroll
      for (int r0 = 0; r0 < kScen; r0 += kGroup) {
        float bu[kGroup][QU], bx[kGroup][QX];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
#pragma unroll
          for (int q = 0; q < QU; ++q) {
            const int e = q * kScen + lane;
            bu[g][q] = e < Tc * m ? src[(r0 + g) * S::kOutLd + e] : 0.0f;
          }
#pragma unroll
          for (int q = 0; q < QX; ++q) {
            const int e = q * kScen + lane;
            bx[g][q] = e < Tc * n ? src[(r0 + g) * S::kOutLd + Tc * m + e] : 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const size_t r = r0 + g;
          if (r0 + g < live_scen) {
#pragma unroll
            for (int q = 0; q < QU; ++q) {
              const int e = q * kScen + lane;
              if (e < steps * m) ud[r * T * m + e] = bu[g][q];
            }
#pragma unroll
            for (int q = 0; q < QX; ++q) {
              const int e = q * kScen + lane;
              if (e < steps * n) xd[r * (T + 1) * n + e] = bx[g][q];
            }
          }
        }
      }
    }
    NPT_STAMP(6);
  }

#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float di = x[i] - goal_s[i];
#pragma unroll
    for (int j = i; j < n; ++j) cost = cost + wQF[i * n + j] * di * (x[j] - goal_s[j]);
  }
  if (live) costs[out_row] = cost;
  NPT_STAMP(5);
  NPT_STAMP_END;
}

template <int P>
int launch(const PlantParams& params, const float* Q, const float* R, const float* QF,
           const float* goal, const float* alphas, const float* x0s, const float* xs_nom,
           const float* us_nom, const float* ks, const float* Ks, float* us, float* xs,
           float* costs, int N, int T, int A, int xs_rows, cudaStream_t stream) {
  constexpr int n = plants::Plant<P>::n, m = plants::Plant<P>::m;
  constexpr size_t smem = Shape<n, m, ChunkFor<n, m>::value>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(ilqr_forward_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // W alphas a block, as even as the groups allow (six alphas: two blocks of 3)
  const int groups = (A + kWarps - 1) / kWarps, W = (A + groups - 1) / groups;
  const dim3 grid((N + kScen - 1) / kScen, groups);
  ilqr_forward_kernel<P><<<grid, W * kScen, smem, stream>>>(
      params, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks, us, xs, costs, N, T, A,
      xs_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ilqr_fwd

// us (A, N, T, m), xs (A, N, T+1, n), costs (A, N) from the plant index and
// its parameter floats p0..p7 (plants::kMaxParams, by value), Q (n, n), R (m, m), QF (n, n),
// goal (n), alphas (A), x0s (N, n), xs_nom (N, xs_rows, n) with
// xs_rows >= T, us_nom (N, T, m), ks (N, T, m), Ks (N, T, m, n); all fp32,
// row-major contiguous, on the device. n and m are the plant's; the caller
// checks the shapes against them. Returns the CUDA error code of the launch.
extern "C" int npt_ilqr_forward(int plant, float p0, float p1, float p2, float p3, float p4,
                                float p5, float p6, float p7, const float* Q, const float* R,
                                const float* QF, const float* goal, const float* alphas,
                                const float* x0s, const float* xs_nom, const float* us_nom,
                                const float* ks, const float* Ks, float* us, float* xs,
                                float* costs, int N, int T, int A, int xs_rows, void* stream) {
  using namespace ilqr_fwd;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (N < 1 || T < 0 || A < 1 || A > kMaxAlphas || xs_rows < T)
    return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant) {
#define NPT_CASE(P)                                                                          \
  case P:                                                                                    \
    return launch<P>(params, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks, us, xs, \
                     costs, N, T, A, xs_rows, st);
    NPT_CASE(0) NPT_CASE(1) NPT_CASE(2) NPT_CASE(3)
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
