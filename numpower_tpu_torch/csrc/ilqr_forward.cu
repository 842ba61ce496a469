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
// w = Q_ij (i = j) or 2 Q_ij (j > i), stage cost before the step. It writes
// us (A, N, T, m), xs (A, N, T+1, n) and costs (A, N); the argmin over
// alphas stays outside, as in the JAX package.
//
// Design. One thread per (alpha, scenario): its state, its control and its
// cost stay in registers for the whole horizon, and n, m are the plant's
// compile-time constants (plants.cuh), so every loop unrolls. A block holds
// kScen = 32 scenarios (the lanes of a warp) and one warp per alpha, so an
// alpha is uniform across a warp. The nominal trajectory and the gains are
// read once per scenario, as the TPU kernel does, for all alphas: the
// block stages a chunk of Tc steps of them in shared memory with cp.async,
// each scenario's rows of a chunk being one contiguous run in device
// memory, so the loads coalesce. The outputs of a chunk go to shared memory
// and are written back the same way, one contiguous run per (alpha,
// scenario). Every per-scenario row has an odd stride, so the 32 lanes of a
// warp hit 32 banks.
//
// What bounds it: the latency of one thread's chain of T dependent steps
// (feedback, cost, plant with sinf/cosf), not device memory (the nominal is
// read once, the outputs written once). At config #3b's N = 256 and six
// alphas the grid is 8 blocks of 6 warps: the chain, not the SM count,
// sets the time (on the H100, ~1.5 us per step of the cartpole, the same
// from N = 32 to 4096).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "plants.cuh"

namespace ilqr_fwd {

constexpr int kScen = 32;      // scenarios per block: the lanes of a warp
constexpr int kMaxAlphas = 32;  // warps per block
constexpr int kMaxTc = 16;      // steps per staged chunk
constexpr size_t kSmemBudget = 96 * 1024;

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Shape {
  int Tc;      // steps per chunk
  int in_ld;   // floats per scenario of the staged inputs (odd)
  int out_ld;  // floats per (alpha, scenario) of the staged outputs (odd)
};

// Floats of shared memory: weights, goal, alphas and parameters, then the
// staged inputs and outputs.
inline int head_floats(int n, int m, int A) { return 2 * n * n + m * m + n + A + plants::kMaxParams; }
inline size_t smem_bytes(int n, int m, int A, const Shape& sh) {
  return sizeof(float) * (static_cast<size_t>(head_floats(n, m, A)) + kScen * sh.in_ld +
                          static_cast<size_t>(A) * kScen * sh.out_ld);
}
inline Shape shape_for(int n, int m, int A, int T) {
  Shape sh{};
  for (int Tc = kMaxTc; Tc >= 1; --Tc) {
    sh.Tc = Tc;
    sh.in_ld = (Tc * (n + 2 * m + m * n)) | 1;
    sh.out_ld = (Tc * (n + m)) | 1;
    if (Tc <= (T > 0 ? T : 1) && smem_bytes(n, m, A, sh) <= kSmemBudget) break;
  }
  return sh;
}

template <int P>
__global__ void __launch_bounds__(kMaxAlphas * kScen)
    ilqr_forward_kernel(PlantParams params, const float* __restrict__ Q,
                        const float* __restrict__ R, const float* __restrict__ QF,
                        const float* __restrict__ goal, const float* __restrict__ alphas,
                        const float* __restrict__ x0s, const float* __restrict__ xs_nom,
                        const float* __restrict__ us_nom, const float* __restrict__ ks,
                        const float* __restrict__ Ks, float* __restrict__ us,
                        float* __restrict__ xs, float* __restrict__ costs, int N, int T, int A,
                        int xs_rows, Shape sh) {
  using F = plants::Plant<P>;
  constexpr int n = F::n, m = F::m;
  extern __shared__ __align__(16) float smem[];
  float* const wQ = smem;          // (n, n): Q_ij on the diagonal, 2 Q_ij above, 0 below
  float* const wQF = wQ + n * n;   // (n, n): the same for QF
  float* const wR = wQF + n * n;   // (m, m): the same for R
  float* const goal_s = wR + m * m;
  float* const alpha_s = goal_s + n;
  float* const par_s = alpha_s + A;
  float* const in_s = par_s + plants::kMaxParams;  // (kScen, in_ld)
  float* const out_s = in_s + kScen * sh.in_ld;     // (A, kScen, out_ld)
  const int Tc = sh.Tc;
  // Offsets in a scenario's staged inputs: x_nom, u_nom, k, K of the chunk.
  const int o_u = Tc * n, o_k = Tc * (n + m), o_K = Tc * (n + 2 * m);

  const int lane = threadIdx.x % kScen, a = threadIdx.x / kScen;
  const int s0 = blockIdx.x * kScen;
  const int s = s0 + lane;
  const bool live = s < N;

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
  for (int e = threadIdx.x; e < A; e += blockDim.x) alpha_s[e] = alphas[e];
  for (int e = threadIdx.x; e < plants::kMaxParams; e += blockDim.x) par_s[e] = params.v[e];

  float x[n];
  const size_t out_row = static_cast<size_t>(a) * N + s;  // (alpha, scenario)
#pragma unroll
  for (int j = 0; j < n; ++j) x[j] = live ? x0s[static_cast<size_t>(s) * n + j] : 0.0f;
  if (live) {
#pragma unroll
    for (int j = 0; j < n; ++j) xs[out_row * (T + 1) * n + j] = x[j];
  }
  float cost = 0.0f;

  for (int t0 = 0; t0 < T; t0 += Tc) {
    const int steps = min(Tc, T - t0);
    __syncthreads();  // the head is staged; the last chunk's outputs are written back
    // Stage the chunk's nominal rows: per scenario one contiguous run of each
    // array, neighbouring threads on neighbouring floats of a run.
    {
      const int per = steps * (n + 2 * m + m * n);
      const int live_scen = min(kScen, N - s0);
      for (int idx = threadIdx.x; idx < live_scen * per; idx += blockDim.x) {
        const int sc = idx / per;
        int e = idx - sc * per;
        const size_t ss = static_cast<size_t>(s0 + sc);
        float* dst = in_s + sc * sh.in_ld;
        const float* src;
        if (e < steps * n) {
          src = xs_nom + (ss * xs_rows + t0) * n + e;
        } else if ((e -= steps * n) < steps * m) {
          src = us_nom + (ss * T + t0) * m + e;
          dst += o_u;
        } else if ((e -= steps * m) < steps * m) {
          src = ks + (ss * T + t0) * m + e;
          dst += o_k;
        } else {
          e -= steps * m;
          src = Ks + (ss * T + t0) * m * n + e;
          dst += o_K;
        }
        // asynchronous, so a thread's copies are all in flight at once
        __pipeline_memcpy_async(dst + e, src, sizeof(float));
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    const float alpha = alpha_s[a];
    const float* const my_in = in_s + lane * sh.in_ld;
    float* const my_out = out_s + (a * kScen + lane) * sh.out_ld;
    for (int tt = 0; tt < steps; ++tt) {
      const float* xn = my_in + tt * n;
      const float* un = my_in + o_u + tt * m;
      const float* kk = my_in + o_k + tt * m;
      const float* KK = my_in + o_K + tt * m * n;
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
      F::step(x, u, par_s, xnext);
#pragma unroll
      for (int j = 0; j < n; ++j) x[j] = xnext[j];
#pragma unroll
      for (int b = 0; b < m; ++b) my_out[tt * m + b] = u[b];
#pragma unroll
      for (int j = 0; j < n; ++j) my_out[steps * m + tt * n + j] = x[j];
    }
    __syncthreads();

    // Write the chunk back: per (alpha, scenario) one run of us and one of
    // xs, neighbouring threads on neighbouring floats of a run.
    {
      const int per = steps * (m + n);
      for (int idx = threadIdx.x; idx < A * kScen * per; idx += blockDim.x) {
        const int r = idx / per, e = idx - r * per;
        const int rs = s0 + r % kScen;
        if (rs >= N) continue;
        const size_t row = static_cast<size_t>(r / kScen) * N + rs;
        const float v = out_s[r * sh.out_ld + e];
        if (e < steps * m)
          us[(row * T + t0) * m + e] = v;
        else
          xs[(row * (T + 1) + 1 + t0) * n + (e - steps * m)] = v;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float di = x[i] - goal_s[i];
#pragma unroll
    for (int j = i; j < n; ++j) cost = cost + wQF[i * n + j] * di * (x[j] - goal_s[j]);
  }
  if (live) costs[out_row] = cost;
}

template <int P>
int launch(const PlantParams& params, const float* Q, const float* R, const float* QF,
           const float* goal, const float* alphas, const float* x0s, const float* xs_nom,
           const float* us_nom, const float* ks, const float* Ks, float* us, float* xs,
           float* costs, int N, int T, int A, int xs_rows, cudaStream_t stream) {
  constexpr int n = plants::Plant<P>::n, m = plants::Plant<P>::m;
  const Shape sh = shape_for(n, m, A, T);
  const size_t smem = smem_bytes(n, m, A, sh);
  cudaError_t err = cudaFuncSetAttribute(ilqr_forward_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ilqr_forward_kernel<P><<<(N + kScen - 1) / kScen, A * kScen, smem, stream>>>(
      params, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks, us, xs, costs, N, T, A,
      xs_rows, sh);
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
