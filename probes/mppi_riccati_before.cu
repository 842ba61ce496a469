// The fused MPPI (K13) and the fused per-scenario Riccati (K5) as they were
// before their redesign for the H100 (the first port of
// numpower_tpu_torch/csrc/mppi.cu mppi_kernel and riccati.cu riccati_kernel:
// one thread per sample, its eps rows staged by 4-byte cp.async, the cost
// weights in shared memory, the update's shuffle trees in every warp; 16
// lanes per scenario, lane i owning row i of P), unchanged but for the cycle
// stamps of probes/stamps.cuh at the end of each part.
// probes/mppi_riccati.py builds this file into its own library and times its
// parts beside those of the current kernels. Parts:
//   K13: 0 staging (the block's constants, each chunk's cp.async issue and
//        wait, for the rollout and again for the update), 1 the rollout
//        steps and the terminal cost, 2 the min reduction, 3 the weights'
//        sum reduction, 4 the ESS reduction and its store, 5 the update (the
//        shuffle trees, the warps' partials combined, the barriers),
//        6 the write-back of us;
//   K5:  0 staging (A, B, Q, R, P = QF), 1 PA and PB, 2 S = R + B'PB and its
//        factor, 3 K (B'PA, the two triangular solves, K' and Ks stored),
//        4 P' (the triangle, its mirror, the row read back), 5 the warp
//        syncs, 6 the write-back of P0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "../numpower_tpu_torch/csrc/plants.cuh"
#include "stamps.cuh"

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

  NPT_STAMP_BEGIN;
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
  NPT_WAIT(x0[0]);
  NPT_STAMP(0);

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
      NPT_STAMP(0);
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
      NPT_WAIT(x[0]);
      NPT_STAMP(1);
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
    NPT_WAIT(S);
    NPT_STAMP(1);

    // -- softmax weights over the samples, and the ESS --
    const float Smin = block_reduce(live ? S : CUDART_INF_F, red, Min());
    NPT_WAIT(Smin);
    NPT_STAMP(2);
    float w = live ? expf(mul(-sub(S, Smin), a.inv_lam)) : 0.0f;
    w = plants::dvd(w, block_reduce(w, red, Sum()));
    NPT_WAIT(w);
    NPT_STAMP(3);
    const float ss = block_reduce(mul(w, w), red, Sum());
    if (k == 0) a.ess[static_cast<size_t>(s) * a.iters + it] = plants::dvd(1.0f, ss);
    NPT_STAMP(4);

    // -- the update: sum_k w_k (cand_k - u_nom) per entry, warps then block --
    issue(it, 0);
    for (int c = 0; c < nchunks; ++c) {
      issue(it, c + 1);
      __pipeline_wait_prior(1);
      NPT_STAMP(0);
      const float* const buf = stage + (c & 1) * Tc * m * Kp + k;
      const int r0 = c * Tc * m, rows = min(Tc, a.T - c * Tc) * m;
      for (int q = 0; q < rows; ++q) {
        const float un = u_nom[r0 + q];
        float v = live ? mul(w, sub(clipu(add(un, buf[q * Kp]), a), un)) : 0.0f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
        if (lane == 0) part[warp * TM + r0 + q] = v;
      }
      NPT_STAMP(5);
    }
    __syncthreads();  // every warp's partials are written
    for (int r = k; r < TM; r += blockDim.x) {
      float du = part[r];
      for (int wp = 1; wp < nw; ++wp) du = add(du, part[wp * TM + r]);
      u_nom[r] = clipu(add(u_nom[r], du), a);
    }
    __syncthreads();  // the new nominal is in place for the next round
    NPT_STAMP(5);
  }
  for (int r = k; r < TM; r += blockDim.x) a.us[static_cast<size_t>(s) * TM + r] = u_nom[r];
  NPT_STAMP(6);
  NPT_STAMP_END;
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

#include <cuda_runtime.h>

namespace riccati {

constexpr int kMaxN = 16;
constexpr int kMaxM = 8;
constexpr int kGroup = 16;  // lanes per scenario (>= kMaxN)
constexpr int kScen = 8;    // scenarios per block
constexpr int kThreads = kGroup * kScen;
constexpr int kLd = 17;     // row stride of the n x n matrices in shared memory
constexpr int kLdm = 9;     // row stride of the n x m matrices

// Offsets in a scenario's slice of shared memory.
constexpr int kOffA = 0;
constexpr int kOffPA = kOffA + kMaxN * kLd;
constexpr int kOffPn = kOffPA + kMaxN * kLd;
constexpr int kOffB = kOffPn + kMaxN * kLd;
constexpr int kOffPB = kOffB + kMaxN * kLdm;
constexpr int kOffKt = kOffPB + kMaxN * kLdm;
// 1248 floats, padded to 16 mod 32 so the two groups of a warp use disjoint banks
constexpr int kScenFloats = kOffKt + kMaxN * kLdm + 16;
static_assert(kScenFloats % 32 == 16, "scenario slices must sit 16 banks apart");

template <int NB, int MB>
__global__ void __launch_bounds__(kThreads)
    riccati_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                   const float* __restrict__ Q, const float* __restrict__ R,
                   const float* __restrict__ QF, float* __restrict__ Ks,
                   float* __restrict__ P0, int N, int n, int m, int T) {
  __shared__ float q_s[kMaxN * kLd];
  __shared__ float r_s[kMaxM * kMaxM];
  __shared__ float scen[kScen * kScenFloats];

  NPT_STAMP_BEGIN;
  const int g = threadIdx.x / kGroup, i = threadIdx.x % kGroup;
  const int s_raw = blockIdx.x * kScen + g;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;  // a ragged tail recomputes a real scenario, stores nothing
  float* const A = scen + g * kScenFloats + kOffA;    // (NB, NB), ld kLd
  float* const PA = scen + g * kScenFloats + kOffPA;  // (NB, NB), ld kLd
  float* const Pn = scen + g * kScenFloats + kOffPn;  // (NB, NB), ld kLd
  float* const B = scen + g * kScenFloats + kOffB;    // (NB, MB), ld kLdm
  float* const PB = scen + g * kScenFloats + kOffPB;  // (NB, MB), ld kLdm
  float* const Kt = scen + g * kScenFloats + kOffKt;  // K' (NB, MB), ld kLdm

  // Stage the zero-padded matrices (R padded with the identity).
  for (int e = threadIdx.x; e < NB * NB; e += kThreads) {
    const int r = e / NB, c = e % NB;
    q_s[r * kLd + c] = (r < n && c < n) ? Q[r * n + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < MB * MB; e += kThreads) {
    const int r = e / MB, c = e % MB;
    r_s[r * MB + c] = (r < m && c < m) ? R[r * m + c] : (r == c ? 1.0f : 0.0f);
  }
  const float* Ag = As + static_cast<size_t>(s) * n * n;
  const float* Bg = Bs + static_cast<size_t>(s) * n * m;
  for (int e = i; e < NB * NB; e += kGroup) {
    const int r = e / NB, c = e % NB;
    A[r * kLd + c] = (r < n && c < n) ? Ag[r * n + c] : 0.0f;
  }
  for (int e = i; e < NB * MB; e += kGroup) {
    const int r = e / MB, c = e % MB;
    B[r * kLdm + c] = (r < n && c < m) ? Bg[r * m + c] : 0.0f;
  }
  __syncthreads();

  const bool row = i < NB;  // lanes past NB hold no row (NB < kGroup)
  float p[NB];              // row i of P
#pragma unroll
  for (int j = 0; j < NB; ++j) p[j] = (i < n && j < n) ? QF[i * n + j] : 0.0f;
  NPT_WAIT(p[0]);
  NPT_STAMP(0);

  for (int t = 0; t < T; ++t) {
    // Row i of PA = P A and of PB = P B.
    if (row) {
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(p[j], A[j * kLd + k], acc);
        PA[i * kLd + k] = acc;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(p[j], B[j * kLdm + a], acc);
        PB[i * kLdm + a] = acc;
      }
    }
    NPT_STAMP(1);
    __syncwarp();
    NPT_STAMP(5);

    // S = R + B'(PB), lower triangle, and its Cholesky factor, in every lane.
    float L[MB][MB], dinv[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(B[j * kLdm + a], PB[j * kLdm + b], acc);
        L[a][b] = acc + r_s[a * MB + b];
      }
    }
#pragma unroll
    for (int c = 0; c < MB; ++c) {
      float acc = L[c][c];
#pragma unroll
      for (int k = 0; k < c; ++k) acc -= L[c][k] * L[c][k];
      dinv[c] = rsqrtf(acc);
      L[c][c] = acc * dinv[c];
#pragma unroll
      for (int a = c + 1; a < MB; ++a) {
        float v = L[a][c];
#pragma unroll
        for (int k = 0; k < c; ++k) v -= L[a][k] * L[c][k];
        L[a][c] = v * dinv[c];
      }
    }
    NPT_WAIT(L[MB - 1][MB - 1]);
    NPT_STAMP(2);

    // Column i of K = S^{-1} (B'PA)[:, i], with (B'PA)[:, i] = B' PA[:, i].
    float btpa[MB];
    if (row) {
      float y[MB];
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(B[j * kLdm + a], PA[j * kLd + i], acc);
        btpa[a] = acc;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {  // forward: L y = btpa
        float v = btpa[a];
#pragma unroll
        for (int k = 0; k < a; ++k) v -= L[a][k] * y[k];
        y[a] = v * dinv[a];
      }
#pragma unroll
      for (int a = MB - 1; a >= 0; --a) {  // backward: L' k = y
        float v = y[a];
#pragma unroll
        for (int k = a + 1; k < MB; ++k) v -= L[k][a] * y[k];
        y[a] = v * dinv[a];
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) Kt[i * kLdm + a] = y[a];
      if (live && i < n) {
        float* Kout = Ks + (static_cast<size_t>(s) * T + (T - 1 - t)) * m * n + i;
#pragma unroll
        for (int a = 0; a < MB; ++a)
          if (a < m) Kout[static_cast<size_t>(a) * n] = y[a];
      }
    }
    NPT_STAMP(3);
    __syncwarp();
    NPT_STAMP(5);

    // Row i of P' on and above the diagonal, mirrored below it.
    if (row) {
      for (int k = i; k < NB; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(A[j * kLd + i], PA[j * kLd + k], acc);
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < MB; ++a) acc2 = fmaf(btpa[a], Kt[k * kLdm + a], acc2);
        const float v = acc - acc2 + q_s[i * kLd + k];
        Pn[i * kLd + k] = v;
        Pn[k * kLd + i] = v;
      }
    }
    NPT_STAMP(4);
    __syncwarp();
    NPT_STAMP(5);
    if (row) {
#pragma unroll
      for (int j = 0; j < NB; ++j) p[j] = Pn[i * kLd + j];
    }
    NPT_WAIT(p[NB - 1]);
    NPT_STAMP(4);
    __syncwarp();  // every read of PA, Kt and Pn is done before the next step writes them
    NPT_STAMP(5);
  }

  if (live && i < n) {
    float* out = P0 + static_cast<size_t>(s) * n * n + i * n;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) out[j] = p[j];
  }
  NPT_STAMP(6);
  NPT_STAMP_END;
}

template <int NB, int MB>
cudaError_t launch(const float* As, const float* Bs, const float* Q, const float* R,
                   const float* QF, float* Ks, float* P0, int N, int n, int m, int T,
                   cudaStream_t stream) {
  riccati_kernel<NB, MB><<<(N + kScen - 1) / kScen, kThreads, 0, stream>>>(
      As, Bs, Q, R, QF, Ks, P0, N, n, m, T);
  return cudaGetLastError();
}

// The smallest bucket that holds n (m).
inline int bucket_n(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : 16; }
inline int bucket_m(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

}  // namespace riccati

// Ks (N, T, m, n) and P0 (N, n, n) from As (N, n, n), Bs (N, n, m) and the
// shared Q (n, n), R (m, m), QF (n, n), all fp32, row-major contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int npt_riccati_fused(const float* As, const float* Bs, const float* Q,
                                 const float* R, const float* QF, float* Ks, float* P0,
                                 int N, int n, int m, int T, void* stream) {
  using namespace riccati;
  if (N < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bucket_n(n) * 16 + bucket_m(m)) {
#define NPT_CASE(NB, MB) \
  case NB * 16 + MB:     \
    return static_cast<int>(launch<NB, MB>(As, Bs, Q, R, QF, Ks, P0, N, n, m, T, st));
#define NPT_CASES_M(NB) NPT_CASE(NB, 1) NPT_CASE(NB, 2) NPT_CASE(NB, 4) NPT_CASE(NB, 8)
    NPT_CASES_M(4) NPT_CASES_M(8) NPT_CASES_M(12) NPT_CASES_M(16)
#undef NPT_CASES_M
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
