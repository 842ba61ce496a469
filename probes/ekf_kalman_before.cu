// The fused batched EKF (K11) and the batched Kalman mean pass (K9) as they
// were before their redesign for the H100 (the first port of
// numpower_tpu_torch/csrc/ekf.cu ekf_kernel and kalman_mean.cu
// kalman_mean_kernel: K11 one thread a trajectory, one warp a block, n
// single-tangent plant passes and n measurement passes a step, the next
// step's inputs loaded one step ahead, every output a scattered 4-byte
// store; K9 one thread a trajectory, 64 a block, the horizon staged in
// chunks of min(64, T) steps, the gains by 4-byte loads, the y/u rows by
// 4-byte cp.async, waited for in full before the chunk's first step),
// unchanged but for the cycle stamps of probes/stamps.cuh at the end of
// each part (and K11's dual number, csrc/plants.cuh's Dual<1>: the same
// operations as the first port's single-tangent one). probes/ekf_kalman.py builds this file into its own library and
// times its parts beside those of the current kernels. Parts:
//   K11: 0 the n plant passes (A and x_p; the wait for the step's inputs
//        lands here), 1 P_p = A P A' + Q, 2 the n measurement passes (C and
//        h(x_p)), 3 S = C P_p C' + R and its factor, 4 the substitutions,
//        x_f, P_f and the log-density, 5 the stores, 6 the set-up and each
//        step's input loads (loaded one step ahead, not waited for);
//   K9:  0 A and C into shared memory and x0, 1 the gains' staging (and the
//        barrier before it), 2 the y/u staging and its wait, 3 the chain of
//        a step, 4 its stores.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "../numpower_tpu_torch/csrc/plants.cuh"
#include "stamps.cuh"


namespace ekf {

constexpr int kBlock = 32;

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Args {
  const float *Q, *R, *P0, *x0s, *yss, *uss;
  float *xf, *xp, *Pf, *Pp, *ll;
  int B, T;
};

template <int P, int H, int p>
__global__ void __launch_bounds__(kBlock) ekf_kernel(PlantParams params, Args a) {
  using F = plants::Plant<P>;
  using Dual = plants::Dual<1>;  // the single-tangent dual number of the first port
  constexpr int n = F::n, m = F::m;
  NPT_STAMP_BEGIN;
  __shared__ float sQ[n * n], sR[p * p], sP0[n * n], spar[plants::kMaxParams];
  for (int e = threadIdx.x; e < n * n; e += kBlock) {
    sQ[e] = a.Q[e];
    sP0[e] = a.P0[e];
  }
  for (int e = threadIdx.x; e < p * p; e += kBlock) sR[e] = a.R[e];
  for (int e = threadIdx.x; e < plants::kMaxParams; e += kBlock) spar[e] = params.v[e];
  __syncthreads();
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= a.B) return;
  const int T = a.T;
  const float* ub = a.uss + static_cast<size_t>(b) * T * m;
  const float* yb = a.yss + static_cast<size_t>(b) * T * p;
  const float c0 = static_cast<float>(p) * logf(6.28318530717958647692f);

  float x[n], Pm[n][n];
#pragma unroll
  for (int j = 0; j < n; ++j) x[j] = a.x0s[static_cast<size_t>(b) * n + j];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) Pm[i][j] = sP0[i * n + j];
  float ll = 0.0f;
  float u_nx[m], y_nx[p];
#pragma unroll
  for (int k = 0; k < m; ++k) u_nx[k] = ub[k];
#pragma unroll
  for (int c = 0; c < p; ++c) y_nx[c] = yb[c];

  NPT_WAIT(x[0] + Pm[0][0] + u_nx[0] + y_nx[0]);
  NPT_STAMP(6);
  for (int t = 0; t < T; ++t) {
    float u[m], y[p];
#pragma unroll
    for (int k = 0; k < m; ++k) u[k] = u_nx[k];
#pragma unroll
    for (int c = 0; c < p; ++c) y[c] = y_nx[c];
    if (t + 1 < T) {  // the next step's inputs, in flight while this step computes
#pragma unroll
      for (int k = 0; k < m; ++k) u_nx[k] = ub[(t + 1) * m + k];
#pragma unroll
      for (int c = 0; c < p; ++c) y_nx[c] = yb[(t + 1) * p + c];
    }

    NPT_STAMP(6);
    // 1. A columns and the prediction by n forward-mode passes of f
    float A[n][n], xpv[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      Dual xd[n], fd[n];
#pragma unroll
      for (int j = 0; j < n; ++j) xd[j] = Dual{x[j], {j == i ? 1.0f : 0.0f}};
      F::step(xd, u, spar, fd);
#pragma unroll
      for (int j = 0; j < n; ++j) {
        A[j][i] = fd[j].t[0];
        if (i == 0) xpv[j] = fd[j].v;
      }
    }
    NPT_STAMP(0);
    // 2. P_p = A P A' + Q
    float AP[n][n], Pp[n][n];
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int l = 0; l < n; ++l) {
        float acc = A[i][0] * Pm[0][l];
#pragma unroll
        for (int k = 1; k < n; ++k) acc = acc + A[i][k] * Pm[k][l];
        AP[i][l] = acc;
      }
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = i; j < n; ++j) {
        float acc = AP[i][0] * A[j][0];
#pragma unroll
        for (int l = 1; l < n; ++l) acc = acc + AP[i][l] * A[j][l];
        acc = acc + sQ[i * n + j];
        Pp[i][j] = acc;
        Pp[j][i] = acc;
      }
    NPT_STAMP(1);
    // 3. C columns and h(x_p) by n forward-mode passes of h
    float Cm[p][n], yhat[p];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      Dual xd[n], hd[p];
#pragma unroll
      for (int j = 0; j < n; ++j) xd[j] = Dual{xpv[j], {j == i ? 1.0f : 0.0f}};
      plants::Measure<H>::template eval<p>(xd, hd);
#pragma unroll
      for (int c = 0; c < p; ++c) {
        Cm[c][i] = hd[c].t[0];
        if (i == 0) yhat[c] = hd[c].v;
      }
    }
    NPT_STAMP(2);
    // 4. S = C P_p C' + R and its row Cholesky
    float CP[p][n], S[p][p];
#pragma unroll
    for (int c = 0; c < p; ++c)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = Cm[c][0] * Pp[0][j];
#pragma unroll
        for (int k = 1; k < n; ++k) acc = acc + Cm[c][k] * Pp[k][j];
        CP[c][j] = acc;
      }
#pragma unroll
    for (int i = 0; i < p; ++i)
#pragma unroll
      for (int j = i; j < p; ++j) {
        float acc = CP[i][0] * Cm[j][0];
#pragma unroll
        for (int k = 1; k < n; ++k) acc = acc + CP[i][k] * Cm[j][k];
        acc = acc + sR[i * p + j];
        S[i][j] = acc;
        S[j][i] = acc;
      }
    float L[p][p], Linv[p];
#pragma unroll
    for (int j = 0; j < p; ++j) {
      float acc = S[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k];
      const float inv = rsqrtf(acc);
      L[j][j] = acc * inv;
      Linv[j] = inv;
#pragma unroll
      for (int i = j + 1; i < p; ++i) {
        float acc2 = S[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc2 = acc2 - L[i][k] * L[j][k];
        L[i][j] = acc2 * inv;
      }
    }
    NPT_STAMP(3);
    // 5. W = S^-1 CP: forward (L G = CP), then backward (L' W = G)
    float G[p][n], W[p][n];
#pragma unroll
    for (int i = 0; i < p; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = CP[i][j];
#pragma unroll
        for (int k = 0; k < i; ++k) acc = acc - L[i][k] * G[k][j];
        G[i][j] = acc * Linv[i];
      }
#pragma unroll
    for (int i = p - 1; i >= 0; --i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = G[i][j];
#pragma unroll
        for (int k = i + 1; k < p; ++k) acc = acc - L[k][i] * W[k][j];
        W[i][j] = acc * Linv[i];
      }
    // 6. the update and the innovation log-density
    float v[p];
#pragma unroll
    for (int c = 0; c < p; ++c) v[c] = y[c] - yhat[c];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float acc = xpv[j];
#pragma unroll
      for (int c = 0; c < p; ++c) acc = acc + W[c][j] * v[c];
      x[j] = acc;
    }
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = i; j < n; ++j) {
        float acc = Pp[i][j];
#pragma unroll
        for (int c = 0; c < p; ++c) acc = acc - W[c][i] * CP[c][j];
        Pm[i][j] = acc;
        Pm[j][i] = acc;
      }
    float sq = 0.0f, logdet = 0.0f;
    float al[p];
#pragma unroll
    for (int i = 0; i < p; ++i) {
      float acc = v[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - L[i][k] * al[k];
      al[i] = acc * Linv[i];
      sq = sq + al[i] * al[i];
      logdet = logdet + logf(L[i][i]);
    }
    ll = ll - 0.5f * (sq + c0) - logdet;

    NPT_STAMP(4);
    const size_t row = static_cast<size_t>(b) * T + t;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      a.xf[row * n + j] = x[j];
      a.xp[row * n + j] = xpv[j];
    }
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        a.Pf[(row * n + i) * n + j] = Pm[i][j];
        a.Pp[(row * n + i) * n + j] = Pp[i][j];
      }
    NPT_STAMP(5);
  }
  a.ll[b] = ll;
  NPT_STAMP_END;
}

template <int P, int H, int p>
int launch(const PlantParams& params, const Args& a, cudaStream_t stream) {
  ekf_kernel<P, H, p><<<(a.B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(params, a);
  return static_cast<int>(cudaGetLastError());
}

// The measurement widths of plant P: p = 1 .. min(n, 4).
template <int P, int H>
int launch_p(int p, const PlantParams& params, const Args& a, cudaStream_t st) {
  constexpr int n = plants::Plant<P>::n;
  switch (p) {
    case 1:
      return launch<P, H, 1>(params, a, st);
    case 2:
      if constexpr (n >= 2) return launch<P, H, 2>(params, a, st);
      break;
    case 3:
      if constexpr (n >= 3) return launch<P, H, 3>(params, a, st);
      break;
    case 4:
      if constexpr (n >= 4) return launch<P, H, 4>(params, a, st);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ekf

// xs_f, xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n), ll (B,) from the plant index
// and its parameter floats p0..p7, the measurement index and its width p
// (1..4, <= n), Q (n, n), R (p, p), P0 (n, n), x0s (B, n), yss (B, T, p),
// uss (B, T, m); all fp32, row-major contiguous, on the device; n and m are
// the plant's. Returns the CUDA error code of the launch.
extern "C" int npt_ekf(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                       float p6, float p7, int measure, int p, const float* Q, const float* R,
                       const float* P0, const float* x0s, const float* yss, const float* uss,
                       float* xf, float* xp, float* Pf, float* Pp, float* ll, int B, int T,
                       void* stream) {
  using namespace ekf;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (B < 1 || T < 1 || measure != 0) return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const Args a{Q, R, P0, x0s, yss, uss, xf, xp, Pf, Pp, ll, B, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case 0: return launch_p<0, 0>(p, params, a, st);
    case 1: return launch_p<1, 0>(p, params, a, st);
    case 2: return launch_p<2, 0>(p, params, a, st);
    case 3: return launch_p<3, 0>(p, params, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


namespace kalman_mean {

constexpr int kBlock = 64;  // trajectories per block, one thread each
constexpr int kMaxTc = 64;  // steps per staged chunk
constexpr size_t kSmemBudget = 96 * 1024;

struct Shape {
  int Tc;    // steps per chunk
  int gain;  // floats of one step's gains: W (PB x NB), invL (PB x PB), cst
};

inline size_t smem_floats(int NB, int PB, int n, int p, bool has_u, const Shape& sh) {
  const size_t step = sh.gain + static_cast<size_t>(kBlock) * (p + (has_u ? n : 0));
  return static_cast<size_t>(NB) * NB + static_cast<size_t>(PB) * NB + sh.Tc * step;
}

inline Shape shape_for(int NB, int PB, int n, int p, bool has_u, int T) {
  Shape sh{1, PB * NB + PB * PB + 1};
  for (int Tc = kMaxTc; Tc >= 1; --Tc) {
    sh.Tc = Tc;
    const size_t bytes = smem_floats(NB, PB, n, p, has_u, sh) * sizeof(float);
    if (Tc <= (T > 0 ? T : 1) && bytes <= kSmemBudget) break;
  }
  return sh;
}

template <int NB, int PB>
__global__ void __launch_bounds__(kBlock)
    kalman_mean_kernel(const float* __restrict__ A, const float* __restrict__ C,
                       const float* __restrict__ W, const float* __restrict__ iL,
                       const float* __restrict__ cst, const float* __restrict__ x0s,
                       const float* __restrict__ ys, const float* __restrict__ us,
                       float* __restrict__ xf, float* __restrict__ xp, float* __restrict__ ll_out,
                       int N, int T, int n, int p, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  NPT_STAMP_BEGIN;
  float* const sA = smem;            // (NB, NB), zero-padded
  float* const sC = sA + NB * NB;    // (PB, NB)
  float* const sG = sC + PB * NB;    // (Tc, gain): W_t (PB, NB), invL_t (PB, PB), cst_t
  float* const sY = sG + sh.Tc * sh.gain;         // (Tc, kBlock, p)
  float* const sU = sY + sh.Tc * kBlock * p;      // (Tc, kBlock, n) when us is given
  constexpr int oL = PB * NB, oc = PB * NB + PB * PB;
  const bool has_u = us != nullptr;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kBlock, s = s0 + tid;
  const int live = min(kBlock, N - s0);

  for (int e = tid; e < NB * NB; e += kBlock) {
    const int r = e / NB, c = e % NB;
    sA[e] = (r < n && c < n) ? A[r * n + c] : 0.0f;
  }
  for (int e = tid; e < PB * NB; e += kBlock) {
    const int r = e / NB, c = e % NB;
    sC[e] = (r < p && c < n) ? C[r * n + c] : 0.0f;
  }
  float x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) x[j] = (s < N && j < n) ? x0s[static_cast<size_t>(s) * n + j] : 0.0f;
  float ll = 0.0f;
  NPT_WAIT(x[0]);
  NPT_STAMP(0);

  for (int t0 = 0; t0 < T; t0 += sh.Tc) {
    const int steps = min(sh.Tc, T - t0);
    __syncthreads();  // the last chunk is consumed (and A, C are staged)
    for (int e = tid; e < steps * sh.gain; e += kBlock) {
      const int tt = e / sh.gain, k = e - tt * sh.gain, t = t0 + tt;
      float v = 0.0f;
      if (k < oL) {
        const int c = k / NB, j = k % NB;
        if (c < p && j < n) v = W[(static_cast<size_t>(t) * p + c) * n + j];
      } else if (k < oc) {
        const int c = (k - oL) / PB, f = (k - oL) % PB;
        if (c < p && f < p) v = iL[(static_cast<size_t>(t) * p + c) * p + f];
      } else {
        v = cst[t];
      }
      sG[e] = v;
    }
    NPT_STAMP(1);
    // the block's rows of y_t (and u_t): one contiguous run per step
    for (int e = tid; e < steps * live * p; e += kBlock) {
      const int tt = e / (live * p), r = e - tt * live * p;
      __pipeline_memcpy_async(sY + tt * kBlock * p + r,
                              ys + (static_cast<size_t>(t0 + tt) * N + s0) * p + r, sizeof(float));
    }
    if (has_u) {
      for (int e = tid; e < steps * live * n; e += kBlock) {
        const int tt = e / (live * n), r = e - tt * live * n;
        __pipeline_memcpy_async(sU + tt * kBlock * n + r,
                                us + (static_cast<size_t>(t0 + tt) * N + s0) * n + r,
                                sizeof(float));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    NPT_STAMP(2);

    for (int tt = 0; tt < steps; ++tt) {
      const float* g = sG + tt * sh.gain;
      float xpv[NB], v[PB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {  // x_p = A x + u
        float acc = sA[j * NB] * x[0];
#pragma unroll
        for (int i = 1; i < NB; ++i) acc = acc + sA[j * NB + i] * x[i];
        if (has_u && j < n) acc = acc + sU[(tt * kBlock + tid) * n + j];
        xpv[j] = acc;
      }
#pragma unroll
      for (int c = 0; c < PB; ++c) {  // v = y - C x_p
        float acc = c < p ? sY[(tt * kBlock + tid) * p + c] : 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = acc - sC[c * NB + j] * xpv[j];
        v[c] = acc;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {  // x_f = x_p + v W
        float acc = xpv[j];
#pragma unroll
        for (int c = 0; c < PB; ++c) acc = acc + g[c * NB + j] * v[c];
        x[j] = acc;
      }
      float sq = 0.0f;  // |invL v|^2
#pragma unroll
      for (int c = 0; c < PB; ++c) {
        float a = g[oL + c * PB] * v[0];
#pragma unroll
        for (int f = 1; f < PB; ++f) a = a + g[oL + c * PB + f] * v[f];
        sq = sq + a * a;
      }
      ll = ll - 0.5f * sq - g[oc];
      NPT_STAMP(3);
      if (s < N) {
        const size_t row = (static_cast<size_t>(t0 + tt) * N + s) * n;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (j < n) {
            xf[row + j] = x[j];
            xp[row + j] = xpv[j];
          }
        }
      }
      NPT_STAMP(4);
    }
  }
  if (s < N) ll_out[s] = ll;
  NPT_STAMP_END;
}

template <int NB, int PB>
int launch(const float* A, const float* C, const float* W, const float* iL, const float* cst,
           const float* x0s, const float* ys, const float* us, float* xf, float* xp, float* ll,
           int N, int T, int n, int p, cudaStream_t stream) {
  const Shape sh = shape_for(NB, PB, n, p, us != nullptr, T);
  const size_t smem = smem_floats(NB, PB, n, p, us != nullptr, sh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kalman_mean_kernel<NB, PB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kalman_mean_kernel<NB, PB><<<(N + kBlock - 1) / kBlock, kBlock, smem, stream>>>(
      A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_p(const float* A, const float* C, const float* W, const float* iL, const float* cst,
             const float* x0s, const float* ys, const float* us, float* xf, float* xp, float* ll,
             int N, int T, int n, int p, cudaStream_t st) {
  if (p <= 1) return launch<NB, 1>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (p <= 2) return launch<NB, 2>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (p <= 4) return launch<NB, 4>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  return launch<NB, 8>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
}

}  // namespace kalman_mean

// xs_f, xs_p (T, N, n) and ll (N,) from A (n, n), C (p, n), W (T, p, n),
// invL (T, p, p), cst (T,), x0s (N, n), ys (T, N, p) and us (T, N, n) or
// null; all fp32, row-major contiguous, on the device; 1 <= n <= 16,
// 1 <= p <= 8. Returns the CUDA error code of the launch.
extern "C" int npt_kalman_mean(const float* A, const float* C, const float* W, const float* iL,
                               const float* cst, const float* x0s, const float* ys,
                               const float* us, float* xf, float* xp, float* ll, int N, int T,
                               int n, int p, void* stream) {
  using namespace kalman_mean;
  if (N < 1 || T < 1 || n < 1 || n > 16 || p < 1 || p > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 2) return launch_p<2>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (n <= 4) return launch_p<4>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (n <= 8) return launch_p<8>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  return launch_p<16>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
}
