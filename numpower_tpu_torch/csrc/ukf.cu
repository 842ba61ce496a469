// Fused whole-horizon batched UKF (K12): one launch runs the unscented
// Kalman filter (Wan-Merwe sigma points) of every trajectory over the whole
// horizon, the plant and the measurement in the kernel.
//
// Replaces the TPU kernel numpower_tpu/kernels/ukf.py ukf_pallas
// (_ukf_kernel), in its order of operations (ukf.py:80-154):
//  1. 2n+1 sigma points x, x +- column i of S, S the row Cholesky of
//     c_sig 0.5 (P_ij + P_ji) plus a jitter of 1e-9 on the diagonal
//     (rsqrtf pivots, inverse diagonal cached; CUDA's rsqrtf is within
//     2 ulp of lax.rsqrt's exact value);
//  2. f at every point (the registered plant of csrc/plants.cuh); x_p the
//     wm-weighted sum, P_p the wc-weighted outer products plus Q (upper
//     triangle, mirrored);
//  3. the points redrawn from (x_p, P_p); h at each; y_p, S = the weighted
//     outer products plus R, Pxy the weighted cross products;
//  4. the row Cholesky of S, W = S^-1 Pxy' by forward and backward
//     substitution, x_f = x_p + W'v, P_f = P_p - W' S W (upper, mirrored),
//     and the Cholesky-whitened innovation log-density.
// The weights wm_0, wm_i, wc_0, wc_i and the spread c_sig 0.5 are folded in
// double on the host and rounded once, as the JAX package folds them in
// Python. It writes xs_f, xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n), ll (B,).
//
// Design: K11's (ekf.cu). One thread per trajectory, x, P and ll in
// registers, n, m, p compile-time; each sigma point is built and sent
// through f in registers as it is formed, so only the 2n+1 images are held
// (13 x 6 floats for the planar quadrotor, the largest registered plant),
// and the weighted differences are formed where they are used.
//
// What bounds it: the latency of one thread's chain of T steps (two
// Cholesky factorizations of n x n, 2n+1 plant evaluations with
// sinf/cosf, ~n^2 (2n+1) FMAs); the bytes are K11's, about a microsecond of
// HBM time at the bench's shape.

#include <cuda_runtime.h>

#include "plants.cuh"

namespace ukf {

constexpr int kBlock = 32;

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Weights {
  float wm0, wmi, wc0, wci;  // sigma-point weights: point 0, points 1..2n
  float c_half;              // c_sig * 0.5
  float jitter;              // added to the spread's diagonal
};

struct Args {
  const float *Q, *R, *P0, *x0s, *yss, *uss;
  float *xf, *xp, *Pf, *Pp, *ll;
  int B, T;
};

// Lower row Cholesky of the n x n M (lower triangle read) plus `jitter` on
// the diagonal; Linv[j] = 1 / L[j][j] by one rsqrtf per pivot.
template <int n>
__device__ __forceinline__ void chol_rows(const float (&M)[n][n], float jitter, float (&L)[n][n],
                                          float (&Linv)[n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float acc = M[j][j] + jitter;
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k];
    const float inv = rsqrtf(acc);
    L[j][j] = acc * inv;
    Linv[j] = inv;
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      float acc2 = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc2 = acc2 - L[i][k] * L[j][k];
      L[i][j] = acc2 * inv;
    }
  }
}

// The spread factor of the sigma points at covariance P.
template <int n>
__device__ __forceinline__ void spread(const float (&P)[n][n], const Weights& w,
                                       float (&S)[n][n]) {
  float M[n][n], Sinv[n];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) M[i][j] = w.c_half * (P[i][j] + P[j][i]);
  chol_rows<n>(M, w.jitter, S, Sinv);
}

// Sigma point k of (x, S): x, then x + column i of S, then x - column i.
template <int n>
__device__ __forceinline__ void sigma_point(int k, const float (&x)[n], const float (&S)[n][n],
                                            float (&pt)[n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (k == 0) {
      pt[j] = x[j];
    } else if (k <= n) {
      pt[j] = k - 1 <= j ? x[j] + S[j][k - 1] : x[j];
    } else {
      pt[j] = k - 1 - n <= j ? x[j] - S[j][k - 1 - n] : x[j];
    }
  }
}

template <int P, int H, int p>
__global__ void __launch_bounds__(kBlock) ukf_kernel(PlantParams params, Weights w, Args a) {
  using F = plants::Plant<P>;
  constexpr int n = F::n, m = F::m, K = 2 * n + 1;
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

    // 1-2. predict: every sigma point through f
    float S[n][n], fx[K][n];
    spread<n>(Pm, w, S);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float pt[n];
      sigma_point<n>(k, x, S, pt);
      F::step(pt, u, spar, fx[k]);
    }
    float xpv[n], Pp[n][n];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float acc = w.wm0 * fx[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + w.wmi * fx[k][j];
      xpv[j] = acc;
    }
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = i; j < n; ++j) {
        float acc = w.wc0 * (fx[0][i] - xpv[i]) * (fx[0][j] - xpv[j]);
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + w.wci * (fx[k][i] - xpv[i]) * (fx[k][j] - xpv[j]);
        acc = acc + sQ[i * n + j];
        Pp[i][j] = acc;
        Pp[j][i] = acc;
      }

    // 3. update: the points redrawn from (x_p, P_p), h at each
    float pts[K][n], hy[K][p];
    spread<n>(Pp, w, S);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sigma_point<n>(k, xpv, S, pts[k]);
      plants::Measure<H>::template eval<p>(pts[k], hy[k]);
    }
    float yp[p];
#pragma unroll
    for (int c = 0; c < p; ++c) {
      float acc = w.wm0 * hy[0][c];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + w.wmi * hy[k][c];
      yp[c] = acc;
    }
    float Sm[p][p], Pxy[n][p];
#pragma unroll
    for (int i = 0; i < p; ++i)
#pragma unroll
      for (int j = i; j < p; ++j) {
        float acc = w.wc0 * (hy[0][i] - yp[i]) * (hy[0][j] - yp[j]);
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + w.wci * (hy[k][i] - yp[i]) * (hy[k][j] - yp[j]);
        acc = acc + sR[i * p + j];
        Sm[i][j] = acc;
        Sm[j][i] = acc;
      }
#pragma unroll
    for (int j = 0; j < n; ++j)
#pragma unroll
      for (int c = 0; c < p; ++c) {
        float acc = w.wc0 * (pts[0][j] - xpv[j]) * (hy[0][c] - yp[c]);
#pragma unroll
        for (int k = 1; k < K; ++k)
          acc = acc + w.wci * (pts[k][j] - xpv[j]) * (hy[k][c] - yp[c]);
        Pxy[j][c] = acc;
      }

    // 4. W = S^-1 Pxy': forward (L G = Pxy'), then backward (L' W = G)
    float L[p][p], Linv[p];
    chol_rows<p>(Sm, 0.0f, L, Linv);
    float G[p][n], W[p][n];
#pragma unroll
    for (int i = 0; i < p; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = Pxy[j][i];
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
    float v[p];
#pragma unroll
    for (int c = 0; c < p; ++c) v[c] = y[c] - yp[c];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float acc = xpv[j];
#pragma unroll
      for (int c = 0; c < p; ++c) acc = acc + W[c][j] * v[c];
      x[j] = acc;
    }
    float SK[p][n];  // S W
#pragma unroll
    for (int i = 0; i < p; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = Sm[i][0] * W[0][j];
#pragma unroll
        for (int c = 1; c < p; ++c) acc = acc + Sm[i][c] * W[c][j];
        SK[i][j] = acc;
      }
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = i; j < n; ++j) {
        float acc = Pp[i][j];
#pragma unroll
        for (int c = 0; c < p; ++c) acc = acc - W[c][i] * SK[c][j];
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
  }
  a.ll[b] = ll;
}

template <int P, int H, int p>
int launch(const PlantParams& params, const Weights& w, const Args& a, cudaStream_t stream) {
  ukf_kernel<P, H, p><<<(a.B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(params, w, a);
  return static_cast<int>(cudaGetLastError());
}

// The measurement widths of plant P: p = 1 .. min(n, 4).
template <int P, int H>
int launch_p(int p, const PlantParams& params, const Weights& w, const Args& a, cudaStream_t st) {
  constexpr int n = plants::Plant<P>::n;
  switch (p) {
    case 1:
      return launch<P, H, 1>(params, w, a, st);
    case 2:
      if constexpr (n >= 2) return launch<P, H, 2>(params, w, a, st);
      break;
    case 3:
      if constexpr (n >= 3) return launch<P, H, 3>(params, w, a, st);
      break;
    case 4:
      if constexpr (n >= 4) return launch<P, H, 4>(params, w, a, st);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ukf

// As npt_ekf (ekf.cu), plus the sigma-point weights wm0, wmi, wc0, wci, the
// spread c_half = c_sig * 0.5 and the jitter. Returns the CUDA error code.
extern "C" int npt_ukf(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                       float p6, float p7, int measure, int p, float wm0, float wmi, float wc0,
                       float wci, float c_half, float jitter, const float* Q, const float* R,
                       const float* P0, const float* x0s, const float* yss, const float* uss,
                       float* xf, float* xp, float* Pf, float* Pp, float* ll, int B, int T,
                       void* stream) {
  using namespace ukf;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (B < 1 || T < 1 || measure != 0) return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const Weights w{wm0, wmi, wc0, wci, c_half, jitter};
  const Args a{Q, R, P0, x0s, yss, uss, xf, xp, Pf, Pp, ll, B, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case 0: return launch_p<0, 0>(p, params, w, a, st);
    case 1: return launch_p<1, 0>(p, params, w, a, st);
    case 2: return launch_p<2, 0>(p, params, w, a, st);
    case 3: return launch_p<3, 0>(p, params, w, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
