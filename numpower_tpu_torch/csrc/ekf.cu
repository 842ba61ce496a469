// Fused whole-horizon batched EKF (K11): one launch runs the extended
// Kalman filter of every trajectory over the whole horizon, the plant and
// the measurement in the kernel.
//
// Replaces the TPU kernel numpower_tpu/kernels/ekf.py ekf_pallas
// (_ekf_kernel), in its order of operations:
//  1. n forward-mode derivatives of the plant at the filtered state, one per
//     basis tangent: column i of A = df/dx; the first one's value is the
//     prediction x_p (the TPU kernel's jax.jvp calls, ekf.py:53-64);
//  2. P_p = A P A' + Q, its upper triangle computed and mirrored;
//  3. n derivatives of the measurement at x_p: C = dh/dx and h(x_p);
//  4. S = C P_p C' + R (upper triangle, mirrored), its row Cholesky with the
//     inverse diagonal cached (rsqrtf, where the TPU kernel has lax.rsqrt;
//     CUDA's rsqrtf is within 2 ulp);
//  5. W = S^-1 C P_p by forward and backward substitution;
//  6. x_f = x_p + W'v, P_f = P_p - W' C P_p (upper triangle, mirrored: no
//     0.5 (P + P') as models/estimation.ekf_filter takes), and the
//     Cholesky-whitened innovation log-density.
// It writes xs_f, xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n) and ll (B,), the
// JAX package's layout.
//
// The derivatives. CUDA cannot trace a torch function, so the plant and the
// measurement are the registered device twins of csrc/plants.cuh, run on
// plants::Dual numbers: the value and one tangent, with JAX's jvp rules
// per operation (plants.cuh). The value part is the float plant operation
// for operation, so x_p is f(x, u) exactly as K8 computes it.
//
// Design. One thread per trajectory: x, P (n x n) and ll in registers for
// the whole horizon, n, m (the plant's) and p compile-time, so everything
// unrolls. The next step's u and y are loaded while the current step
// computes, so the chain does not wait on device memory. Blocks of one
// warp spread a batch of 1024 over 32 SMs.
//
// What bounds it: the latency of one thread's chain of T dependent steps
// (2n plant and measurement evaluations on dual numbers, ~n^3 FMAs, p
// rsqrtf and logf); the bytes (the four (B, T, .) outputs, ~1.3 MB at the
// bench's B = 1024, T = 50, n = 2) are about a microsecond of HBM time. The
// covariance stores are each thread's own contiguous n x n block per step
// (uncoalesced across the warp; the L2 merges them before device memory).

#include <cuda_runtime.h>

#include "plants.cuh"

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
  using plants::Dual;
  constexpr int n = F::n, m = F::m;
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

    // 1. A columns and the prediction by n forward-mode passes of f
    float A[n][n], xpv[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      Dual xd[n], fd[n];
#pragma unroll
      for (int j = 0; j < n; ++j) xd[j] = Dual{x[j], j == i ? 1.0f : 0.0f};
      F::step(xd, u, spar, fd);
#pragma unroll
      for (int j = 0; j < n; ++j) {
        A[j][i] = fd[j].t;
        if (i == 0) xpv[j] = fd[j].v;
      }
    }
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
    // 3. C columns and h(x_p) by n forward-mode passes of h
    float Cm[p][n], yhat[p];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      Dual xd[n], hd[p];
#pragma unroll
      for (int j = 0; j < n; ++j) xd[j] = Dual{xpv[j], j == i ? 1.0f : 0.0f};
      plants::Measure<H>::template eval<p>(xd, hd);
#pragma unroll
      for (int c = 0; c < p; ++c) {
        Cm[c][i] = hd[c].t;
        if (i == 0) yhat[c] = hd[c].v;
      }
    }
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
