// The batched Cholesky (K6a) and the fused batched UKF (K12) as they were
// before their redesign for the H100 (the first port of
// numpower_tpu_torch/csrc/cholesky.cu cholesky_kernel and ukf.cu ukf_kernel:
// K6a one matrix a thread, one warp a block, the tile staged and written back
// by 4-byte loops; K12 one thread a trajectory, one warp a block, every
// output a scattered 4-byte store), unchanged but for the cycle stamps of
// probes/stamps.cuh at the end of each part. probes/chol_ukf.py builds this
// file into its own library and times its parts beside those of the current
// kernels. Parts:
//   K6a: 0 staging (the 4-byte copy into shared memory and its barrier),
//        1 the factor (and its write into the slot), 2 the write-back;
//   K12: 0 the spread factor and the sigma points through f (and the next
//        step's inputs issued), 1 the predicted moments x_p and P_p, 2 the
//        update's points, h and moments (y_p, S, Pxy), 3 the factor of S,
//        the substitutions, x_f, P_f and the log-density, 4 the stores of
//        the step's outputs, 5 the set-up (Q, R, P0 into shared memory, x0).

#include <cuda_runtime.h>

#include "../numpower_tpu_torch/csrc/plants.cuh"
#include "stamps.cuh"

namespace smallmat {

constexpr int kMaxDim = 16;
constexpr int kBatch = 32;

__host__ __device__ inline int odd_stride(int width) { return width | 1; }

__device__ inline void load_items(float* dst, const float* __restrict__ src, int count,
                                  int width, int stride) {
  for (int e = threadIdx.x; e < count * width; e += blockDim.x)
    dst[(e / width) * stride + e % width] = src[e];
}

__device__ inline void store_items(float* __restrict__ dst, const float* src, int count,
                                   int width, int stride) {
  for (int e = threadIdx.x; e < count * width; e += blockDim.x)
    dst[e] = src[(e / width) * stride + e % width];
}

template <int n>
__device__ __forceinline__ void factor(const float* a, float L[n][n], float inv[n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float acc = a[j * n + j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc -= L[j][k] * L[j][k];
    inv[j] = rsqrtf(acc);
    L[j][j] = acc * inv[j];
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      float v = a[i * n + j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv[j];
    }
  }
}

template <int n>
__global__ void __launch_bounds__(kBatch) cholesky_kernel(const float* __restrict__ a,
                                                          float* __restrict__ out, int N) {
  extern __shared__ float sm[];
  NPT_STAMP_BEGIN;
  const int stride = odd_stride(n * n);
  const int first = blockIdx.x * kBatch;
  const int count = min(kBatch, N - first);
  load_items(sm, a + static_cast<size_t>(first) * n * n, count, n * n, stride);
  __syncthreads();
  NPT_STAMP(0);
  if (static_cast<int>(threadIdx.x) < count) {
    float* m = sm + threadIdx.x * stride;
    float L[n][n], inv[n];
    factor<n>(m, L, inv);
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) m[i * n + j] = j <= i ? L[i][j] : 0.0f;
  }
  __syncthreads();
  NPT_STAMP(1);
  store_items(out + static_cast<size_t>(first) * n * n, sm, count, n * n, stride);
  NPT_STAMP(2);
  NPT_STAMP_END;
}

template <int n>
cudaError_t launch_cholesky(const float* a, float* L, int N, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kBatch) * (n * n | 1) * sizeof(float);
  cholesky_kernel<n><<<(N + kBatch - 1) / kBatch, kBatch, smem, stream>>>(a, L, N);
  return cudaGetLastError();
}

#define NPT_DIM_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

}  // namespace smallmat

extern "C" int npt_cholesky_batched(const float* a, float* L, int N, int n, void* stream) {
  using namespace smallmat;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || n < 1 || n > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
#define NPT_CASE(D) \
  case D:           \
    return static_cast<int>(launch_cholesky<D>(a, L, N, s));
    NPT_DIM_CASES(NPT_CASE)
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace ukf {

constexpr int kBlock = 32;

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Weights {
  float wm0, wmi, wc0, wci;
  float c_half;
  float jitter;
};

struct Args {
  const float *Q, *R, *P0, *x0s, *yss, *uss;
  float *xf, *xp, *Pf, *Pp, *ll;
  int B, T;
};

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
  NPT_STAMP_BEGIN;
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
  NPT_WAIT(x[0]);
  NPT_STAMP(5);

  for (int t = 0; t < T; ++t) {
    float u[m], y[p];
#pragma unroll
    for (int k = 0; k < m; ++k) u[k] = u_nx[k];
#pragma unroll
    for (int c = 0; c < p; ++c) y[c] = y_nx[c];
    if (t + 1 < T) {
#pragma unroll
      for (int k = 0; k < m; ++k) u_nx[k] = ub[(t + 1) * m + k];
#pragma unroll
      for (int c = 0; c < p; ++c) y_nx[c] = yb[(t + 1) * p + c];
    }

    float S[n][n], fx[K][n];
    spread<n>(Pm, w, S);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float pt[n];
      sigma_point<n>(k, x, S, pt);
      F::step(pt, u, spar, fx[k]);
    }
    NPT_STAMP(0);
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
    NPT_STAMP(1);

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
    NPT_STAMP(2);

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
    float SK[p][n];
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
    NPT_STAMP(3);

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
    NPT_STAMP(4);
  }
  a.ll[b] = ll;
  NPT_STAMP_END;
}

template <int P, int H, int p>
int launch(const PlantParams& params, const Weights& w, const Args& a, cudaStream_t stream) {
  ukf_kernel<P, H, p><<<(a.B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(params, w, a);
  return static_cast<int>(cudaGetLastError());
}

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

extern "C" int npt_ukf(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                       float p6, float p7, int measure, int p, float wm0, float wmi, float wc0,
                       float wci, float c_half, float jitter, const float* Q, const float* R,
                       const float* P0, const float* x0s, const float* yss, const float* uss,
                       float* xf, float* xp, float* Pf, float* Pp, float* ll, int B, int T,
                       void* stream) {
  using namespace ukf;
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
