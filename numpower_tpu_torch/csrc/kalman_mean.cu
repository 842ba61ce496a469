// Fused batched Kalman mean pass (K9): the whole-horizon mean recurrence of
// a Kalman filter whose gains are shared by every trajectory.
//
// Replaces the TPU kernel numpower_tpu/kernels/kalman_batched.py
// kalman_mean_pass_pallas (_kf_mean_kernel). The covariance recursion of
// models/estimation.kalman_filter_batched (or kalman_filter_sqrt_batched)
// does not depend on the data and runs once outside; this kernel runs, for
// every trajectory s and step t,
//     x_p = A x + u_t,  v = y_t - C x_p,  x = x_p + v W_t,
//     alpha = invL_t v,  ll -= 0.5 |alpha|^2 + cst_t,
// with cst_t = logdet_t + 0.5 p log 2pi formed by the wrapper (the TPU
// kernel's algebra: the constant is subtracted once per step). It writes
// xs_f, xs_p (T, N, n) and ll (N,), the JAX package's time-major layout.
//
// Design. One thread per trajectory: x and ll stay in registers for the
// whole horizon. n and p enter as compile-time buckets NB, PB (2/4/8/16 and
// 1/2/4/8) over zero padding, so every loop unrolls with no runtime guard on
// the arithmetic (K5's lesson): A, C, W_t and invL_t are padded with zeros
// in shared memory, and the padded components stay exactly zero. The
// per-step gains and the block's rows of y_t (and u_t) are streamed through
// shared memory in chunks of Tc steps with cp.async (each step's rows of a
// block are one contiguous run of (T, N, .) memory, so the copy
// coalesces), so T is bounded by nothing but time and each chunk costs one
// device-memory latency instead of one per step. The gains are read as
// broadcasts (every thread the same address).
//
// What bounds it: at the bench's shape (N = 4096, T = 50, n = 2, p = 1) the
// bytes are ~2.5 MB, under a microsecond of HBM time; the kernel is the
// latency of a chain of T dependent steps (a few shared loads and ~10
// FMAs each) plus one device-memory latency per chunk.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

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
    }
  }
  if (s < N) ll_out[s] = ll;
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
