// Fused batched RTS mean pass (K10): the whole-horizon backward mean
// recurrence of a Rauch-Tung-Striebel smoother whose gains are shared by
// every trajectory.
//
// Replaces the TPU kernel numpower_tpu/kernels/rts_batched.py
// rts_mean_pass_pallas (_rts_mean_kernel). models/estimation.
// kalman_smoother_batched forms the shared gains G_t' and the batch-parallel
// affine terms e_t = x_f[t] - x_p[t+1] G_t' outside; this kernel runs, for
// every trajectory, x_s[T-1] = x_f[T-1] and for t = T-2 .. 0
//     x_s[t][k] = e_t[k] + sum_i G_t'[i][k] x_s[t+1][i],
// and writes xs (T, N, n) in forward time order (the JAX package's layout).
//
// Design: K9's (kalman_mean.cu). One thread per trajectory, the state in
// registers; n as a compile-time bucket (2/4/8/16) over zero padding; the
// gains of a chunk of Tc steps (broadcast reads) and the block's rows of
// e_t (one contiguous run per step) streamed through shared memory with
// cp.async, backward in time, so T is unbounded and each chunk costs one
// device-memory latency.
//
// What bounds it: the latency of the chain of T - 1 dependent steps of n^2
// FMAs on shared-memory operands; at the bench's shape (N = 4096, T = 50,
// n = 2) its bytes are ~2.4 MB, under a microsecond of HBM time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace rts_mean {

constexpr int kBlock = 64;  // trajectories per block, one thread each
constexpr int kMaxTc = 64;
constexpr size_t kSmemBudget = 96 * 1024;

inline size_t smem_floats(int NB, int n, int Tc) {
  return static_cast<size_t>(Tc) * (NB * NB + kBlock * n);
}

inline int chunk_for(int NB, int n, int steps) {
  int Tc = kMaxTc;
  while (Tc > 1 && (Tc > steps || smem_floats(NB, n, Tc) * sizeof(float) > kSmemBudget)) --Tc;
  return Tc;
}

template <int NB>
__global__ void __launch_bounds__(kBlock)
    rts_mean_kernel(const float* __restrict__ G, const float* __restrict__ es,
                    const float* __restrict__ x_last, float* __restrict__ xs, int N, int T, int n,
                    int Tc) {
  extern __shared__ __align__(16) float smem[];
  float* const sG = smem;                   // (Tc, NB, NB): G_t'[i][k] at i * NB + k
  float* const sE = sG + Tc * NB * NB;      // (Tc, kBlock, n)
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kBlock, s = s0 + tid;
  const int live = min(kBlock, N - s0);

  float x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    x[j] = (s < N && j < n) ? x_last[static_cast<size_t>(s) * n + j] : 0.0f;
  if (s < N) {
    const size_t row = (static_cast<size_t>(T - 1) * N + s) * n;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) xs[row + j] = x[j];
  }

  // chunks of steps [lo, hi], hi descending from T - 2; slot tt = t - lo
  for (int hi = T - 2; hi >= 0; hi -= Tc) {
    const int lo = max(0, hi - Tc + 1), steps = hi - lo + 1;
    __syncthreads();  // the last chunk is consumed
    for (int e = tid; e < steps * NB * NB; e += kBlock) {
      const int tt = e / (NB * NB), r = e - tt * NB * NB, i = r / NB, k = r % NB;
      sG[e] = (i < n && k < n) ? G[(static_cast<size_t>(lo + tt) * n + i) * n + k] : 0.0f;
    }
    for (int e = tid; e < steps * live * n; e += kBlock) {
      const int tt = e / (live * n), r = e - tt * live * n;
      __pipeline_memcpy_async(sE + tt * kBlock * n + r,
                              es + (static_cast<size_t>(lo + tt) * N + s0) * n + r, sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    for (int tt = steps - 1; tt >= 0; --tt) {
      const float* g = sG + tt * NB * NB;
      float xn[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float acc = k < n ? sE[(tt * kBlock + tid) * n + k] : 0.0f;
#pragma unroll
        for (int i = 0; i < NB; ++i) acc = acc + g[i * NB + k] * x[i];
        xn[k] = acc;
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) x[k] = xn[k];
      if (s < N) {
        const size_t row = (static_cast<size_t>(lo + tt) * N + s) * n;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (j < n) xs[row + j] = x[j];
      }
    }
  }
}

template <int NB>
int launch(const float* G, const float* es, const float* x_last, float* xs, int N, int T, int n,
           cudaStream_t stream) {
  const int Tc = chunk_for(NB, n, T - 1);
  const size_t smem = smem_floats(NB, n, Tc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rts_mean_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rts_mean_kernel<NB><<<(N + kBlock - 1) / kBlock, kBlock, smem, stream>>>(G, es, x_last, xs, N,
                                                                           T, n, Tc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rts_mean

// xs (T, N, n) from G (T-1, n, n) = the gains G_t', es (T-1, N, n) and
// x_last (N, n); all fp32, row-major contiguous, on the device; T >= 2,
// 1 <= n <= 16. Returns the CUDA error code of the launch.
extern "C" int npt_rts_mean(const float* G, const float* es, const float* x_last, float* xs, int N,
                            int T, int n, void* stream) {
  using namespace rts_mean;
  if (N < 1 || T < 2 || n < 1 || n > 16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 2) return launch<2>(G, es, x_last, xs, N, T, n, st);
  if (n <= 4) return launch<4>(G, es, x_last, xs, N, T, n, st);
  if (n <= 8) return launch<8>(G, es, x_last, xs, N, T, n, st);
  return launch<16>(G, es, x_last, xs, N, T, n, st);
}
