// The batched RTS mean pass (K10) as it was before its redesign for the
// H100 (the first port of numpower_tpu_torch/csrc/rts_mean.cu
// rts_mean_kernel: one thread a trajectory, 64 a block, the horizon staged
// in chunks of min(64, T - 1) steps, the gains by 4-byte loads with runtime
// divides, the e_t rows by 4-byte cp.async, waited for in full before the
// chunk's first step, every store under a branch), unchanged but for the
// cycle stamps of probes/stamps.cuh at the end of each part.
// probes/rts_mean.py builds this file into its own library and times its
// parts beside those of the current kernel. Parts: 0 x_last's load and the
// first store, 1 the gains' staging (and the barrier before it), 2 the e_t
// staging and its wait, 3 the chain of a step, 4 its stores.

#include "stamps.cuh"

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
  NPT_STAMP_BEGIN;

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
  NPT_WAIT(x[0]);
  NPT_STAMP(0);

  // chunks of steps [lo, hi], hi descending from T - 2; slot tt = t - lo
  for (int hi = T - 2; hi >= 0; hi -= Tc) {
    const int lo = max(0, hi - Tc + 1), steps = hi - lo + 1;
    __syncthreads();  // the last chunk is consumed
    for (int e = tid; e < steps * NB * NB; e += kBlock) {
      const int tt = e / (NB * NB), r = e - tt * NB * NB, i = r / NB, k = r % NB;
      sG[e] = (i < n && k < n) ? G[(static_cast<size_t>(lo + tt) * n + i) * n + k] : 0.0f;
    }
    NPT_STAMP(1);
    for (int e = tid; e < steps * live * n; e += kBlock) {
      const int tt = e / (live * n), r = e - tt * live * n;
      __pipeline_memcpy_async(sE + tt * kBlock * n + r,
                              es + (static_cast<size_t>(lo + tt) * N + s0) * n + r, sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    NPT_STAMP(2);

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
      NPT_STAMP(3);
      if (s < N) {
        const size_t row = (static_cast<size_t>(lo + tt) * N + s) * n;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (j < n) xs[row + j] = x[j];
      }
      NPT_STAMP(4);
    }
  }
  NPT_STAMP_END;
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
