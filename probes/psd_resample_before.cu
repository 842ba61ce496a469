// The batched SPD solve (K6b) and the systematic resample (K14) as they
// were before their redesign for the H100 (the first port of
// numpower_tpu_torch/csrc/cholesky.cu psd_solve_kernel and pf_resample.cu
// resample_kernel: one matrix per thread in blocks of one warp; one thread
// per slot in turn, four slots a thread), unchanged but for the cycle stamps
// of probes/stamps.cuh at the end of each part, and K14's copy split into
// its loads and its stores so that the stamps can tell them apart.
// probes/psd_resample.py builds this file into its own library and times
// its parts beside those of the current kernels. Parts:
//   K6b: 0 staging (the block's matrices and right-hand sides into shared
//        memory, the barrier), 1 the factor, 2 the solve (the columns in
//        turn), 3 the write-back (the barrier, the stores);
//   K14: 0 staging (the row's boundaries, the barrier), 1 the searches,
//        2 the gathers (each until its value is in a register), 3 the stores.

#include <cuda_runtime.h>

#include "stamps.cuh"

namespace smallmat {

constexpr int kMaxDim = 16;
constexpr int kMaxRhs = 16;
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
__global__ void __launch_bounds__(kBatch) psd_solve_kernel(const float* __restrict__ a,
                                                           const float* __restrict__ b,
                                                           float* __restrict__ x, int N,
                                                           int r) {
  extern __shared__ float sm[];
  NPT_STAMP_BEGIN;
  const int sa = odd_stride(n * n), sb = odd_stride(n * r);
  float* sm_a = sm;
  float* sm_b = sm + kBatch * sa;
  const int first = blockIdx.x * kBatch;
  const int count = min(kBatch, N - first);
  load_items(sm_a, a + static_cast<size_t>(first) * n * n, count, n * n, sa);
  load_items(sm_b, b + static_cast<size_t>(first) * n * r, count, n * r, sb);
  __syncthreads();
  NPT_STAMP(0);
  if (static_cast<int>(threadIdx.x) < count) {
    float L[n][n], inv[n];
    factor<n>(sm_a + threadIdx.x * sa, L, inv);
    NPT_WAIT(inv[n - 1]);
    NPT_STAMP(1);
    float* rhs = sm_b + threadIdx.x * sb;
    for (int c = 0; c < r; ++c) {
      float y[n];
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float v = rhs[i * r + c];
#pragma unroll
        for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
        y[i] = v * inv[i];
      }
#pragma unroll
      for (int i = n - 1; i >= 0; --i) {
        float v = y[i];
#pragma unroll
        for (int k = i + 1; k < n; ++k) v -= L[k][i] * y[k];
        y[i] = v * inv[i];
      }
#pragma unroll
      for (int i = 0; i < n; ++i) rhs[i * r + c] = y[i];
    }
    NPT_STAMP(2);
  }
  __syncthreads();
  store_items(x + static_cast<size_t>(first) * n * r, sm_b, count, n * r, sb);
  NPT_STAMP(3);
  NPT_STAMP_END;
}

template <int n>
cudaError_t launch_psd_solve(const float* a, const float* b, float* x, int N, int r,
                             cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kBatch) * (odd_stride(n * n) + odd_stride(n * r)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      psd_solve_kernel<n>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  psd_solve_kernel<n><<<(N + kBatch - 1) / kBatch, kBatch, smem, stream>>>(a, b, x, N, r);
  return cudaGetLastError();
}

}  // namespace smallmat

extern "C" int npt_psd_solve_batched(const float* a, const float* b, float* x, int N, int n,
                                     int r, void* stream) {
  using namespace smallmat;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || n < 1 || n > kMaxDim || r < 1 || r > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {  // the probe's shapes
    case 4:
      return static_cast<int>(launch_psd_solve<4>(a, b, x, N, r, s));
    case 12:
      return static_cast<int>(launch_psd_solve<12>(a, b, x, N, r, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace pf_resample {

constexpr int kThreads = 256;
constexpr int kSlots = 1024;
constexpr int kMaxStaged = 12288;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ parts, const int* __restrict__ m,
                    float* __restrict__ out, int N, int n) {
  extern __shared__ int ms[];
  NPT_STAMP_BEGIN;
  const int b = blockIdx.x;
  const int* row = m + static_cast<size_t>(b) * N;
  if (kStaged) {
    for (int e = threadIdx.x; e < N; e += blockDim.x) ms[e] = row[e];
    __syncthreads();
    row = ms;
  }
  NPT_STAMP(0);
  const int end = min(N, (blockIdx.y + 1) * kSlots);
  for (int i = blockIdx.y * kSlots + threadIdx.x; i < end; i += blockDim.x) {
    int lo = 0, hi = N;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] > i)
        hi = mid;
      else
        lo = mid + 1;
    }
    NPT_STAMP(1);
    float* dst = out + (static_cast<size_t>(b) * N + i) * n;
    if (lo == N) {
      for (int c = 0; c < n; ++c) dst[c] = 0.0f;
      NPT_STAMP(3);
    } else {
      const float* src = parts + (static_cast<size_t>(b) * N + lo) * n;
      for (int c = 0; c < n; ++c) {
        float v = src[c];
        NPT_WAIT(v);
        NPT_STAMP(2);
        dst[c] = v;
        NPT_STAMP(3);
      }
    }
  }
  NPT_STAMP_END;
}

}  // namespace pf_resample

extern "C" int npt_resample_systematic(const float* parts, const int* m, float* out, int B, int N,
                                       int n, void* stream) {
  using namespace pf_resample;
  if (B < 1 || N < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, (N + kSlots - 1) / kSlots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= kMaxStaged)
    resample_kernel<true><<<grid, kThreads, N * sizeof(int), st>>>(parts, m, out, N, n);
  else
    resample_kernel<false><<<grid, kThreads, 0, st>>>(parts, m, out, N, n);
  return static_cast<int>(cudaGetLastError());
}
