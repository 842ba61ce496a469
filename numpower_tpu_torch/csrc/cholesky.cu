// Batched Cholesky factorization (K6a) and SPD solve (K6b) of many tiny
// matrices.
//
// Replaces the TPU kernels numpower_tpu/kernels/cholesky.py cholesky_batched
// (_chol_kernel) and psd_solve_batched (_psd_solve_kernel over _chol_inplace
// with inv_diag=True). For each matrix of the batch:
//     K6a: L = chol(A), lower, strictly upper triangle exactly 0;
//     K6b: X = A^{-1} B by the same factor and forward/back substitution.
// Both read the lower triangle of A only. Each pivot costs one rsqrtf:
// L[j][j] = acc * rsqrt(acc), and the substitutions multiply by the cached
// 1 / L[j][j]. A non-PD pivot gives NaN from its column on; nothing checks or
// raises, as in the JAX package.
//
// Design. One matrix per thread, one warp per block (kBatch = 32 matrices),
// so 4096 matrices are 128 blocks on the H100's 132 SMs. The dimension n is a
// template parameter (1..16): the factor L, its inverse diagonal and one rhs
// column live in registers, every loop is unrolled. The block first copies
// its 32 matrices (and right-hand sides) from their public row-major layout
// into shared memory with consecutive threads on consecutive addresses
// (coalesced), each matrix at an odd stride, so that the 32 threads' reads of
// "element e of my matrix" fall on 32 distinct banks. Results go back into the
// same shared slots and out the same coalesced way. There is no transpose pass
// on the host.
//
// What bounds it. The work is ~n^3/6 dependent FMAs per factor plus n^2 per
// rhs column, in one thread: a chain of dependent instructions, so latency
// bound, with one warp per SM at N = 4096. Device memory is read and written
// once (4 N n (n + 2r) bytes for K6b).

#include <cuda_runtime.h>

namespace smallmat {

constexpr int kMaxDim = 16;  // matrix dimension
constexpr int kMaxRhs = 16;  // right-hand-side columns of K6b
constexpr int kBatch = 32;   // matrices per block, one per thread

// An odd stride >= width: the 32 threads' slots fall on distinct banks.
__host__ __device__ inline int odd_stride(int width) { return width | 1; }

// Copy `count` items of `width` floats, contiguous from `src`, into shared
// slots of `stride` floats.
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

// Lower Cholesky of the row-major n x n matrix at `a` (lower triangle read),
// L[i][j] for j <= i, and inv[j] = 1 / L[j][j].
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
  const int stride = odd_stride(n * n);
  const int first = blockIdx.x * kBatch;
  const int count = min(kBatch, N - first);
  load_items(sm, a + static_cast<size_t>(first) * n * n, count, n * n, stride);
  __syncthreads();
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
  store_items(out + static_cast<size_t>(first) * n * n, sm, count, n * n, stride);
}

template <int n>
__global__ void __launch_bounds__(kBatch) psd_solve_kernel(const float* __restrict__ a,
                                                           const float* __restrict__ b,
                                                           float* __restrict__ x, int N,
                                                           int r) {
  extern __shared__ float sm[];
  const int sa = odd_stride(n * n), sb = odd_stride(n * r);
  float* sm_a = sm;
  float* sm_b = sm + kBatch * sa;
  const int first = blockIdx.x * kBatch;
  const int count = min(kBatch, N - first);
  load_items(sm_a, a + static_cast<size_t>(first) * n * n, count, n * n, sa);
  load_items(sm_b, b + static_cast<size_t>(first) * n * r, count, n * r, sb);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < count) {
    float L[n][n], inv[n];
    factor<n>(sm_a + threadIdx.x * sa, L, inv);
    float* rhs = sm_b + threadIdx.x * sb;  // row-major n x r; X overwrites it
    for (int c = 0; c < r; ++c) {
      float y[n];
#pragma unroll
      for (int i = 0; i < n; ++i) {  // forward: L y = b
        float v = rhs[i * r + c];
#pragma unroll
        for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
        y[i] = v * inv[i];
      }
#pragma unroll
      for (int i = n - 1; i >= 0; --i) {  // backward: L' x = y (x overwrites y)
        float v = y[i];
#pragma unroll
        for (int k = i + 1; k < n; ++k) v -= L[k][i] * y[k];
        y[i] = v * inv[i];
      }
#pragma unroll
      for (int i = 0; i < n; ++i) rhs[i * r + c] = y[i];
    }
  }
  __syncthreads();
  store_items(x + static_cast<size_t>(first) * n * r, sm_b, count, n * r, sb);
}

template <int n>
cudaError_t launch_cholesky(const float* a, float* L, int N, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBatch) * odd_stride(n * n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_kernel<n>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cholesky_kernel<n><<<(N + kBatch - 1) / kBatch, kBatch, smem, stream>>>(a, L, N);
  return cudaGetLastError();
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

// One case per dimension 1..kMaxDim, each a separate instantiation.
#define NPT_DIM_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) \
  CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

}  // namespace smallmat

// L (N, n, n) = lower Cholesky of each a (N, n, n), both row-major
// contiguous. Returns the CUDA error code of the launch (0 on success).
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

// x (N, n, r) = a^{-1} b for a (N, n, n) SPD and b (N, n, r), row-major
// contiguous, r <= kMaxRhs. Returns the CUDA error code of the launch.
extern "C" int npt_psd_solve_batched(const float* a, const float* b, float* x, int N, int n,
                                     int r, void* stream) {
  using namespace smallmat;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || n < 1 || n > kMaxDim || r < 1 || r > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
#define NPT_CASE(D) \
  case D:           \
    return static_cast<int>(launch_psd_solve<D>(a, b, x, N, r, s));
    NPT_DIM_CASES(NPT_CASE)
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
