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
// K6a. One matrix per thread, one warp per block (kBatch = 32 matrices),
// so 4096 matrices are 128 blocks on the H100's 132 SMs. The dimension n is
// a template parameter (1..16): the factor L and its inverse diagonal live in
// registers, every loop is unrolled. The block copies its 32 matrices from
// their public row-major layout into shared memory, consecutive threads on
// consecutive addresses, each matrix at an odd stride so that the 32
// threads' reads of "element e of my matrix" fall on 32 distinct banks;
// results go back the same way.
//
// K6b. What bounded the first design (K6a's, one matrix per thread, one
// warp a block): its staging loop, one 4-byte load a thread an iteration,
// each waiting on device memory (probes/psd_resample.py at (4096, 4, 4) x
// (4096, 4, 12): 71% of a thread's cycles, and the write-back loop 21%;
// 16 us of device time for 1.8 MB); then the right-hand side's columns, one
// after another in one thread. Now a block of (r, tile) threads takes
// `tile` matrices (32 for n <= 8, else 16), one thread per (column, matrix):
//   - staging: the block's matrices and right-hand sides are two contiguous
//     runs of device memory, copied as their aligned 16-byte spans by cp.async
//     shared over the block's threads (csrc/async_copy.cuh), all in flight at
//     once, one wait; a base at any 4-byte alignment is read at its offset in
//     the span, and no index is divided by a runtime width;
//   - the factor: one thread per matrix forms it in registers by K6a's
//     factor<n> and writes it over the matrix's slot (L below the diagonal,
//     1 / L[j][j] on it), where the matrix's other threads read it;
//   - the solve: each thread substitutes its own column, reading L as a
//     broadcast among the matrix's threads, and writes X over its column;
//   - the write-back: the block's X tile is one contiguous run, stored as
//     16-byte pieces from the first aligned address on.
// At N = 4096, n = 4, r = 12 that is 128 blocks of 12 warps. Shared memory is
// at most 33 KB a block (n = 16, r = 16), under the 48 KB a launch may take
// without an attribute, so nothing is set on the host per launch. Device
// memory is read and written once (4 N n (n + 2r) bytes).
//
// The probe builds this file with the NPT_STAMP macros filled in (the parts
// of K6b: 0 staging, 1 factor, 2 solve, 3 write-back); here they are empty.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_WAIT(v)
#define NPT_STAMP_END
#endif

namespace smallmat {

constexpr int kMaxDim = 16;  // matrix dimension
constexpr int kMaxRhs = 16;  // right-hand-side columns of K6b
constexpr int kBatch = 32;   // K6a: matrices per block, one per thread

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

// K6b's matrices a block: the block is (r, tile) threads.
template <int n>
__host__ __device__ constexpr int solve_tile() {
  return n <= 8 ? 32 : 16;
}

// Shared floats of K6b's block: the slots of its A and B spans.
__host__ __device__ constexpr int solve_smem_floats(int n, int tile, int r) {
  return async_copy::slot_floats(tile * n * n) + async_copy::slot_floats(tile * n * r);
}

// X = L'^{-1} L^{-1} b for one column b (n floats at stride r from col), by
// the factor at L: L[i][j] below the diagonal, 1 / L[i][i] on it; X
// overwrites the column.
template <int n>
__device__ __forceinline__ void solve_column(const float* L, float* col, int r) {
  float y[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {  // forward: L y = b
    float v = col[i * r];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i * n + k] * y[k];
    y[i] = v * L[i * n + i];
  }
  // for n > 8, L is read again rather than held in registers from the
  // forward pass to the backward one
  if (n > 8) asm volatile("" ::: "memory");
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {  // backward: L' x = y (x overwrites y)
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) v -= L[k * n + i] * y[k];
    y[i] = v * L[i * n + i];
  }
#pragma unroll
  for (int i = 0; i < n; ++i) col[i * r] = y[i];
}

// Stores `count` floats from shared memory at src to dst, the block's
// threads on consecutive 16-byte pieces of dst from its first 16-byte
// boundary on, 4-byte stores before it and after the last whole piece.
__device__ __forceinline__ void store_run_by_block(float* __restrict__ dst, const float* src,
                                                   int count, int tid, int nthreads) {
  const int head =
      min(count, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) >> 2));
  if (tid < head) dst[tid] = src[tid];
  const int pieces = (count - head) >> 2;
  for (int q = tid; q < pieces; q += nthreads) {
    const int e = head + 4 * q;
    *reinterpret_cast<float4*>(dst + e) = make_float4(src[e], src[e + 1], src[e + 2], src[e + 3]);
  }
  for (int e = head + 4 * pieces + tid; e < count; e += nthreads) dst[e] = src[e];
}

template <int n>
__global__ void __launch_bounds__(solve_tile<n>() * kMaxRhs)
    psd_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ x, int N, int r) {
  constexpr int kTile = solve_tile<n>();
  extern __shared__ __align__(16) float solve_sm[];
  NPT_STAMP_BEGIN;
  const int c = threadIdx.x, k = threadIdx.y;  // this thread's column and matrix
  const int tid = k * r + c, nthreads = r * kTile;
  const int first = blockIdx.x * kTile;
  const int count = min(kTile, N - first);
  const float* a_tile = a + static_cast<size_t>(first) * n * n;
  const float* b_tile = b + static_cast<size_t>(first) * n * r;
  float* const sa_slot = solve_sm;
  float* const sb_slot = solve_sm + async_copy::slot_floats(kTile * n * n);
  async_copy::copy_run_by_block(sa_slot, a_tile, count * n * n, tid, nthreads);
  async_copy::copy_run_by_block(sb_slot, b_tile, count * n * r, tid, nthreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float* const sa = sa_slot + async_copy::run_offset(a_tile);
  float* const sb = sb_slot + async_copy::run_offset(b_tile);
  NPT_STAMP(0);
  if (c == 0 && k < count) {  // the factor, over the matrix's slot
    float* const mat = sa + k * n * n;
    float L[n][n], inv[n];
    factor<n>(mat, L, inv);
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) mat[i * n + j] = L[i][j];
      mat[i * n + i] = inv[i];
    }
  }
  __syncthreads();
  NPT_STAMP(1);
  if (k < count) solve_column<n>(sa + k * n * n, sb + k * n * r + c, r);
  __syncthreads();
  NPT_STAMP(2);
  store_run_by_block(x + static_cast<size_t>(first) * n * r, sb, count * n * r, tid, nthreads);
  NPT_STAMP(3);
  NPT_STAMP_END;
}

template <int n>
cudaError_t launch_cholesky(const float* a, float* L, int N, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kBatch) * (n * n | 1) * sizeof(float);
  static_assert(smem <= 48 * 1024, "K6a's block fits the shared memory of a plain launch");
  cholesky_kernel<n><<<(N + kBatch - 1) / kBatch, kBatch, smem, stream>>>(a, L, N);
  return cudaGetLastError();
}

template <int n>
cudaError_t launch_psd_solve(const float* a, const float* b, float* x, int N, int r,
                             cudaStream_t stream) {
  constexpr int kTile = solve_tile<n>();
  static_assert(solve_smem_floats(n, kTile, kMaxRhs) * sizeof(float) <= 48 * 1024,
                "K6b's block fits the shared memory of a plain launch");
  const size_t smem = solve_smem_floats(n, kTile, r) * sizeof(float);
  psd_solve_kernel<n><<<(N + kTile - 1) / kTile, dim3(r, kTile), smem, stream>>>(a, b, x, N, r);
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
