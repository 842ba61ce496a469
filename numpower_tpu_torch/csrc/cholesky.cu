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
// K6a. What bounded the first design (one matrix a thread, one warp a
// block, so 4096 matrices were 128 one-warp blocks, one warp an SM): its
// staging, one 4-byte load a thread an iteration, each shared store waiting
// on its load (probes/chol_ukf.py at (4096, 12, 12): 79% of a thread's
// cycles), and the same 4-byte loop for the write-back (18%); 32 us of
// device time for 4.7 MB. Now a group of G lanes takes one matrix, G the
// power of two >= n (16 at n = 12, so two matrices a warp), and a block of
// 128 threads takes 128 / G matrices:
//   - staging: the block's matrices are one contiguous run, copied as its
//     aligned 16-byte span by cp.async shared over the block's threads
//     (csrc/async_copy.cuh, K6b's staging), all in flight at once, one wait;
//   - the factor: lane i holds row i of the matrix in registers (its lower
//     triangle read from shared memory) and the factor runs right-looking:
//     for column j the pivot travels from lane j by one __shfl_sync, every
//     lane forms rsqrtf of it, lanes i >= j scale their entry of column j,
//     and the column's entries travel to the lanes below for the trailing
//     update. Each entry sees the same operations in the same order as
//     factor<n> (a[i][k] - sum_j L[i][j] L[k][j] over j ascending, then
//     times 1 / L[k][k]), so the result is factor<n>'s bit for bit;
//   - the write-back: each lane writes row i of L (zeros above the
//     diagonal) over its row in shared memory, and the block's tile, one
//     contiguous run, is stored as 16-byte pieces.
// At N = 4096, n = 12 that is 512 blocks of four warps. The dependent chain
// is n pivots, each a shuffle, an rsqrtf and a multiply, and the column's
// shuffles and FMAs; a group's lanes beyond n and the matrices past N take
// part in the shuffles and store nothing. Shared memory is at most 8 KB a
// block (n = 16); device memory is read and written once (8 N n^2 bytes).
// (Not taken: one matrix a thread in smaller blocks. The staging fix alone
// leaves each matrix's factor, about n^3 / 3 dependent FMAs and n pivots,
// in one thread, and 4096 threads are still one warp an SM.)
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
// Envelope: n <= 16, r <= 16; past it, to n = r = 48, cholesky_wide.cu.
//
// The probe builds this file with the NPT_STAMP macros filled in (the parts
// of K6a: 0 staging, 1 factor, 2 write-back; of K6b: 0 staging, 1 factor,
// 2 solve, 3 write-back); here they are empty.

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

constexpr int kMaxDim = 16;        // matrix dimension
constexpr int kMaxRhs = 16;        // right-hand-side columns of K6b
constexpr int kCholThreads = 128;  // K6a: threads a block, a group of lanes a matrix

// K6a's lanes a matrix: the power of two >= n.
__host__ __device__ constexpr int chol_group(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
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

// Lower Cholesky of one n x n matrix held by a group of G lanes, lane i
// (< n) holding row i in r; lanes past n hold anything finite or not and
// take part in the shuffles. On return lane i holds row i of L, exactly 0
// above the diagonal. Right-looking, in factor<n>'s order of operations.
template <int n, int G>
__device__ __forceinline__ void factor_rows(float (&r)[n], int i) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float d = __shfl_sync(0xffffffffu, r[j], j, G);  // lane j's updated pivot
    const float inv = rsqrtf(d);
    r[j] = i == j ? d * inv : i > j ? r[j] * inv : 0.0f;
#pragma unroll
    for (int k = j + 1; k < n; ++k) {  // the trailing update by column j
      const float lk = __shfl_sync(0xffffffffu, r[j], k, G);  // L[k][j]
      if (k <= i) r[k] -= r[j] * lk;
    }
  }
}

template <int n>
__global__ void __launch_bounds__(kCholThreads)
    cholesky_kernel(const float* __restrict__ a, float* __restrict__ out, int N) {
  constexpr int G = chol_group(n), kTile = kCholThreads / G;
  extern __shared__ __align__(16) float chol_sm[];
  NPT_STAMP_BEGIN;
  const int tid = threadIdx.x, i = tid % G, q = tid / G;  // row i of the tile's matrix q
  const int first = blockIdx.x * kTile;
  const int count = min(kTile, N - first);
  const float* a_tile = a + static_cast<size_t>(first) * n * n;
  async_copy::copy_run_by_block(chol_sm, a_tile, count * n * n, tid, kCholThreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float* const tile = chol_sm + async_copy::run_offset(a_tile);
  NPT_STAMP(0);
  const bool mine = q < count && i < n;  // a row of a matrix of the batch
  float* const row = tile + (q * n + i) * n;
  float r[n];
#pragma unroll
  for (int k = 0; k < n; ++k) r[k] = mine && k <= i ? row[k] : 0.0f;
  factor_rows<n, G>(r, i);
  if (mine) {
#pragma unroll
    for (int k = 0; k < n; ++k) row[k] = r[k];
  }
  __syncthreads();
  NPT_STAMP(1);
  async_copy::store_run_by_block(out + static_cast<size_t>(first) * n * n, tile, count * n * n,
                                 tid, kCholThreads);
  NPT_STAMP(2);
  NPT_STAMP_END;
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
  async_copy::store_run_by_block(x + static_cast<size_t>(first) * n * r, sb, count * n * r, tid,
                                 nthreads);
  NPT_STAMP(3);
  NPT_STAMP_END;
}

template <int n>
cudaError_t launch_cholesky(const float* a, float* L, int N, cudaStream_t stream) {
  constexpr int kTile = kCholThreads / chol_group(n);
  constexpr size_t smem = async_copy::slot_floats(kTile * n * n) * sizeof(float);
  static_assert(smem <= 48 * 1024, "K6a's block fits the shared memory of a plain launch");
  cholesky_kernel<n><<<(N + kTile - 1) / kTile, kCholThreads, smem, stream>>>(a, L, N);
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
