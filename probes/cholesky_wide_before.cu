// Batched Cholesky factorization (K6a) and SPD solve (K6b) past the narrow
// envelope: matrices of 16 < n <= 48 and, for the solve, up to 48
// right-hand-side columns at any n <= 48.
//
// Replaces, as cholesky.cu does below it, the TPU kernels
// numpower_tpu/kernels/cholesky.py cholesky_batched (_chol_kernel) and
// psd_solve_batched (_psd_solve_kernel over _chol_inplace with
// inv_diag=True), which take any n: the JAX package documents the factor as
// the drop-in for jnp.linalg.cholesky "where n <= ~48", and its Riccati's
// "pallas" route solves each step's (m, m) system against n right-hand-side
// columns. The functions are cholesky.cu's: L = chol(A) from the lower
// triangle, strictly upper triangle exactly 0; X = A^{-1} B by the same
// factor and forward/back substitution, each pivot one rsqrtf, the
// substitutions multiplying by the cached 1 / L[j][j]. A non-PD pivot gives
// NaN from its column on; nothing checks or raises.
//
// Why the narrow designs stop at 16. K6a gives a matrix a group of at most
// 16 lanes, lane i holding row i; K6b factors a matrix in one thread's
// registers (factor<n>), n^2 floats, and runs a block of (r, tile) threads
// with r <= 16. At n = 48 a matrix is 2,304 floats, and at r = 48 a
// 16-matrix K6b block would be 768 threads and 64 KB.
//
// K6a, wide. One warp a matrix, four a block: lane i holds rows i and
// i + 32 (the second only for n > 32) in registers (factor_rows_warp: the
// pivots and columns travel by __shfl_sync, each entry in factor<n>'s
// order), over a tile staged and written back as the narrow
// form's, the block's four matrices one contiguous run copied as its aligned
// 16-byte span by cp.async and stored back as 16-byte pieces. The loops run
// to the bucket NB in {24, 32, 40, 48} over the matrix padded with the
// identity. Shared memory: 4 NB^2 floats, 36 KB at NB = 48.
//
// K6b, wide. One block a matrix, 32 threads (r <= 32) or 64: A and B are
// staged by cp.async as in the narrow form; warp 0 loads A's lower triangle
// into its rows, factors it as K6a does, and writes L over A's slot at
// stride NB (below the diagonal, 1 / L[j][j] on it; the padded rows the
// identity's); then thread c < r substitutes column c of B in place, over
// the n rows of the matrix (a rolled loop, L read as broadcasts: held in
// registers and unrolled, the vector and L's rows spilled past NB = 16),
// and the block stores X as one contiguous run of 16-byte pieces. Buckets NB in
// {16, 24, 32, 40, 48}: NB = 16 takes the narrow dimensions whose solve has
// more than 16 columns (the "psd" Riccati route of a system with n > 16
// solves an (m, m) system against n columns). Shared memory:
// 4 NB (NB + r) bytes and the slots' rounding, 18.5 KB at (48, 48).
//
// What bounds them: at N = 4096, n = 48 K6a moves 75.5 MB (0.023 ms at
// 3.35 TB/s) for 151 MFLOP, and each matrix's factor is a chain of n pivots
// with ~n^2 / 2 shuffles; K6b at (48, 48) x (48, 48) moves 113 MB. Device
// memory is read and written once. A simple form first: the times are in
// PERF.md, section 6.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace smallmat {

constexpr int kWideMaxDim = 48;  // matrix dimension of the wide forms
constexpr int kWideMaxRhs = 48;  // right-hand-side columns of the wide K6b
constexpr int kWideCholWarps = 4;  // K6a: matrices (warps) a block

// The warp's factor. Lane i holds row i of the matrix in `ra` and, for
// NB > 32, row i + 32 in `rb`, each NB floats in registers (the narrow K6a's
// group of lanes holds at most 16 rows). The factor runs right-looking: for
// column j the pivot travels from its lane by one __shfl_sync, every lane
// forms rsqrtf of it, the lanes at or below the diagonal scale their entry
// of column j, and the column's entries travel to every lane for the
// trailing update. Each entry sees the operations of factor<n> in its order
// (a[i][k] - sum_j L[i][j] L[k][j] over j ascending, then times
// 1 / L[k][k]), as the narrow factor_rows does. The loops run to the
// compile-time bucket NB over a zero-padded matrix with ones on the padded
// diagonal, so that no step tests the runtime dimension: the padded pivots
// are 1, and the padded rows and columns of L stay 0 off the diagonal.
//
// Lower Cholesky of one NB x NB matrix (NB <= 64) held by a warp, lane i
// holding row i in ra and row i + 32 in rb (rb unused for NB <= 32); lanes
// whose rows lie past NB hold anything and take part in the shuffles. On
// return lane i holds row i (and i + 32) of L, exactly 0 above the
// diagonal, and inv_a (inv_b) = 1 / L[i][i] (1 / L[i + 32][i + 32]).
template <int NB>
__device__ __forceinline__ void factor_rows_warp(float (&ra)[NB], float (&rb)[NB], int i,
                                                 float& inv_a, float& inv_b) {
  static_assert(NB <= 64, "a warp holds at most two rows a lane");
  constexpr bool kTwo = NB > 32;
  const int i2 = i + 32;
  inv_a = 1.0f;
  inv_b = 1.0f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = j < 32 ? __shfl_sync(0xffffffffu, ra[j], j)
                           : __shfl_sync(0xffffffffu, rb[j], j - 32);  // the updated pivot
    const float inv = rsqrtf(d);
    inv_a = i == j ? inv : inv_a;
    ra[j] = i == j ? d * inv : i > j ? ra[j] * inv : 0.0f;
    if (kTwo) {
      inv_b = i2 == j ? inv : inv_b;
      rb[j] = i2 == j ? d * inv : i2 > j ? rb[j] * inv : 0.0f;
    }
#pragma unroll
    for (int k = j + 1; k < NB; ++k) {  // the trailing update by column j
      const float lk = k < 32 ? __shfl_sync(0xffffffffu, ra[j], k)
                              : __shfl_sync(0xffffffffu, rb[j], k - 32);  // L[k][j]
      if (k <= i) ra[k] -= ra[j] * lk;
      if (kTwo && k <= i2) rb[k] -= rb[j] * lk;
    }
  }
}

// The smallest of the wide buckets {16, 24, 32, 40, 48} that holds n.
__host__ __device__ constexpr int wide_bucket(int n) {
  return n <= 16 ? 16 : n <= 24 ? 24 : n <= 32 ? 32 : n <= 40 ? 40 : 48;
}

// Lane i's rows of the matrix at `mat` (row-major n x n, lower triangle
// read) into ra (row i) and rb (row i + 32), the identity's past n.
template <int NB>
__device__ __forceinline__ void load_rows_warp(const float* mat, int n, int i, bool live,
                                               float (&ra)[NB], float (&rb)[NB]) {
  const int i2 = i + 32;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    ra[k] = live && i < n && k <= i ? mat[i * n + k] : (k == i ? 1.0f : 0.0f);
    rb[k] = NB > 32 && live && i2 < n && k <= i2 ? mat[i2 * n + k] : (k == i2 ? 1.0f : 0.0f);
  }
}

template <int NB>
__global__ void __launch_bounds__(32 * kWideCholWarps)
    cholesky_wide_kernel(const float* __restrict__ a, float* __restrict__ out, int N, int n) {
  constexpr int kThreads = 32 * kWideCholWarps;
  __shared__ __align__(16) float chol_wide_sm[async_copy::slot_floats(kWideCholWarps * NB * NB)];
  const int tid = threadIdx.x, i = tid % 32, q = tid / 32;  // lane i of the warp of matrix q
  const int first = blockIdx.x * kWideCholWarps;
  const int count = min(kWideCholWarps, N - first);
  const float* a_tile = a + static_cast<size_t>(first) * n * n;
  async_copy::copy_run_by_block(chol_wide_sm, a_tile, count * n * n, tid, kThreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float* const tile = chol_wide_sm + async_copy::run_offset(a_tile);
  const bool live = q < count;  // a matrix of the batch
  float* const mat = tile + q * n * n;
  float ra[NB], rb[NB], inv_a, inv_b;
  load_rows_warp<NB>(mat, n, i, live, ra, rb);
  factor_rows_warp<NB>(ra, rb, i, inv_a, inv_b);
  // each lane writes only its own rows, which only it read
  if (live && i < n) {
#pragma unroll
    for (int k = 0; k < NB; ++k)
      if (k < n) mat[i * n + k] = ra[k];
  }
  if (NB > 32 && live && i + 32 < n) {
#pragma unroll
    for (int k = 0; k < NB; ++k)
      if (k < n) mat[(i + 32) * n + k] = rb[k];
  }
  __syncthreads();
  async_copy::store_run_by_block(out + static_cast<size_t>(first) * n * n, tile, count * n * n,
                                 tid, kThreads);
}

// Shared floats of the wide K6b's block: the slot of A (which L, NB x NB,
// overwrites) and the slot of B (n rows of r, which X overwrites).
__host__ __device__ constexpr int solve_wide_floats(int NB, int r) {
  return async_copy::slot_floats(NB * NB) + async_copy::slot_floats(NB * r);
}

template <int NB>
__global__ void __launch_bounds__(64)
    psd_solve_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ x, int n, int r) {
  __shared__ __align__(16) float solve_wide_sm[solve_wide_floats(NB, kWideMaxRhs)];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t s = blockIdx.x;  // this block's matrix
  const float* a_mat = a + s * n * n;
  const float* b_mat = b + s * n * r;
  float* const sl = solve_wide_sm;  // A's slot, then L at stride NB
  float* const sb_slot = solve_wide_sm + async_copy::slot_floats(NB * NB);
  async_copy::copy_run_by_block(sl, a_mat, n * n, tid, nthreads);
  async_copy::copy_run_by_block(sb_slot, b_mat, n * r, tid, nthreads);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float* const sb = sb_slot + async_copy::run_offset(b_mat);
  if (tid < 32) {
    const float* sa = sl + async_copy::run_offset(a_mat);
    float ra[NB], rb[NB], inv_a, inv_b;
    load_rows_warp<NB>(sa, n, tid, true, ra, rb);
    factor_rows_warp<NB>(ra, rb, tid, inv_a, inv_b);
    __syncwarp();  // every lane has read A before L overwrites it
    if (tid < NB) {
#pragma unroll
      for (int k = 0; k < NB; ++k) sl[tid * NB + k] = k == tid ? inv_a : ra[k];
    }
    if (NB > 32 && tid + 32 < NB) {
#pragma unroll
      for (int k = 0; k < NB; ++k) sl[(tid + 32) * NB + k] = k == tid + 32 ? inv_b : rb[k];
    }
  }
  __syncthreads();
  if (tid < r) {  // column tid: X = L'^{-1} L^{-1} b in place, in solve_column's order
    float* const col = sb + tid;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {  // forward: L y = b
      const float* Li = sl + i * NB;
      float v = col[i * r];
#pragma unroll 4
      for (int k = 0; k < i; ++k) v -= Li[k] * col[k * r];
      col[i * r] = v * Li[i];
    }
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {  // backward: L' x = y (x overwrites y)
      float v = col[i * r];
#pragma unroll 4
      for (int k = i + 1; k < n; ++k) v -= sl[k * NB + i] * col[k * r];
      col[i * r] = v * sl[i * NB + i];
    }
  }
  __syncthreads();
  async_copy::store_run_by_block(x + s * n * r, sb, n * r, tid, nthreads);
}

template <int NB>
cudaError_t launch_cholesky_wide(const float* a, float* L, int N, int n, cudaStream_t stream) {
  static_assert(async_copy::slot_floats(kWideCholWarps * NB * NB) * sizeof(float) <= 48 * 1024,
                "the wide K6a's block fits the shared memory of a plain launch");
  cholesky_wide_kernel<NB><<<(N + kWideCholWarps - 1) / kWideCholWarps, 32 * kWideCholWarps, 0,
                             stream>>>(a, L, N, n);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_psd_solve_wide(const float* a, const float* b, float* x, int N, int n, int r,
                                  cudaStream_t stream) {
  static_assert(solve_wide_floats(NB, kWideMaxRhs) * sizeof(float) <= 48 * 1024,
                "the wide K6b's block fits the shared memory of a plain launch");
  psd_solve_wide_kernel<NB><<<N, r <= 32 ? 32 : 64, 0, stream>>>(a, b, x, n, r);
  return cudaGetLastError();
}

}  // namespace smallmat

// L (N, n, n) = lower Cholesky of each a (N, n, n), 16 < n <= 48, both
// row-major contiguous. Returns the CUDA error code of the launch.
extern "C" int npt_cholesky_batched_wide(const float* a, float* L, int N, int n, void* stream) {
  using namespace smallmat;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || n <= 16 || n > kWideMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  switch (wide_bucket(n)) {
    case 24:
      return static_cast<int>(launch_cholesky_wide<24>(a, L, N, n, s));
    case 32:
      return static_cast<int>(launch_cholesky_wide<32>(a, L, N, n, s));
    case 40:
      return static_cast<int>(launch_cholesky_wide<40>(a, L, N, n, s));
    default:
      return static_cast<int>(launch_cholesky_wide<48>(a, L, N, n, s));
  }
}

// x (N, n, r) = a^{-1} b for a (N, n, n) SPD and b (N, n, r), row-major
// contiguous, n <= 48 and r <= 48 (the narrow npt_psd_solve_batched takes
// n <= 16 with r <= 16). Returns the CUDA error code of the launch.
extern "C" int npt_psd_solve_batched_wide(const float* a, const float* b, float* x, int N, int n,
                                          int r, void* stream) {
  using namespace smallmat;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || n < 1 || n > kWideMaxDim || r < 1 || r > kWideMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (wide_bucket(n)) {
    case 16:
      return static_cast<int>(launch_psd_solve_wide<16>(a, b, x, N, n, r, s));
    case 24:
      return static_cast<int>(launch_psd_solve_wide<24>(a, b, x, N, n, r, s));
    case 32:
      return static_cast<int>(launch_psd_solve_wide<32>(a, b, x, N, n, r, s));
    case 40:
      return static_cast<int>(launch_psd_solve_wide<40>(a, b, x, N, n, r, s));
    default:
      return static_cast<int>(launch_psd_solve_wide<48>(a, b, x, N, n, r, s));
  }
}
