// Systematic resampling of a batched particle cloud (K14): the resampled
// cloud from the integer slot boundaries of systematic resampling.
//
// Replaces the TPU kernel numpower_tpu/kernels/pf_resample.py
// resample_onehot_pallas (_resample_kernel), the same function:
//     out[b, i] = parts[b, j]  for the unique j with m[b, j-1] <= i < m[b, j]
// (m[b, -1] = 0; a row of zeros where no j owns slot i), m (B, N) int32
// nondecreasing as models/particle._resample_slots makes it, parts and out
// (B, N, n) fp32. The TPU kernel built an (N, N) one-hot block and contracted
// it with the cloud on the MXU, O(N^2 n) work; here the owner j of slot i is
// the first j with m[b, j] > i, found by binary search, and the n floats are
// copied: O(N log N) comparisons, every output element written once, exact.
//
// What bounds it: bytes. Each element of parts that is read and of out is
// moved once, and m once: 4 (2 B N n + B N) bytes, 5.2 MB at the bench's
// B = 256, N = 1024, n = 2, ~1.6 us of HBM time; the search is ~11 shared
// loads per slot.
//
// What held the first design back (one thread per slot in turn, four slots a
// thread; probes/psd_resample.py at the bench's shape): each thread's four
// slots ran one after another, a binary search of dependent shared loads,
// then a gather from device memory that the store waited for, ~1,700 cycles
// a slot; and the row's boundaries were staged four bytes a thread at a
// time, ~1,600 cycles.
// Now:
//   - a block takes kSlots = 1024 output slots of one row b (grid (B, slot
//     blocks)), each thread kPer = 4 slots interleaved by kThreads, so that a
//     warp's slots are consecutive and its stores coalesce;
//   - the row's N boundaries are staged in shared memory as the aligned
//     16-byte span of the row by cp.async, all in flight at once (a row at any
//     4-byte alignment is read at its offset in the span), when the span fits
//     the 48 KB of a plain launch (N <= kMaxStaged = 12,288); past that the
//     searches read device memory;
//   - the thread's four searches advance in lockstep, one step of each in
//     turn, ceil(log2 N) + 1 loads a slot: the same steps for every slot,
//     whatever the weights, and four loads in flight at each step. A
//     particle owning every slot costs what N particles owning one each do,
//     as do long runs of particles with no slot;
//   - every gather is issued before any store, as V-float vectors (V = 4, 2
//     or 1: the largest that divides n and the alignment of parts and out),
//     n / V of them a slot.
//
// The probe builds this file with the NPT_STAMP macros filled in (the parts:
// 0 staging, 1 search, 2 gather, 3 store); here they are empty.

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

namespace pf_resample {

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // slots a thread, searched together
constexpr int kSlots = kThreads * kPer;  // output slots per block
constexpr int kMaxStaged = 12288;        // boundaries staged in shared memory (48 KB)

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  __device__ static float zero() { return 0.0f; }
  __device__ static float first(float v) { return v; }
};
template <>
struct Vec<2> {
  using type = float2;
  __device__ static float2 zero() { return make_float2(0.0f, 0.0f); }
  __device__ static float first(float2 v) { return v.x; }
};
template <>
struct Vec<4> {
  using type = float4;
  __device__ static float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static float first(float4 v) { return v.x; }
};

template <int V, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ parts, const int* __restrict__ m,
                    float* __restrict__ out, int N, int n) {
  using T = typename Vec<V>::type;
  extern __shared__ __align__(16) int staged_m[];
  NPT_STAMP_BEGIN;
  const int b = blockIdx.x;
  const int* row = m + static_cast<size_t>(b) * N;
  if (kStaged) {
    async_copy::copy_run_by_block(reinterpret_cast<float*>(staged_m),
                                  reinterpret_cast<const float*>(row), N, threadIdx.x, kThreads);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    row = staged_m + async_copy::run_offset(reinterpret_cast<const float*>(row));
  }
  NPT_STAMP(0);
  // the owner of each slot: pos = how many j have row[j] <= slot. It lies in
  // [pos, pos + len] with pos + len <= N; each step halves len (the same
  // halves for every slot), and row[pos + half - 1] <= slot moves pos past
  // the lower half.
  int slot[kPer], pos[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    slot[p] = blockIdx.y * kSlots + p * kThreads + threadIdx.x;
    pos[p] = 0;
  }
  for (int len = N; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      if (row[pos[p] + half - 1] <= slot[p]) pos[p] += half;
    len -= half;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) pos[p] += row[pos[p]] <= slot[p];
  NPT_STAMP(1);
  const size_t base = static_cast<size_t>(b) * N;
  const int nv = n / V;
  for (int c = 0; c < nv; ++c) {
    T v[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      v[p] = slot[p] < N && pos[p] < N
                 ? reinterpret_cast<const T*>(parts + (base + pos[p]) * n)[c]
                 : Vec<V>::zero();
#pragma unroll
    for (int p = 0; p < kPer; ++p) NPT_WAIT(Vec<V>::first(v[p]));
    NPT_STAMP(2);
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      if (slot[p] < N) reinterpret_cast<T*>(out + (base + slot[p]) * n)[c] = v[p];
    NPT_STAMP(3);
  }
  NPT_STAMP_END;
}

// The vector width of the copies: the largest of 4, 2, 1 floats that divides
// n and the alignment of parts and out.
inline int vector_width(const float* parts, const float* out, int n) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(parts) | reinterpret_cast<uintptr_t>(out);
  if (n % 4 == 0 && both % 16 == 0) return 4;
  if (n % 2 == 0 && both % 8 == 0) return 2;
  return 1;
}

template <int V>
cudaError_t launch(const float* parts, const int* m, float* out, int B, int N, int n,
                   cudaStream_t stream) {
  const dim3 grid(B, (N + kSlots - 1) / kSlots);
  // shared bytes of the row's aligned span: every row's span is the row
  // itself when m and N keep rows on 16-byte boundaries, else up to 3 ints
  // more on each side
  const bool rows_aligned = reinterpret_cast<uintptr_t>(m) % 16 == 0 && N % 4 == 0;
  const size_t smem = sizeof(int) * (rows_aligned ? N : async_copy::slot_floats(N));
  if (N <= kMaxStaged && smem <= 48 * 1024)
    resample_kernel<V, true><<<grid, kThreads, smem, stream>>>(parts, m, out, N, n);
  else
    resample_kernel<V, false><<<grid, kThreads, 0, stream>>>(parts, m, out, N, n);
  return cudaGetLastError();
}

}  // namespace pf_resample

// out (B, N, n) from parts (B, N, n) fp32 and the slot boundaries m (B, N)
// int32, row-major contiguous on the device. Returns the CUDA error code of
// the launch.
extern "C" int npt_resample_systematic(const float* parts, const int* m, float* out, int B, int N,
                                       int n, void* stream) {
  using namespace pf_resample;
  if (B < 1 || N < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vector_width(parts, out, n)) {
    case 4:
      return static_cast<int>(launch<4>(parts, m, out, B, N, n, st));
    case 2:
      return static_cast<int>(launch<2>(parts, m, out, B, N, n, st));
    default:
      return static_cast<int>(launch<1>(parts, m, out, B, N, n, st));
  }
}
