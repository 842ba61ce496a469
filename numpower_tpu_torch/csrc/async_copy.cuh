// Staging contiguous runs of floats from device memory into shared memory
// with 16-byte cp.async (LDGSTS.128), for the kernels that stage a chunk of
// a horizon ahead of their step chain (ilqr_backward.cu, ilqr_forward.cu,
// ukf.cu, ekf.cu) and those that stage one tile a block (cholesky.cu,
// pf_resample.cu); and the way back, a run stored from shared memory as
// 16-byte pieces (cholesky.cu), or a group's values stored from registers
// spread over its lanes (ukf.cu, ekf.cu).
//
// Why not the TMA's bulk copies (cp.async.bulk on an mbarrier): a block's
// chunk is 128-160 runs of 16-320 bytes (one per scenario and array), and a
// bulk copy costs the SM's copy engine ~30-50 cycles of issue whatever its
// size (measured with probes/ilqr_chain.py on the H100: 480 of them took
// ~24,000 cycles), so they fell behind the step chain they were to feed.
// A thread's 16-byte cp.async's are one instruction each, in flight
// together, completed by its commit groups (__pipeline_wait_prior). (Spread
// over the steps of the chunk before, a slice a step, they cost the chain
// more than issued at once: the step's own shared loads queue behind them.)
//
// A run that starts or ends inside a 16-byte block (lu of an m = 1 plant at
// T = 50 starts at 200 s bytes) is copied as the aligned span that holds it:
// the span's extra floats lie in the same 16-byte blocks as the run's own,
// hence in memory the run's allocation already maps, and nothing reads them.
// The run then starts run_offset() floats into its slot, which needs room
// for the run and 3 floats more on each side of rounding (slot_floats).

#pragma once

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace async_copy {

// Floats of a 16-byte-aligned slot that holds a run of `count` floats at any
// 4-byte alignment.
__host__ __device__ constexpr int slot_floats(int count) { return (count + 3 + 3) / 4 * 4; }

// Where a run starting at src sits in its slot, in floats.
__device__ __forceinline__ int run_offset(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15u) >> 2);
}

// The aligned span of the run of `count` floats at src: where it starts, and
// how many 16-byte pieces it has (0 for no run).
__device__ __forceinline__ const char* span_start(const float* src) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15});
}
__device__ __forceinline__ int span_pieces(const float* src, int count) {
  if (count <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return static_cast<int>((((a + 4u * static_cast<uintptr_t>(count) + 15u) & ~uintptr_t{15}) -
                           (a & ~uintptr_t{15})) >> 4);
}

// Copies the aligned span of the run of `count` floats at src into the slot
// at dst (16-byte aligned), as 16-byte cp.async's of this thread's current
// commit group.
__device__ __forceinline__ void copy_run(float* dst, const float* src, int count) {
  const char* const from = span_start(src);
  const int pieces = span_pieces(src, count);
  for (int q = 0; q < pieces; ++q) __pipeline_memcpy_async(dst + 4 * q, from + 16 * q, 16);
}

// The same copy shared by the block's threads: thread `tid` of `nthreads`
// takes the pieces tid, tid + nthreads, ..., so that the block's whole span
// is in flight at once (the kernels that stage one contiguous tile a block:
// cholesky.cu, pf_resample.cu).
__device__ __forceinline__ void copy_run_by_block(float* dst, const float* src, int count,
                                                  int tid, int nthreads) {
  const char* const from = span_start(src);
  const int pieces = span_pieces(src, count);
  for (int q = tid; q < pieces; q += nthreads)
    __pipeline_memcpy_async(dst + 4 * q, from + 16 * q, 16);
}

// The way back: stores `count` floats from shared memory at src to dst, the
// threads (`tid` of `nthreads` >= 3: a block's, or a group's lanes) on
// consecutive 16-byte pieces of dst from its first 16-byte boundary on,
// 4-byte stores before it and after the last whole piece.
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

// Stores the N floats of v at dst[0..N), spread over the group: lane k
// stores entries k, k + G, ..., each picked from the lane's copy by a select
// tree on the bits of k (G - 1 selects a slot, no memory round trip), so a
// slot is one store a lane, the group's lanes on consecutive addresses.
// Lanes past the end store entry N - 1 again, the same value at the same
// address: a store under a branch instead cost the pendulum a fifth of the
// kernel (probes/ukf_ablation.py; ukf.cu, ekf.cu).
template <int G, int N>
__device__ __forceinline__ void store_spread(float* __restrict__ dst, const float (&v)[N], int k) {
#pragma unroll
  for (int s = 0; s < N; s += G) {
    float c[G];
#pragma unroll
    for (int i = 0; i < G; ++i) c[i] = v[s + i < N ? s + i : N - 1];
#pragma unroll
    for (int w = 1; w < G; w <<= 1)
#pragma unroll
      for (int i = 0; i + w < G; i += 2 * w) c[i] = (k & w) ? c[i + w] : c[i];
    dst[min(s + k, N - 1)] = c[0];
  }
}

}  // namespace async_copy
