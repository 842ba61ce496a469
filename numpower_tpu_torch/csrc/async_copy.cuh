// Staging contiguous runs of floats from device memory into shared memory
// with 16-byte cp.async (LDGSTS.128), for the kernels that stage a chunk of
// a horizon ahead of their step chain (ilqr_backward.cu, ilqr_forward.cu).
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

}  // namespace async_copy
