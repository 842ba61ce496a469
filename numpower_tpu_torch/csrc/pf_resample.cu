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
// Design. A block takes up to kSlots output slots of one row b (grid (B,
// slot blocks)), one thread per slot in turn; the block stages the row's N
// boundaries in shared memory (4 KB at N = 1024) when they fit in kMaxStaged,
// else searches them in device memory. One thread per slot is load-balanced
// whatever the weights: a particle that owns every slot costs the same as N
// particles owning one each.
//
// What bounds it: bytes. Each element of parts that is read and of out is
// moved once, and m once: 4 (2 B N n + B N) bytes, 5.2 MB at the bench's
// B = 256, N = 1024, n = 2, ~1.6 us of HBM time; the search is ~10 shared
// loads per slot.

#include <cuda_runtime.h>

namespace pf_resample {

constexpr int kThreads = 256;
constexpr int kSlots = 1024;       // output slots per block
constexpr int kMaxStaged = 12288;  // boundaries staged in shared memory (48 KB)

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ parts, const int* __restrict__ m,
                    float* __restrict__ out, int N, int n) {
  extern __shared__ int ms[];
  const int b = blockIdx.x;
  const int* row = m + static_cast<size_t>(b) * N;
  if (kStaged) {
    for (int e = threadIdx.x; e < N; e += blockDim.x) ms[e] = row[e];
    __syncthreads();
    row = ms;
  }
  const int end = min(N, (blockIdx.y + 1) * kSlots);
  for (int i = blockIdx.y * kSlots + threadIdx.x; i < end; i += blockDim.x) {
    int lo = 0, hi = N;  // the first j with row[j] > i lies in [lo, hi]; N: none
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] > i)
        hi = mid;
      else
        lo = mid + 1;
    }
    float* dst = out + (static_cast<size_t>(b) * N + i) * n;
    if (lo == N) {
      for (int c = 0; c < n; ++c) dst[c] = 0.0f;
    } else {
      const float* src = parts + (static_cast<size_t>(b) * N + lo) * n;
      for (int c = 0; c < n; ++c) dst[c] = src[c];
    }
  }
}

}  // namespace pf_resample

// out (B, N, n) from parts (B, N, n) fp32 and the slot boundaries m (B, N)
// int32, row-major contiguous on the device. Returns the CUDA error code of
// the launch.
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
