// Cycle stamps for the iLQR kernels' probe (probes/ilqr_chain.py).
//
// A kernel marks the end of each part of its step with NPT_STAMP(part): the
// clock64() cycles since the previous stamp are added to that part's
// register accumulator. NPT_STAMP_END writes the accumulators (parts 0-6)
// and the thread's whole time (slot 7) to g_probe_stamps, eight 64-bit
// counters per thread, indexed by the thread's place in the grid. The
// production sources define the three macros away; the probe defines them
// here before it includes a source. The stamps cost a few cycles each and
// pin the order of memory operations around them, so a stamped step is a
// little slower than the kernel's own; the probe prints both times.

#pragma once

#include <cuda_runtime.h>

__device__ unsigned long long* g_probe_stamps;

extern "C" int probe_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_probe_stamps, &p, sizeof(p)));
}

#define NPT_STAMP_BEGIN                                 \
  long long npt_t0_ = clock64(), npt_last_ = npt_t0_;   \
  unsigned long long npt_acc_[7] = {0, 0, 0, 0, 0, 0, 0}

#define NPT_STAMP(part)                                 \
  do {                                                  \
    const long long npt_c_ = clock64();                 \
    npt_acc_[part] += npt_c_ - npt_last_;               \
    npt_last_ = npt_c_;                                 \
  } while (0)

#define NPT_STAMP_END                                                                       \
  do {                                                                                      \
    const size_t npt_g_ =                                                                   \
        (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x; \
    unsigned long long* npt_o_ = g_probe_stamps + npt_g_ * 8;                               \
    npt_o_[0] = npt_acc_[0];                                                                \
    npt_o_[1] = npt_acc_[1];                                                                \
    npt_o_[2] = npt_acc_[2];                                                                \
    npt_o_[3] = npt_acc_[3];                                                                \
    npt_o_[4] = npt_acc_[4];                                                                \
    npt_o_[5] = npt_acc_[5];                                                                \
    npt_o_[6] = npt_acc_[6];                                                                \
    npt_o_[7] = clock64() - npt_t0_;                                                        \
  } while (0)
