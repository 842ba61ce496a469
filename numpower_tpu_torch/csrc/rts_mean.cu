// Fused batched RTS mean pass (K10): the whole-horizon backward mean
// recurrence of a Rauch-Tung-Striebel smoother whose gains are shared by
// every trajectory.
//
// Replaces the TPU kernel numpower_tpu/kernels/rts_batched.py
// rts_mean_pass_pallas (_rts_mean_kernel). models/estimation.
// kalman_smoother_batched forms the shared gains G_t' and the batch-parallel
// affine terms e_t = x_f[t] - x_p[t+1] G_t' outside; this kernel runs, for
// every trajectory, x_s[T-1] = x_f[T-1] and for t = T-2 .. 0
//     x_s[t][k] = e_t[k] + sum_i G_t'[i][k] x_s[t+1][i],
// and writes xs (T, N, n) in forward time order (the JAX package's layout).
// n enters as a compile-time bucket NB (2/4/8/16) over zero padding: G_t'
// is padded with zeros and the padded components of x stay exactly zero.
//
// What bounded the first design (one thread a trajectory, 64 a block, the
// horizon staged in one chunk of min(64, T - 1) steps; probes/rts_mean.py
// at N = 4096, T = 50, n = 2, stamped cycles a thread of 23,500): the e_t
// rows copied as 4-byte cp.async's, each index a runtime divide, and waited
// for in full before the first step (12,900), the gains staged by a loop of
// 4-byte loads and runtime divides (1,650), the chain (4,000) and the
// stores under branches (4,000): at T = 50 nothing overlapped. This is K9's
// design (csrc/kalman_mean.cu) run backward in time:
//   - a block is one warp, 32 trajectories a lane each (128 blocks at
//     N = 4096);
//   - the horizon is staged in chunks of C steps (16 for the small
//     buckets), descending from t = T - 2, two chunks ahead, a buffer a
//     chunk, by cp.async's with no divide at run time and no branch: each
//     chunk's gains copied straight into one zero-padded NB x NB record a
//     step (the padding by cp.async's zero fill), read by the step at
//     compile-time offsets as broadcasts; each lane copies its own e_t rows
//     (n = 2 with 8-byte aligned operands: one 8-byte copy a row and one
//     8-byte store, chosen at launch; any alignment otherwise). The last
//     chunk (the one that ends at t = 0) is the partial one;
//   - a whole chunk's steps are unrolled for n <= 2, so their loads and
//     stores leave the chain (the larger buckets run them rolled);
//   - no load or store sits under a branch: lanes past N run trajectory
//     N - 1 again and store its values at its addresses, and a padded
//     component stores its zero before the real one lands;
//   - the shared memory is static (under 48 KB for every bucket), so a
//     launch sets no function attribute.
// Every sum over the real components is the first port's, operation for
// operation.
//
// What bounds this design (H100, N = 4096, T = 50, n = 2: 2.68 us own
// against a 0.98 us bound of bytes, 4,434 stamped cycles a thread): the
// first chunk's latency (1,244 cycles with x_last's load and store) and
// the start of the copies, ~550 cycles a chunk for a lane's 18 copies; a
// step is 25 cycles. Measured away (probes/rts_mean.py ablate): n = 2 by
// 4-byte rows, 3.89 us; e_t read by __ldg a chunk ahead into registers, no
// shared memory for it, 3.62 us (28.9 against 19.7 at n = 8); chunks of 8
// steps, 2.79 us, of 32, 2.69 (no gain); the rolled loop at n = 2, 2.92 us;
// the gains' copies fully unrolled, 171-255 registers and 8.06 against
// 6.76 us at n = 4.
//
// The probe builds this file with the NPT_STAMP macros filled in (the
// parts: 0 the first two chunks' copies, x_last and its store, 1 a later
// chunk's copies, 2 the wait for a chunk, 3 the chunk's steps, their chain
// and stores together: unrolled, they overlap); here they are empty.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_WAIT(v)
#define NPT_STAMP_END
#endif

namespace rts_mean {

constexpr int kWarp = 32;  // trajectories a block, one lane each

// The shared layout of bucket NB for chunks of C steps: two buffers, each
// the chunk's gains as one zero-padded record a step (G_t' (NB x NB)) and
// each lane's rows of e_t (NB), a step at a time.
template <int NB>
struct Layout {
  static constexpr int kRec = NB * NB;
  __host__ __device__ static constexpr int step_floats() { return kRec + kWarp * NB; }
  // steps a chunk: 16, halved while the two buffers pass 32 KB
  __host__ __device__ static constexpr int chunk() {
    int C = 16;
    while (C > 1 && 2 * C * step_floats() * 4 > 32 * 1024) C /= 2;
    return C;
  }
  static constexpr int kC = chunk();
  static constexpr int oE = kC * kRec;  // (kC, 32, NB)
  static constexpr int kBuf = oE + kC * kWarp * NB;
  // a whole chunk's steps unrolled for n <= 2 only: past it the rolled loop
  // ran faster (probes/rts_mean.py, n = 4, 8, 16)
  static constexpr bool kWholeChunks = NB <= 2;
  // the staging's loops unrolled by 4 for n <= 4, not past it (fully
  // unrolled, the gains' copies took 171-255 registers)
  static constexpr int kCopyUnroll = NB <= 4 ? 4 : 1;
  static_assert(kC * kRec % kWarp == 0, "a chunk's records split evenly over the lanes");
};

// One float from src into shared memory at dst by a 4-byte cp.async, or a
// zero (nothing read) where `valid` is false; src must be a valid address.
__device__ __forceinline__ void copy_or_zero(float* dst, const float* src, bool valid) {
  __pipeline_memcpy_async(dst, src, sizeof(float), valid ? 0 : sizeof(float));
}

// kPair: n == 2 with es, x_last and xs 8-byte aligned, so that a lane's row
// is one 8-byte copy, load or store
template <int NB, bool kPair>
__global__ void __launch_bounds__(kWarp, 1)
    rts_mean_kernel(const float* __restrict__ G, const float* __restrict__ es,
                    const float* __restrict__ x_last, float* __restrict__ xs, int N, int T, int n) {
  using Lo = Layout<NB>;
  constexpr int kC = Lo::kC, kRec = Lo::kRec;
  static_assert(!kPair || NB == 2, "the 8-byte rows are n = 2's");
  __shared__ __align__(16) float sm[2 * Lo::kBuf];
  NPT_STAMP_BEGIN;
  const int lane = threadIdx.x;
  // lanes past the batch's end run its last trajectory again, so that every
  // load and store below is valid with no branch (a store under a branch
  // compiled to a convergence barrier, BSSY/BSYNC, around each store); they
  // store the same values at the same addresses
  const int s = min(static_cast<int>(blockIdx.x) * kWarp + lane, N - 1);

  // Chunk c into buffer c % 2: steps t = hi - tt, tt = 0 .. kC - 1, with
  // hi = T - 2 - c kC; the records of its steps and the lane's own e_t rows,
  // the padding (i >= n or k >= n, j >= n) zero-filled (a slot below step 0
  // copies step 0's, unread)
  auto stage_chunk = [&](int c) {
    const int hi = T - 2 - c * kC;
    if (hi >= 0) {
      float* const buf = sm + (c & 1) * Lo::kBuf;
#pragma unroll (Lo::kCopyUnroll)
      for (int q = 0; q < kC * kRec / kWarp; ++q) {
        const int z = lane + q * kWarp, tt = z / kRec, i = z % kRec / NB, k = z % NB;
        const bool valid = i < n && k < n;
        const float* const src =
            G + (static_cast<size_t>(max(hi - tt, 0)) * n + min(i, n - 1)) * n + min(k, n - 1);
        copy_or_zero(buf + z, src, valid);
      }
      float* const rows = buf + Lo::oE + lane * NB;
#pragma unroll (Lo::kCopyUnroll)
      for (int tt = 0; tt < kC; ++tt) {
        const size_t row = static_cast<size_t>(max(hi - tt, 0)) * N + s;
        if constexpr (kPair) {
          __pipeline_memcpy_async(rows + tt * kWarp * NB, es + row * 2, 2 * sizeof(float));
        } else {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            copy_or_zero(rows + tt * kWarp * NB + j, es + row * n + min(j, n - 1), j < n);
        }
      }
    }
    __pipeline_commit();
  };

  // x's components from the last down, a padded one (j >= n) storing its
  // zero at n - 1 first, so that the real one lands last: no branch
  auto store = [&](int t, const float (&x)[NB]) {
    const size_t row = static_cast<size_t>(t) * N + s;
    if constexpr (kPair) {
      *reinterpret_cast<float2*>(xs + row * 2) = make_float2(x[0], x[1]);
    } else {
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) xs[row * n + min(j, n - 1)] = x[j];
    }
  };

  stage_chunk(0);
  stage_chunk(1);
  float x[NB];
  if constexpr (kPair) {
    const float2 v = *reinterpret_cast<const float2*>(x_last + static_cast<size_t>(s) * 2);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float v = x_last[static_cast<size_t>(s) * n + min(j, n - 1)];
      x[j] = j < n ? v : 0.0f;
    }
  }
  store(T - 1, x);
  NPT_WAIT(x[0]);
  NPT_STAMP(0);

  // Chunk c runs once chunk c + 1 is in flight, then stages chunk c + 2 into
  // its buffer.
  for (int c = 0, hi = T - 2; hi >= 0; ++c, hi -= kC) {
    const int steps = min(kC, hi + 1);
    const float* const buf = sm + (c & 1) * Lo::kBuf;
    __pipeline_wait_prior(1);  // chunk c's copies; chunk c + 1's may be in flight
    __syncwarp();
    NPT_STAMP(2);

    // One step: x = x G_t' + e_t (e zero and G_t' zero past n), then its store.
    auto step = [&](int tt) {
      const float* const g = buf + tt * kRec;
      const float* const ev = buf + Lo::oE + (tt * kWarp + lane) * NB;
      float xn[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) xn[k] = ev[k];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int k = 0; k < NB; ++k) xn[k] = xn[k] + g[i * NB + k] * x[i];
#pragma unroll
      for (int k = 0; k < NB; ++k) x[k] = xn[k];
      store(hi - tt, x);
    };
    if (Lo::kWholeChunks && steps == kC) {  // unrolled: its loads and stores leave the chain
#pragma unroll
      for (int tt = 0; tt < kC; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < steps; ++tt) step(tt);
    }
    NPT_STAMP(3);
    __syncwarp();  // the chunk's buffer read by every lane
    stage_chunk(c + 2);
    NPT_STAMP(1);
  }
  NPT_STAMP_END;
}

template <int NB, bool kPair>
int launch(const float* G, const float* es, const float* x_last, float* xs, int N, int T, int n,
           cudaStream_t stream) {
  static_assert(2 * Layout<NB>::kBuf * sizeof(float) <= 48 * 1024,
                "K10's block fits the static shared memory of a plain launch");
  rts_mean_kernel<NB, kPair><<<(N + kWarp - 1) / kWarp, kWarp, 0, stream>>>(G, es, x_last, xs,
                                                                            N, T, n);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned8(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 8 == 0; }

}  // namespace rts_mean

// xs (T, N, n) from G (T-1, n, n) = the gains G_t', es (T-1, N, n) and
// x_last (N, n); all fp32, row-major contiguous, on the device; T >= 2,
// 1 <= n <= 16. Returns the CUDA error code of the launch.
extern "C" int npt_rts_mean(const float* G, const float* es, const float* x_last, float* xs, int N,
                            int T, int n, void* stream) {
  using namespace rts_mean;
  if (N < 1 || T < 2 || n < 1 || n > 16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 2 && aligned8(es) && aligned8(x_last) && aligned8(xs))
    return launch<2, true>(G, es, x_last, xs, N, T, n, st);
  if (n <= 2) return launch<2, false>(G, es, x_last, xs, N, T, n, st);
  if (n <= 4) return launch<4, false>(G, es, x_last, xs, N, T, n, st);
  if (n <= 8) return launch<8, false>(G, es, x_last, xs, N, T, n, st);
  return launch<16, false>(G, es, x_last, xs, N, T, n, st);
}
