// Fused batched Kalman mean pass (K9): the whole-horizon mean recurrence of
// a Kalman filter whose gains are shared by every trajectory.
//
// Replaces the TPU kernel numpower_tpu/kernels/kalman_batched.py
// kalman_mean_pass_pallas (_kf_mean_kernel). The covariance recursion of
// models/estimation.kalman_filter_batched (or kalman_filter_sqrt_batched)
// does not depend on the data and runs once outside; this kernel runs, for
// every trajectory s and step t,
//     x_p = A x + u_t,  v = y_t - C x_p,  x = x_p + v W_t,
//     alpha = invL_t v,  ll -= 0.5 |alpha|^2 + cst_t,
// with cst_t = logdet_t + 0.5 p log 2pi formed by the wrapper (the TPU
// kernel's algebra: the constant is subtracted once per step). It writes
// xs_f, xs_p (T, N, n) and ll (N,), the JAX package's time-major layout.
//
// n and p enter as compile-time buckets NB, PB (2/4/8/16 and 1/2/4/8) over
// zero padding, so every loop unrolls with no runtime guard on the
// arithmetic (K5's lesson): A, C, W_t and invL_t are padded with zeros and
// the padded components stay exactly zero.
//
// What bounded the first design (one thread a trajectory, 64 a block, the
// horizon staged in chunks of min(64, T) steps; probes/ekf_kalman.py at
// N = 4096, T = 50, n = 2, p = 1, stamped cycles a thread of 26,400): the
// chain (9,100, 182 a step), the stores (6,800), the y rows copied as
// 4-byte cp.async's, each index a runtime divide, and waited for in full
// before the first step (5,300; 15,100 with inputs), and the gains staged
// by a loop of 4-byte loads and runtime divides (3,800), nothing overlapped:
// at T = 50 the horizon was one chunk. One warp a block runs alone on its
// SM, so every dependent instruction's latency is exposed. Now:
//   - a block is one warp, 32 trajectories a lane each (128 blocks at
//     N = 4096);
//   - the horizon is staged in chunks of C steps (16 for the small
//     buckets), two chunks ahead, a buffer a chunk, by 4-byte cp.async's
//     with no divide at run time and no branch: each chunk's gains copied
//     straight into one zero-padded record a step (W_t (PB x NB), invL_t
//     (PB x PB), cst_t; the padding by cp.async's zero fill), read by the
//     step at compile-time offsets as broadcasts; each lane copies its own
//     y and u values, any alignment (N = 1003, misaligned views);
//   - a whole chunk's steps are unrolled for the small buckets, so their
//     loads and stores leave the chain (past them the hoisted loads would
//     spill);
//   - no load or store sits under a branch (each one compiled to a
//     convergence barrier, BSSY/BSYNC, on an intermediate tree): lanes past
//     N run trajectory N - 1 again and store its values at its addresses,
//     and a padded component stores its zero before the real one lands;
//   - A and C are held in registers for NB <= 4 (read from shared memory at
//     every use past it);
//   - the shared memory is static (under 48 KB for every bucket), so a
//     launch sets no function attribute.
// Every sum over the real components is the first port's, operation for
// operation. Measured away (probes/ekf_kalman.py and ekf_kalman_ablation.py
// on intermediate trees, H100; 5.2 us for this design): each step's rows as
// 16-byte copies of their aligned spans, the gains laid out after landing,
// the stores under branches, 10.2 us; the row copies without zero fill and
// the padding selected away in the step, 5.6 us; chunks of 8 or 32 steps,
// 5.5 and 6.5 us (32 spills).
//
// The probe builds this file with the NPT_STAMP macros filled in (the
// parts: 0 A, C and x0, 1 the start of a chunk's copies, 2 the wait for a
// chunk, 3 the chunk's steps, their chain and stores together: unrolled,
// they overlap); here they are empty.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_WAIT(v)
#define NPT_STAMP_END
#endif

namespace kalman_mean {

constexpr int kWarp = 32;  // trajectories a block, one lane each

// The shared layout of bucket (NB, PB) for chunks of C steps: two buffers,
// each the chunk's gains as one zero-padded record a step (W_t (PB x NB),
// invL_t (PB x PB), cst_t) and each lane's rows of y_t (PB) and u_t (NB), a
// step at a time; A and C past the register buckets.
template <int NB, int PB>
struct Shape {
  static constexpr int kRec = (PB * NB + PB * PB + 1 + 3) / 4 * 4;  // a record, padded
  static constexpr int kL = PB * NB, kc = PB * NB + PB * PB;        // offsets in a record
  __host__ __device__ static constexpr int step_floats() { return kRec + kWarp * (PB + NB); }
  // steps a chunk: 16, halved while the two buffers pass 32 KB
  __host__ __device__ static constexpr int chunk() {
    int C = 16;
    while (C > 1 && 2 * C * step_floats() * 4 > 32 * 1024) C /= 2;
    return C;
  }
};

template <int NB, int PB>
struct Layout : Shape<NB, PB> {
  using Sh = Shape<NB, PB>;
  static constexpr int kC = Sh::chunk();
  static constexpr int oY = kC * Sh::kRec;          // (kC, 32, PB)
  static constexpr int oU = oY + kC * kWarp * PB;   // (kC, 32, NB)
  static constexpr int kBuf = oU + kC * kWarp * NB;
  static constexpr bool kRegs = NB <= 4;  // A and C in registers
  // steps of a whole chunk unrolled: all of them for the smallest buckets;
  // past them the unrolled steps' hoisted loads would spill
  static constexpr int kStepUnroll = NB * (NB + PB) <= 8 ? kC : NB * (NB + PB) <= 24 ? 4 : 1;
  static constexpr int kCopyUnroll = NB <= 4 ? 4 : 1;  // the staging's loops, likewise
  static constexpr int kFloats = 2 * kBuf + (kRegs ? 0 : NB * NB + PB * NB);
};

// One float from src into shared memory at dst by a 4-byte cp.async, or a
// zero (nothing read) where `valid` is false; src must be a valid address.
__device__ __forceinline__ void copy_or_zero(float* dst, const float* src, bool valid) {
  __pipeline_memcpy_async(dst, src, sizeof(float), valid ? 0 : sizeof(float));
}

template <int NB, int PB>
__global__ void __launch_bounds__(kWarp, 1)
    kalman_mean_kernel(const float* __restrict__ A, const float* __restrict__ C,
                       const float* __restrict__ W, const float* __restrict__ iL,
                       const float* __restrict__ cst, const float* __restrict__ x0s,
                       const float* __restrict__ ys, const float* __restrict__ us,
                       float* __restrict__ xf, float* __restrict__ xp, float* __restrict__ ll_out,
                       int N, int T, int n, int p) {
  using Lo = Layout<NB, PB>;
  constexpr int kC = Lo::kC, kRec = Lo::kRec;
  __shared__ __align__(16) float sm[Lo::kFloats];
  float* const sA = sm + 2 * Lo::kBuf;  // (NB, NB), (PB, NB) past the register buckets
  float* const sC = sA + NB * NB;
  NPT_STAMP_BEGIN;
  const int lane = threadIdx.x;
  // lanes past the batch's end run its last trajectory again, so that every
  // load and store below is valid with no branch (a store under a branch
  // compiled to a convergence barrier, BSSY/BSYNC, around each store); they
  // store the same values at the same addresses
  const int s = min(static_cast<int>(blockIdx.x) * kWarp + lane, N - 1);
  const bool has_u = us != nullptr;

  // Chunk c into buffer c % 2: the records of its steps and the lane's own
  // y and u values, a 4-byte copy each, the padding (r >= p, j >= n and a
  // record's tail) zero-filled (a step past T copies step T - 1's, unread)
  auto stage_chunk = [&](int c) {
    const int t0 = c * kC;
    if (t0 < T) {
      float* const buf = sm + (c & 1) * Lo::kBuf;
#pragma unroll (Lo::kCopyUnroll)
      for (int i = 0; i < (kC * kRec + kWarp - 1) / kWarp; ++i) {
        const int z = min(lane + i * kWarp, kC * kRec - 1), tt = z / kRec, k = z - tt * kRec;
        const int t = min(t0 + tt, T - 1);
        const bool in_w = k < Lo::kL, in_l = !in_w && k < Lo::kc;
        const int r = in_w ? k / NB : (k - Lo::kL) / PB;
        const int j = in_w ? k % NB : (k - Lo::kL) % PB;
        const bool valid = in_w ? (r < p && j < n) : in_l ? (r < p && j < p) : k == Lo::kc;
        const float* const src = in_w   ? W + (static_cast<size_t>(t) * p + r) * n + j
                                 : in_l ? iL + (static_cast<size_t>(t) * p + r) * p + j
                                        : cst + t;
        copy_or_zero(buf + z, valid ? src : cst, valid);
      }
#pragma unroll (Lo::kCopyUnroll)
      for (int tt = 0; tt < kC; ++tt) {
        const size_t row = static_cast<size_t>(min(t0 + tt, T - 1)) * N + s;
#pragma unroll
        for (int r = 0; r < PB; ++r)
          copy_or_zero(buf + Lo::oY + (tt * kWarp + lane) * PB + r, ys + row * p + min(r, p - 1),
                       r < p);
      }
      if (has_u) {
#pragma unroll (Lo::kCopyUnroll)
        for (int tt = 0; tt < kC; ++tt) {
          const size_t row = static_cast<size_t>(min(t0 + tt, T - 1)) * N + s;
#pragma unroll
          for (int j = 0; j < NB; ++j)
            copy_or_zero(buf + Lo::oU + (tt * kWarp + lane) * NB + j,
                         us + row * n + min(j, n - 1), j < n);
        }
      }
    }
    __pipeline_commit();
  };

  float Ar[Lo::kRegs ? NB * NB : 1], Cr[Lo::kRegs ? PB * NB : 1];
  if constexpr (Lo::kRegs) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int c = 0; c < NB; ++c) Ar[r * NB + c] = (r < n && c < n) ? A[r * n + c] : 0.0f;
#pragma unroll
    for (int r = 0; r < PB; ++r)
#pragma unroll
      for (int c = 0; c < NB; ++c) Cr[r * NB + c] = (r < p && c < n) ? C[r * n + c] : 0.0f;
  } else {
    for (int e = lane; e < NB * NB; e += kWarp) {
      const int r = e / NB, c = e % NB;
      sA[e] = (r < n && c < n) ? A[r * n + c] : 0.0f;
    }
    for (int e = lane; e < PB * NB; e += kWarp) {
      const int r = e / NB, c = e % NB;
      sC[e] = (r < p && c < n) ? C[r * n + c] : 0.0f;
    }
  }
  // past the register buckets A and C are read from shared memory at every
  // use (volatile: hoisted out of a chunk's steps they would spill)
  const volatile float* const vA = sA;
  const volatile float* const vC = sC;
  auto a_at = [&](int r, int c) {
    if constexpr (Lo::kRegs) return Ar[r * NB + c];
    else return vA[r * NB + c];
  };
  auto c_at = [&](int r, int c) {
    if constexpr (Lo::kRegs) return Cr[r * NB + c];
    else return vC[r * NB + c];
  };
  float x[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) x[j] = j < n ? x0s[static_cast<size_t>(s) * n + j] : 0.0f;
  float ll = 0.0f;
  NPT_WAIT(x[0] + a_at(0, 0) + c_at(0, 0));
  NPT_STAMP(0);

  // Chunk c runs once chunk c + 1 is in flight, then stages chunk c + 2 into
  // its buffer; chunks -2 and -1 only stage chunks 0 and 1, so that the
  // staging has one call site.
  for (int c = -2, t0 = -2 * kC; t0 < T; ++c, t0 += kC) {
    if (c >= 0) {
      const int steps = min(kC, T - t0);
      const float* const buf = sm + (c & 1) * Lo::kBuf;
      __pipeline_wait_prior(1);  // chunk c's copies; chunk c + 1's may be in flight
      __syncwarp();
      NPT_STAMP(2);

      // One step: x_p = A x + u, v = y - C x_p, x = x_p + v W, ll, the stores.
      // The stores run from the last component down, a padded one (j >= n)
      // storing its zero at n - 1 first, so that the real one lands last:
      // no branch.
      auto step = [&](int tt) {
        const float* const g = buf + tt * kRec;
        const float* const yv = buf + Lo::oY + (tt * kWarp + lane) * PB;
        const float* const uv = buf + Lo::oU + (tt * kWarp + lane) * NB;
        float xpv[NB], v[PB];
#pragma unroll
        for (int j = 0; j < NB; ++j) {  // x_p = A x + u
          float acc = a_at(j, 0) * x[0];
#pragma unroll
          for (int i = 1; i < NB; ++i) acc = acc + a_at(j, i) * x[i];
          if (has_u) acc = acc + uv[j];  // zero past n
          xpv[j] = acc;
        }
#pragma unroll
        for (int r = 0; r < PB; ++r) {  // v = y - C x_p (y zero past p)
          float acc = yv[r];
#pragma unroll
          for (int j = 0; j < NB; ++j) acc = acc - c_at(r, j) * xpv[j];
          v[r] = acc;
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {  // x_f = x_p + v W
          float acc = xpv[j];
#pragma unroll
          for (int r = 0; r < PB; ++r) acc = acc + g[r * NB + j] * v[r];
          x[j] = acc;
        }
        float sq = 0.0f;  // |invL v|^2
#pragma unroll
        for (int r = 0; r < PB; ++r) {
          float a = g[Lo::kL + r * PB] * v[0];
#pragma unroll
          for (int f = 1; f < PB; ++f) a = a + g[Lo::kL + r * PB + f] * v[f];
          sq = sq + a * a;
        }
        ll = ll - 0.5f * sq - g[Lo::kc];
        const size_t row = (static_cast<size_t>(t0 + tt) * N + s) * n;
#pragma unroll
        for (int j = NB - 1; j >= 0; --j) {
          xf[row + min(j, n - 1)] = x[j];
          xp[row + min(j, n - 1)] = xpv[j];
        }
      };
      if (steps == kC) {  // a whole chunk: unrolled, so its loads and stores leave the chain
#pragma unroll (Lo::kStepUnroll)
        for (int tt = 0; tt < kC; ++tt) step(tt);
      } else {
        for (int tt = 0; tt < steps; ++tt) step(tt);
      }
      NPT_STAMP(3);
      __syncwarp();  // the chunk's buffer read by every lane
    }
    stage_chunk(c + 2);
    NPT_STAMP(1);
  }
  ll_out[s] = ll;
  NPT_STAMP_END;
}

template <int NB, int PB>
int launch(const float* A, const float* C, const float* W, const float* iL, const float* cst,
           const float* x0s, const float* ys, const float* us, float* xf, float* xp, float* ll,
           int N, int T, int n, int p, cudaStream_t stream) {
  static_assert(Layout<NB, PB>::kFloats * sizeof(float) <= 48 * 1024,
                "K9's block fits the static shared memory of a plain launch");
  kalman_mean_kernel<NB, PB><<<(N + kWarp - 1) / kWarp, kWarp, 0, stream>>>(
      A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_p(const float* A, const float* C, const float* W, const float* iL, const float* cst,
             const float* x0s, const float* ys, const float* us, float* xf, float* xp, float* ll,
             int N, int T, int n, int p, cudaStream_t st) {
  if (p <= 1) return launch<NB, 1>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (p <= 2) return launch<NB, 2>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (p <= 4) return launch<NB, 4>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  return launch<NB, 8>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
}

}  // namespace kalman_mean

// xs_f, xs_p (T, N, n) and ll (N,) from A (n, n), C (p, n), W (T, p, n),
// invL (T, p, p), cst (T,), x0s (N, n), ys (T, N, p) and us (T, N, n) or
// null; all fp32, row-major contiguous, on the device; 1 <= n <= 16,
// 1 <= p <= 8. Returns the CUDA error code of the launch.
extern "C" int npt_kalman_mean(const float* A, const float* C, const float* W, const float* iL,
                               const float* cst, const float* x0s, const float* ys,
                               const float* us, float* xf, float* xp, float* ll, int N, int T,
                               int n, int p, void* stream) {
  using namespace kalman_mean;
  if (N < 1 || T < 1 || n < 1 || n > 16 || p < 1 || p > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 2) return launch_p<2>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (n <= 4) return launch_p<4>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  if (n <= 8) return launch_p<8>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
  return launch_p<16>(A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, N, T, n, p, st);
}
