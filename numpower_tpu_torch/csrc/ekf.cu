// Fused whole-horizon batched EKF (K11): one launch runs the extended
// Kalman filter of every trajectory over the whole horizon, the plant and
// the measurement in the kernel.
//
// Replaces the TPU kernel numpower_tpu/kernels/ekf.py ekf_pallas
// (_ekf_kernel), in its order of operations:
//  1. the forward-mode derivative of the plant at the filtered state in
//     every basis tangent: column i of A = df/dx; the value is the
//     prediction x_p (the TPU kernel's jax.jvp calls, ekf.py:53-64);
//  2. P_p = A P A' + Q, its upper triangle computed and mirrored;
//  3. the derivative of the measurement at x_p: C = dh/dx and h(x_p);
//  4. S = C P_p C' + R (upper triangle, mirrored), its row Cholesky with the
//     inverse diagonal cached (rsqrtf, where the TPU kernel has lax.rsqrt;
//     CUDA's rsqrtf is within 2 ulp);
//  5. W = S^-1 C P_p by forward and backward substitution;
//  6. x_f = x_p + W'v, P_f = P_p - W' C P_p (upper triangle, mirrored: no
//     0.5 (P + P') as models/estimation.ekf_filter takes), and the
//     Cholesky-whitened innovation log-density.
// It writes xs_f, xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n) and ll (B,), the
// JAX package's layout.
//
// The derivatives. CUDA cannot trace a torch function, so the plant and the
// measurement are the registered device twins of csrc/plants.cuh, run on
// plants::Dual<n> numbers: the value and n tangents, with JAX's jvp rules
// per operation. One evaluation of f a step gives x_p and every column of
// A, one of h gives h(x_p) and C. The value part is the float plant
// operation for operation, so x_p is f(x, u) exactly as K8 computes it, and
// each tangent is the operations of a single-tangent pass, so A and C are
// those of the first port's n passes bit for bit.
//
// What bounded the first design (one thread a trajectory, one warp a block,
// probes/ekf_kalman.py at B = 1024, T = 50, stamped cycles a step on the
// pendulum / planar quadrotor): the n plant passes (372 / 6,348), the wait
// for the next step's inputs loaded one step ahead (~150-200 / ~800), the
// 2n + 2n^2 scattered 4-byte stores (101 / 3,378: each warp store touching
// 32 lines), and 32 one-warp blocks on 132 SMs. Now:
//   - a group of G lanes takes one trajectory (4 for n <= 2, else 8) and a
//     block is one warp, so the bench's 1,024 trajectories are 4,096 or
//     8,192 threads in 128 or 256 blocks;
//   - every lane evaluates f and h once on Dual<n> and runs the update
//     itself, in the first port's order of summation (K12's lesson: on a
//     step this short an exchange between the lanes costs more than the
//     arithmetic it spreads), so the group's lanes hold the same state bit
//     for bit and the results are the first port's;
//   - the inputs are staged two chunks of C = 16 steps ahead by 16-byte
//     cp.async (csrc/async_copy.cuh), a buffer a chunk, as K12 stages them;
//   - each step's outputs are stored straight from the registers, spread
//     over the group by a select tree with no store under a branch
//     (async_copy::store_spread): a step is 4 stores a lane on the
//     pendulum, 12 on the planar quadrotor, the group on consecutive
//     addresses.
// The accurate sinf and cosf stay (the plain version's accuracy class); the
// compiler had already merged the first port's repeated sin and cos of the
// one angle of each plant into one range reduction a step, as it does here
// (probes/ekf_kalman.py reads the SASS). Measured away
// (probes/ekf_kalman_ablation.py, H100): the step loop unrolled by two, 14.8
// us against 14.1 on the pendulum and 107 against 64-69 on the planar
// quadrotor.
//
// The probe builds this file with the NPT_STAMP macros filled in (the parts
// of a step: 0 f on Dual<n> (A, x_p), 1 A P A' + Q, 2 h on Dual<n> (C,
// h(x_p)), 3 S and its factor, 4 the substitutions, x_f, P_f and the
// log-density, 5 the stores; 6 the set-up and the input staging); here
// they are empty.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "plants.cuh"

#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_WAIT(v)
#define NPT_STAMP_END
#endif

namespace ekf {

constexpr int kWarp = 32;   // threads a block
constexpr int kChunk = 16;  // steps a staged chunk (C)

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Args {
  const float *Q, *R, *P0, *x0s, *yss, *uss;
  float *xf, *xp, *Pf, *Pp, *ll;
  int B, T;
};

// Lanes a trajectory: enough to store the pendulum's step (2 + 2 + 4 + 4
// floats) as one float a lane an array, 8 past it.
__host__ __device__ constexpr int group_lanes(int n) { return n <= 2 ? 4 : 8; }

// Shared floats of one group: two input buffers, each the u and y runs of
// a chunk (each run at any 4-byte alignment).
template <int m, int p>
struct Stage {
  static constexpr int kU = async_copy::slot_floats(kChunk * m);
  static constexpr int kIn = kU + async_copy::slot_floats(kChunk * p);
  static constexpr int kFloats = 2 * kIn;
};

template <int P, int H, int p>
__global__ void __launch_bounds__(kWarp, 1) ekf_kernel(PlantParams params, Args a) {
  using F = plants::Plant<P>;
  using D = plants::Dual<F::n>;
  using St = Stage<F::m, p>;
  constexpr int n = F::n, m = F::m, G = group_lanes(n), kGroups = kWarp / G;
  __shared__ __align__(16) float stage_sm[kGroups * St::kFloats];
  NPT_STAMP_BEGIN;
  const int lane = threadIdx.x, k = lane % G, grp = lane / G;
  const int b = blockIdx.x * kGroups + grp;
  if (b >= a.B) return;  // a whole group: its barriers name its own lanes only
  const unsigned mask = ((1u << G) - 1u) << (grp * G);
  const int T = a.T;
  float* const sm = stage_sm + grp * St::kFloats;
  const float* const ub = a.uss + static_cast<size_t>(b) * T * m;
  const float* const yb = a.yss + static_cast<size_t>(b) * T * p;
  auto stage_chunk = [&](int c) {  // the inputs of chunk c into buffer c % 2
    const int t0 = c * kChunk;
    if (t0 < T) {
      float* const buf = sm + (c & 1) * St::kIn;
      const int steps = min(kChunk, T - t0);
      async_copy::copy_run_by_block(buf, ub + t0 * m, steps * m, k, G);
      async_copy::copy_run_by_block(buf + St::kU, yb + t0 * p, steps * p, k, G);
    }
    __pipeline_commit();
  };
  stage_chunk(0);
  stage_chunk(1);

  float par[plants::kMaxParams];
#pragma unroll
  for (int e = 0; e < plants::kMaxParams; ++e) par[e] = params.v[e];
  const float c0 = static_cast<float>(p) * logf(6.28318530717958647692f);
  float Qu[n][n], Ru[p][p];  // upper triangles
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = i; j < n; ++j) Qu[i][j] = a.Q[i * n + j];
#pragma unroll
  for (int i = 0; i < p; ++i)
#pragma unroll
    for (int j = i; j < p; ++j) Ru[i][j] = a.R[i * p + j];
  float x[n], Pm[n][n];
#pragma unroll
  for (int j = 0; j < n; ++j) x[j] = a.x0s[static_cast<size_t>(b) * n + j];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) Pm[i][j] = a.P0[i * n + j];
  float ll = 0.0f;
  NPT_WAIT(x[0] + Pm[0][0]);
  NPT_STAMP(6);

  for (int c = 0, t0 = 0; t0 < T; ++c, t0 += kChunk) {
    const int steps = min(kChunk, T - t0);
    __pipeline_wait_prior(1);  // chunk c's copies; chunk c + 1's may be in flight
    __syncwarp(mask);
    const float* const us = sm + (c & 1) * St::kIn + async_copy::run_offset(ub + t0 * m);
    const float* const ys =
        sm + (c & 1) * St::kIn + St::kU + async_copy::run_offset(yb + t0 * p);
    NPT_STAMP(6);
    for (int tc = 0; tc < steps; ++tc) {
      float u[m], y[p];
#pragma unroll
      for (int e = 0; e < m; ++e) u[e] = us[tc * m + e];
#pragma unroll
      for (int e = 0; e < p; ++e) y[e] = ys[tc * p + e];

      // 1. x_p and the columns of A by one evaluation of f on Dual<n>
      float A[n][n], xpv[n];
      {
        D xd[n], fd[n];
        plants::seed(x, xd);
        F::step(xd, u, par, fd);
#pragma unroll
        for (int j = 0; j < n; ++j) {
          xpv[j] = fd[j].v;
#pragma unroll
          for (int i = 0; i < n; ++i) A[j][i] = fd[j].t[i];
        }
      }
      NPT_STAMP(0);
      // 2. P_p = A P A' + Q
      float AP[n][n], Pp[n][n];
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int l = 0; l < n; ++l) {
          float acc = A[i][0] * Pm[0][l];
#pragma unroll
          for (int q = 1; q < n; ++q) acc = acc + A[i][q] * Pm[q][l];
          AP[i][l] = acc;
        }
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = i; j < n; ++j) {
          float acc = AP[i][0] * A[j][0];
#pragma unroll
          for (int l = 1; l < n; ++l) acc = acc + AP[i][l] * A[j][l];
          acc = acc + Qu[i][j];
          Pp[i][j] = acc;
          Pp[j][i] = acc;
        }
      NPT_STAMP(1);
      // 3. h(x_p) and the columns of C by one evaluation of h on Dual<n>
      float Cm[p][n], yhat[p];
      {
        D xd[n], hd[p];
        plants::seed(xpv, xd);
        plants::Measure<H>::template eval<p>(xd, hd);
#pragma unroll
        for (int r = 0; r < p; ++r) {
          yhat[r] = hd[r].v;
#pragma unroll
          for (int i = 0; i < n; ++i) Cm[r][i] = hd[r].t[i];
        }
      }
      NPT_STAMP(2);
      // 4. S = C P_p C' + R and its row Cholesky
      float CP[p][n], S[p][p];
#pragma unroll
      for (int r = 0; r < p; ++r)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          float acc = Cm[r][0] * Pp[0][j];
#pragma unroll
          for (int q = 1; q < n; ++q) acc = acc + Cm[r][q] * Pp[q][j];
          CP[r][j] = acc;
        }
#pragma unroll
      for (int i = 0; i < p; ++i)
#pragma unroll
        for (int j = i; j < p; ++j) {
          float acc = CP[i][0] * Cm[j][0];
#pragma unroll
          for (int q = 1; q < n; ++q) acc = acc + CP[i][q] * Cm[j][q];
          acc = acc + Ru[i][j];
          S[i][j] = acc;
          S[j][i] = acc;
        }
      float L[p][p], Linv[p];
#pragma unroll
      for (int j = 0; j < p; ++j) {
        float acc = S[j][j];
#pragma unroll
        for (int q = 0; q < j; ++q) acc = acc - L[j][q] * L[j][q];
        const float inv = rsqrtf(acc);
        L[j][j] = acc * inv;
        Linv[j] = inv;
#pragma unroll
        for (int i = j + 1; i < p; ++i) {
          float acc2 = S[i][j];
#pragma unroll
          for (int q = 0; q < j; ++q) acc2 = acc2 - L[i][q] * L[j][q];
          L[i][j] = acc2 * inv;
        }
      }
      NPT_STAMP(3);
      // 5. W = S^-1 CP: forward (L G = CP), then backward (L' W = G)
      float Gm[p][n], W[p][n];
#pragma unroll
      for (int i = 0; i < p; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          float acc = CP[i][j];
#pragma unroll
          for (int q = 0; q < i; ++q) acc = acc - L[i][q] * Gm[q][j];
          Gm[i][j] = acc * Linv[i];
        }
#pragma unroll
      for (int i = p - 1; i >= 0; --i)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          float acc = Gm[i][j];
#pragma unroll
          for (int q = i + 1; q < p; ++q) acc = acc - L[q][i] * W[q][j];
          W[i][j] = acc * Linv[i];
        }
      // 6. the update and the innovation log-density
      float v[p];
#pragma unroll
      for (int r = 0; r < p; ++r) v[r] = y[r] - yhat[r];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = xpv[j];
#pragma unroll
        for (int r = 0; r < p; ++r) acc = acc + W[r][j] * v[r];
        x[j] = acc;
      }
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = i; j < n; ++j) {
          float acc = Pp[i][j];
#pragma unroll
          for (int r = 0; r < p; ++r) acc = acc - W[r][i] * CP[r][j];
          Pm[i][j] = acc;
          Pm[j][i] = acc;
        }
      float sq = 0.0f, logdet = 0.0f;
      float al[p];
#pragma unroll
      for (int i = 0; i < p; ++i) {
        float acc = v[i];
#pragma unroll
        for (int q = 0; q < i; ++q) acc = acc - L[i][q] * al[q];
        al[i] = acc * Linv[i];
        sq = sq + al[i] * al[i];
        logdet = logdet + logf(L[i][i]);
      }
      ll = ll - 0.5f * (sq + c0) - logdet;
      NPT_STAMP(4);

      // the step's outputs, spread over the group's lanes
      const size_t row = static_cast<size_t>(b) * T + t0 + tc;
      float pf[n * n], pp[n * n];
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          pf[i * n + j] = Pm[i][j];
          pp[i * n + j] = Pp[i][j];
        }
      async_copy::store_spread<G>(a.xf + row * n, x, k);
      async_copy::store_spread<G>(a.xp + row * n, xpv, k);
      async_copy::store_spread<G>(a.Pf + row * n * n, pf, k);
      async_copy::store_spread<G>(a.Pp + row * n * n, pp, k);
      NPT_STAMP(5);
    }
    __syncwarp(mask);  // the chunk's input buffer read by every lane
    stage_chunk(c + 2);
    NPT_STAMP(6);
  }
  if (k == 0) a.ll[b] = ll;
  NPT_STAMP_END;
}

template <int P, int H, int p>
int launch(const PlantParams& params, const Args& a, cudaStream_t stream) {
  using F = plants::Plant<P>;
  constexpr int kGroups = kWarp / group_lanes(F::n);
  static_assert(kGroups * Stage<F::m, p>::kFloats * sizeof(float) <= 48 * 1024,
                "K11's block fits the static shared memory of a plain launch");
  ekf_kernel<P, H, p><<<(a.B + kGroups - 1) / kGroups, kWarp, 0, stream>>>(params, a);
  return static_cast<int>(cudaGetLastError());
}

// The measurement widths of plant P: p = 1 .. n (n <= 8).
template <int P, int H>
int launch_p(int p, const PlantParams& params, const Args& a, cudaStream_t st) {
  constexpr int n = plants::Plant<P>::n;
  switch (p) {
    case 1:
      return launch<P, H, 1>(params, a, st);
    case 2:
      if constexpr (n >= 2) return launch<P, H, 2>(params, a, st);
      break;
    case 3:
      if constexpr (n >= 3) return launch<P, H, 3>(params, a, st);
      break;
    case 4:
      if constexpr (n >= 4) return launch<P, H, 4>(params, a, st);
      break;
    case 5:
      if constexpr (n >= 5) return launch<P, H, 5>(params, a, st);
      break;
    case 6:
      if constexpr (n >= 6) return launch<P, H, 6>(params, a, st);
      break;
    case 7:
      if constexpr (n >= 7) return launch<P, H, 7>(params, a, st);
      break;
    case 8:
      if constexpr (n >= 8) return launch<P, H, 8>(params, a, st);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ekf

// xs_f, xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n), ll (B,) from the plant index
// and its parameter floats p0..p7, the measurement index and its width p
// (1..n), Q (n, n), R (p, p), P0 (n, n), x0s (B, n), yss (B, T, p),
// uss (B, T, m); all fp32, row-major contiguous, on the device; n and m are
// the plant's. Returns the CUDA error code of the launch.
extern "C" int npt_ekf(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                       float p6, float p7, int measure, int p, const float* Q, const float* R,
                       const float* P0, const float* x0s, const float* yss, const float* uss,
                       float* xf, float* xp, float* Pf, float* Pp, float* ll, int B, int T,
                       void* stream) {
  using namespace ekf;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (B < 1 || T < 1 || measure != 0) return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const Args a{Q, R, P0, x0s, yss, uss, xf, xp, Pf, Pp, ll, B, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case 0: return launch_p<0, 0>(p, params, a, st);
    case 1: return launch_p<1, 0>(p, params, a, st);
    case 2: return launch_p<2, 0>(p, params, a, st);
    case 3: return launch_p<3, 0>(p, params, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
