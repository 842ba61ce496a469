// Fused whole-horizon batched UKF (K12): one launch runs the unscented
// Kalman filter (Wan-Merwe sigma points) of every trajectory over the whole
// horizon, the plant and the measurement in the kernel.
//
// Replaces the TPU kernel numpower_tpu/kernels/ukf.py ukf_pallas
// (_ukf_kernel), in its order of operations (ukf.py:80-154):
//  1. 2n+1 sigma points x, x +- column i of S, S the row Cholesky of
//     c_sig 0.5 (P_ij + P_ji) plus a jitter of 1e-9 on the diagonal
//     (rsqrtf pivots, inverse diagonal cached; CUDA's rsqrtf is within
//     2 ulp of lax.rsqrt's exact value);
//  2. f at every point (the registered plant of csrc/plants.cuh); x_p the
//     wm-weighted sum, P_p the wc-weighted outer products plus Q (upper
//     triangle, mirrored);
//  3. the points redrawn from (x_p, P_p); h at each; y_p, S = the weighted
//     outer products plus R, Pxy the weighted cross products;
//  4. the row Cholesky of S, W = S^-1 Pxy' by forward and backward
//     substitution, x_f = x_p + W'v, P_f = P_p - W' S W (upper, mirrored),
//     and the Cholesky-whitened innovation log-density.
// The weights wm_0, wm_i, wc_0, wc_i and the spread c_sig 0.5 are folded in
// double on the host and rounded once, as the JAX package folds them in
// Python. It writes xs_f, xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n), ll (B,).
//
// What bounded the first design (K11's: one thread a trajectory, one warp a
// block; probes/chol_ukf.py on the pendulum at B = 1024, T = 50): the
// latency of one thread's chain of T steps, 1,200 cycles a step, 58% of it
// the spread factor and the 2n+1 plant evaluations (sinf) one after another;
// 32 one-warp blocks, so 100 of the 132 SMs idle; and 2n + 2n^2 scattered
// 4-byte stores a step (29% of the planar quadrotor's time). Now:
//   - a group of G lanes takes one trajectory, G the power of two >= 2n+1
//     (8 for the pendulum and the unicycle, 16 for the cartpole and the
//     planar quadrotor), and a block is one warp (32 / G trajectories), so
//     the bench's shape is 8,192 threads in 256 blocks over 132 SMs;
//   - lane k forms sigma point k and runs f on it (lanes past 2n take point
//     0); every lane gathers the 2n+1 images by K n shuffles, all in flight
//     together, and forms x_p and P_p itself, in the first port's order of
//     summation;
//   - the update is replicated in every lane: the redrawn points, h at each
//     (the registered measurement is a selection), y_p, S, Pxy, the factor
//     of S, the substitutions, x_f, P_f and ll, as K5 has factored S in
//     every lane; so the group exchanges nothing else, and the lanes' state
//     stays equal bit for bit;
//   - the inputs are staged two chunks of C = 16 steps ahead by 16-byte
//     cp.async (csrc/async_copy.cuh), a buffer a chunk;
//   - each step's outputs are stored straight from the registers, spread
//     over the group: lane k stores entries k, k + G, ... of x_f, x_p, P_f
//     and P_p, picked by a select tree on the bits of k, so a step is 4 to
//     8 stores a lane, the group's lanes on consecutive addresses.
// Every sum is the first port's, operation for operation, so the results
// are its results. Tried first (probes/chol_ukf.py on the pendulum, H100):
// x_p, P_p, y_p, S and Pxy as butterfly sums over the group, the update's
// point and h a lane: twelve levels of shuffles on each step's chain made
// it slower than the first port, 33.0 us against 29.3; each step's outputs
// written to shared memory by one lane and stored a chunk at a time as
// 16-byte pieces: 26.9 us, against 21.0 for the stores spread over the
// lanes from registers.
//
// The probe builds this file with the NPT_STAMP macros filled in (the parts
// of a step: 0 the spread factor, the sigma point, f and the gather, 1 the
// predicted moments, 2 the update's points, h and moments, 3 the factor of
// S, the substitutions, x_f, P_f and the log-density, 4 the stores; 5 the
// set-up, 6 the input staging); here they are empty.

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

namespace ukf {

constexpr int kWarp = 32;  // threads a block
constexpr int kChunk = 16;  // steps a staged chunk (C)

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Weights {
  float wm0, wmi, wc0, wci;  // sigma-point weights: point 0, points 1..2n
  float c_half;              // c_sig * 0.5
  float jitter;              // added to the spread's diagonal
};

struct Args {
  const float *Q, *R, *P0, *x0s, *yss, *uss;
  float *xf, *xp, *Pf, *Pp, *ll;
  int B, T;
};

// Lanes a trajectory: the power of two >= the 2n+1 sigma points.
__host__ __device__ constexpr int group_lanes(int n) {
  return 2 * n + 1 <= 8 ? 8 : 2 * n + 1 <= 16 ? 16 : 32;
}

// Shared floats of one group: two input buffers, each the u and y runs of
// a chunk (each run at any 4-byte alignment).
template <int m, int p>
struct Stage {
  static constexpr int kU = async_copy::slot_floats(kChunk * m);
  static constexpr int kIn = kU + async_copy::slot_floats(kChunk * p);
  static constexpr int kFloats = 2 * kIn;
};

// Lower row Cholesky of the n x n M (lower triangle read) plus `jitter` on
// the diagonal; Linv[j] = 1 / L[j][j] by one rsqrtf per pivot.
template <int n>
__device__ __forceinline__ void chol_rows(const float (&M)[n][n], float jitter, float (&L)[n][n],
                                          float (&Linv)[n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float acc = M[j][j] + jitter;
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k];
    const float inv = rsqrtf(acc);
    L[j][j] = acc * inv;
    Linv[j] = inv;
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      float acc2 = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc2 = acc2 - L[i][k] * L[j][k];
      L[i][j] = acc2 * inv;
    }
  }
}

// The spread factor of the sigma points at covariance P.
template <int n>
__device__ __forceinline__ void spread(const float (&P)[n][n], const Weights& w,
                                       float (&S)[n][n]) {
  float M[n][n], Sinv[n];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) M[i][j] = w.c_half * (P[i][j] + P[j][i]);
  chol_rows<n>(M, w.jitter, S, Sinv);
}

// Sigma point k of (x, S): x for k = 0, x + column c of S for k = c + 1,
// x - column c for k = n + c + 1; a lane past 2n gets x. Column c is picked
// by selects (S[j][c] for c <= j: the factor's lower triangle only).
template <int n>
__device__ __forceinline__ void sigma_point(int k, const float (&x)[n], const float (&S)[n][n],
                                            float (&pt)[n]) {
  const int c_sel = k <= n ? k - 1 : k - 1 - n;
  const bool minus = k > n;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float col = 0.0f;
#pragma unroll
    for (int c = 0; c <= j; ++c) col = c == c_sel ? S[j][c] : col;
    pt[j] = minus ? x[j] - col : x[j] + col;
  }
}

template <int P, int H, int p>
__global__ void __launch_bounds__(kWarp, 1) ukf_kernel(PlantParams params, Weights w, Args a) {
  using F = plants::Plant<P>;
  using St = Stage<F::m, p>;
  constexpr int n = F::n, m = F::m, K = 2 * n + 1, G = group_lanes(n), kGroups = kWarp / G;
  __shared__ __align__(16) float stage_sm[kGroups * St::kFloats];
  NPT_STAMP_BEGIN;
  const int lane = threadIdx.x, k = lane % G, grp = lane / G;
  const int b = blockIdx.x * kGroups + grp;
  if (b >= a.B) return;  // a whole group: its shuffles name its own lanes only
  const unsigned mask = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << (grp * G);
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
  NPT_STAMP(5);

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

      // 1-2. predict: sigma point k through f in lane k, the images gathered
      // by every lane (K n shuffles in flight together), the moments summed
      // in every lane in the first port's order
      float S[n][n], pt[n], fx[n];
      spread<n>(Pm, w, S);
      sigma_point<n>(k, x, S, pt);
      F::step(pt, u, par, fx);
      float fxa[K][n];
#pragma unroll
      for (int q = 0; q < K; ++q)
#pragma unroll
        for (int j = 0; j < n; ++j) fxa[q][j] = __shfl_sync(mask, fx[j], q, G);
      NPT_STAMP(0);
      float xpv[n], Pp[n][n];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = w.wm0 * fxa[0][j];
#pragma unroll
        for (int q = 1; q < K; ++q) acc = acc + w.wmi * fxa[q][j];
        xpv[j] = acc;
      }
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = i; j < n; ++j) {
          float acc = w.wc0 * (fxa[0][i] - xpv[i]) * (fxa[0][j] - xpv[j]);
#pragma unroll
          for (int q = 1; q < K; ++q)
            acc = acc + w.wci * (fxa[q][i] - xpv[i]) * (fxa[q][j] - xpv[j]);
          acc = acc + Qu[i][j];
          Pp[i][j] = acc;
          Pp[j][i] = acc;
        }
      NPT_STAMP(1);

      // 3. update: every point redrawn from (x_p, P_p) and h at each, in
      // every lane (h is the cheap part: no shuffle), the moments as above
      float pts[K][n], hy[K][p];
      spread<n>(Pp, w, S);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        sigma_point<n>(q, xpv, S, pts[q]);
        plants::Measure<H>::template eval<p>(pts[q], hy[q]);
      }
      float yp[p];
#pragma unroll
      for (int c = 0; c < p; ++c) {
        float acc = w.wm0 * hy[0][c];
#pragma unroll
        for (int q = 1; q < K; ++q) acc = acc + w.wmi * hy[q][c];
        yp[c] = acc;
      }
      float Sm[p][p], Pxy[n][p];
#pragma unroll
      for (int i = 0; i < p; ++i)
#pragma unroll
        for (int j = i; j < p; ++j) {
          float acc = w.wc0 * (hy[0][i] - yp[i]) * (hy[0][j] - yp[j]);
#pragma unroll
          for (int q = 1; q < K; ++q)
            acc = acc + w.wci * (hy[q][i] - yp[i]) * (hy[q][j] - yp[j]);
          acc = acc + Ru[i][j];
          Sm[i][j] = acc;
          Sm[j][i] = acc;
        }
#pragma unroll
      for (int j = 0; j < n; ++j)
#pragma unroll
        for (int c = 0; c < p; ++c) {
          float acc = w.wc0 * (pts[0][j] - xpv[j]) * (hy[0][c] - yp[c]);
#pragma unroll
          for (int q = 1; q < K; ++q)
            acc = acc + w.wci * (pts[q][j] - xpv[j]) * (hy[q][c] - yp[c]);
          Pxy[j][c] = acc;
        }
      NPT_STAMP(2);

      // 4. W = S^-1 Pxy': forward (L G = Pxy'), then backward (L' W = G)
      float L[p][p], Linv[p];
      chol_rows<p>(Sm, 0.0f, L, Linv);
      float Gm[p][n], W[p][n];
#pragma unroll
      for (int i = 0; i < p; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          float acc = Pxy[j][i];
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
      float v[p];
#pragma unroll
      for (int q = 0; q < p; ++q) v[q] = y[q] - yp[q];
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float acc = xpv[j];
#pragma unroll
        for (int q = 0; q < p; ++q) acc = acc + W[q][j] * v[q];
        x[j] = acc;
      }
      float SK[p][n];  // S W
#pragma unroll
      for (int i = 0; i < p; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          float acc = Sm[i][0] * W[0][j];
#pragma unroll
          for (int q = 1; q < p; ++q) acc = acc + Sm[i][q] * W[q][j];
          SK[i][j] = acc;
        }
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = i; j < n; ++j) {
          float acc = Pp[i][j];
#pragma unroll
          for (int q = 0; q < p; ++q) acc = acc - W[q][i] * SK[q][j];
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
      NPT_STAMP(3);

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
      NPT_STAMP(4);
    }
    __syncwarp(mask);  // the chunk's input buffer read by every lane
    stage_chunk(c + 2);
    NPT_STAMP(6);
  }
  if (k == 0) a.ll[b] = ll;
  NPT_STAMP_END;
}

template <int P, int H, int p>
int launch(const PlantParams& params, const Weights& w, const Args& a, cudaStream_t stream) {
  using F = plants::Plant<P>;
  constexpr int kGroups = kWarp / group_lanes(F::n);
  static_assert(kGroups * Stage<F::m, p>::kFloats * sizeof(float) <= 48 * 1024,
                "K12's block fits the static shared memory of a plain launch");
  ukf_kernel<P, H, p><<<(a.B + kGroups - 1) / kGroups, kWarp, 0, stream>>>(params, w, a);
  return static_cast<int>(cudaGetLastError());
}

// The measurement widths of plant P: p = 1 .. n (n <= 8).
template <int P, int H>
int launch_p(int p, const PlantParams& params, const Weights& w, const Args& a, cudaStream_t st) {
  constexpr int n = plants::Plant<P>::n;
  switch (p) {
    case 1:
      return launch<P, H, 1>(params, w, a, st);
    case 2:
      if constexpr (n >= 2) return launch<P, H, 2>(params, w, a, st);
      break;
    case 3:
      if constexpr (n >= 3) return launch<P, H, 3>(params, w, a, st);
      break;
    case 4:
      if constexpr (n >= 4) return launch<P, H, 4>(params, w, a, st);
      break;
    case 5:
      if constexpr (n >= 5) return launch<P, H, 5>(params, w, a, st);
      break;
    case 6:
      if constexpr (n >= 6) return launch<P, H, 6>(params, w, a, st);
      break;
    case 7:
      if constexpr (n >= 7) return launch<P, H, 7>(params, w, a, st);
      break;
    case 8:
      if constexpr (n >= 8) return launch<P, H, 8>(params, w, a, st);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ukf

// As npt_ekf (ekf.cu), plus the sigma-point weights wm0, wmi, wc0, wci, the
// spread c_half = c_sig * 0.5 and the jitter. Returns the CUDA error code.
extern "C" int npt_ukf(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                       float p6, float p7, int measure, int p, float wm0, float wmi, float wc0,
                       float wci, float c_half, float jitter, const float* Q, const float* R,
                       const float* P0, const float* x0s, const float* yss, const float* uss,
                       float* xf, float* xp, float* Pf, float* Pp, float* ll, int B, int T,
                       void* stream) {
  using namespace ukf;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (B < 1 || T < 1 || measure != 0) return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const Weights w{wm0, wmi, wc0, wci, c_half, jitter};
  const Args a{Q, R, P0, x0s, yss, uss, xf, xp, Pf, Pp, ll, B, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant) {
    case 0: return launch_p<0, 0>(p, params, w, a, st);
    case 1: return launch_p<1, 0>(p, params, w, a, st);
    case 2: return launch_p<2, 0>(p, params, w, a, st);
    case 3: return launch_p<3, 0>(p, params, w, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
