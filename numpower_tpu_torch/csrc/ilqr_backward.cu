// Fused batched iLQR backward pass (K7): the LTV + affine Riccati recursion
// with Levenberg regularization, over the whole horizon in one launch.
//
// Replaces the TPU kernel numpower_tpu/kernels/ilqr_backward.py
// ilqr_backward_fused (_ilqr_bwd_kernel, _chol_solve_rows). For each scenario
// s, from Vx = lx_T, Vxx = lxx_T, for stages T-1 .. 0:
//     Qx  = lx + A'Vx          Qu  = lu + B'Vx
//     W   = Vxx A              W2  = Vxx B
//     Qxx = lxx + A'W          Quu = luu_reg + diag(luu_diag) + B'W2     Qux = B'W
//     k   = -Quu^{-1} Qu       K   = -Quu^{-1} Qux     (Cholesky of Quu's lower triangle)
//     Vx' = Qx + Qux'k         Vxx' = Qxx + Qux'K      (upper triangle formed, mirrored)
// with A, B, lx, lu, luu_diag the stage's own (per scenario and per stage)
// and lxx, luu_reg = luu + reg I shared. k and K of each stage are written
// at its forward index, straight into the public (N, T, m) and (N, T, m, n)
// layouts. Every sum runs in the order above, over j = 0 .. n-1.
//
// What bounds it: each scenario's chain of T dependent steps, not device
// memory (each stage's n^2 + nm + n + 2m floats are read once, k and K
// written once) nor the FMA pipes (~n^3 + n^2 m FLOP a step). On the H100 a
// step of the cartpole's (4, 1) takes ~0.45 us: its warp issues ~330
// instructions a step, against a dependent path of 84 cycles in the SASS,
// and staging the chunks costs ~260 cycles a step more
// (probes/ilqr_chain.py, probes/chain_floor.py). The lane-per-row form this
// replaced took ~2.7 us, most of it exchanging rows through shared memory.
//
// Two forms, by n:
//  - n <= 4 (the cartpole, the pendulum, the unicycle of every iLQR
//    configuration): one thread owns a scenario, and the kernel is compiled
//    for that exact n (1-4) and an m bucket MB (1, 2, 4, 8). Vxx, Vx, the
//    stage and every product of a step (W, W2, Quu and its factor, k, Qux, K,
//    Vxx') live in the thread's registers: a step has no shared-memory
//    exchange and no barrier, and its many independent FMAs are the warp's
//    instruction-level parallelism. A block is one warp, 32 scenarios, so at
//    config #3b's N = 256 the 8 warps sit on 8 SMs, each with its SM to
//    itself, and N = 4096 fills 128 SMs.
//  - n > 4: a group of G lanes owns a scenario (G = 8 for n <= 8, 16 above)
//    and lane i row i of Vxx, W, W2, K' and Qux' going through the
//    scenario's slice of shared memory under __syncwarp; loops run to the
//    buckets NB (8, 12, 16) and MB over zero-padded matrices (riccati.cu says
//    why no guard per element). A row of W needs all of A, so the stage
//    cannot live in one lane's registers. Lane i forms its whole row of Vxx'
//    in registers, entry (i, k) as the upper entry (min, max) of the same
//    sums, so the mirrored triangle needs no exchange.
// m <= MB is padded the same way in both forms: B, lu, luu_diag are 0 and
// luu_reg the identity outside m, which keeps the padded k and K at 0.
//
// Staging, off the chain. The thread form stages the horizon in chunks of Tc
// stages, the last chunk first, into a ring of kRing chunk buffers in shared
// memory: each thread copies its own scenario's five runs (A, B, lx, lu,
// luu_diag of stages lo .. lo+Tc-1 are contiguous in device memory) with
// 16-byte cp.async (async_copy.cuh says why not the TMA), one commit group
// a chunk, kRing - 1 chunks ahead of the step that reads them; its region is
// its own, so no barrier orders it. The stage a step needs is read into
// registers during the step before. The lane-row form copies each stage
// element by element (cp.async) into the other of two zero-padded stage
// buffers while the group computes the stage before (Layout::kDepth).
//
// Why not the tensor cores: each scenario's products are n x n with its own
// A_t and B_t, and wgmma needs 64 rows of one product; packing scenarios
// block-diagonally would waste at least 3/4 of every tile, and cut fp32 to
// bf16 passes for a chain bound by latency, not by operations.
//
// Envelope: n <= 16, m <= 8. The probe probes/ilqr_chain.py times each part
// of a step (the stamps below are empty here).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_STAMP_END
#endif

namespace ilqr_bwd {

constexpr int kMaxN = 16;
constexpr int kMaxM = 8;

// Solves Quu y = rhs in place from Quu's Cholesky factor (Lf below the
// diagonal, dinv the inverse pivots), by forward and backward substitution.
template <int MB>
__device__ __forceinline__ void chol_solve(const float (&Lf)[MB][MB], const float (&dinv)[MB],
                                           float (&y)[MB]) {
#pragma unroll
  for (int a = 0; a < MB; ++a) {
    float x = y[a];
#pragma unroll
    for (int k = 0; k < a; ++k) x -= Lf[a][k] * y[k];
    y[a] = x * dinv[a];
  }
#pragma unroll
  for (int a = MB - 1; a >= 0; --a) {
    float x = y[a];
#pragma unroll
    for (int k = a + 1; k < MB; ++k) x -= Lf[k][a] * y[k];
    y[a] = x * dinv[a];
  }
}

// Factors Quu in place: Lf holds Quu's lower triangle on entry and its
// Cholesky factor on exit, dinv the inverse pivots.
template <int MB>
__device__ __forceinline__ void cholesky(float (&Lf)[MB][MB], float (&dinv)[MB]) {
#pragma unroll
  for (int c = 0; c < MB; ++c) {
    float acc = Lf[c][c];
#pragma unroll
    for (int k = 0; k < c; ++k) acc -= Lf[c][k] * Lf[c][k];
    dinv[c] = rsqrtf(acc);
    Lf[c][c] = acc * dinv[c];
#pragma unroll
    for (int a = c + 1; a < MB; ++a) {
      float x = Lf[a][c];
#pragma unroll
      for (int k = 0; k < c; ++k) x -= Lf[a][k] * Lf[c][k];
      Lf[a][c] = x * dinv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// The thread form (n <= 4).

constexpr int kScenThread = 32;                  // scenarios (threads) per block
constexpr int kRing = 3;                         // chunk buffers
constexpr int kRingBudget = 64 * 1024;           // bytes of the ring per block
constexpr int kMaxTc = 16;

template <int n, int MB>
struct ThreadForm {
  static constexpr int kStageFloats = n * n + n * MB + n + 2 * MB;
  static constexpr int kTcFit = kRingBudget / (4 * kRing * kScenThread * (kStageFloats + 4));
  static constexpr int kTc = kTcFit < 1 ? 1 : (kTcFit > kMaxTc ? kMaxTc : kTcFit);
  // One scenario's slots in a chunk buffer (floats; each 16-byte aligned).
  static constexpr int oA = 0;
  static constexpr int oB = oA + async_copy::slot_floats(kTc * n * n);
  static constexpr int oLx = oB + async_copy::slot_floats(kTc * n * MB);
  static constexpr int oLu = oLx + async_copy::slot_floats(kTc * n);
  static constexpr int oLd = oLu + async_copy::slot_floats(kTc * MB);
  static constexpr int kSlots = oLd + async_copy::slot_floats(kTc * MB);
  // Scenario stride = 4 mod 32 floats: 16-byte aligned, and the 32 threads'
  // reads of one offset spread over 8 bank groups.
  static constexpr int kRegion = kSlots + (36 - kSlots % 32) % 32;
  static constexpr size_t smem_bytes() {
    return sizeof(float) * static_cast<size_t>(kRing) * kScenThread * kRegion;
  }
};

template <int n, int MB>
struct StageRegs {
  float a[n][n], b[n][MB], lx[n], lu[MB], ld[MB];
};

// Both forms' bounds name one block a multiprocessor as the minimum, which
// leaves ptxas the whole register file: without it, ptxas trades a few
// spills for a higher occupancy in some instances, and these loops cannot
// afford a spill (the phase-0 check of chip_smoke.py).
template <int n, int MB>
__global__ void __launch_bounds__(kScenThread, 1)
    backward_thread_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                           const float* __restrict__ lxs, const float* __restrict__ lus,
                           const float* __restrict__ luud, const float* __restrict__ lxx,
                           const float* __restrict__ luu_reg, const float* __restrict__ lxT,
                           const float* __restrict__ lxxT, float* __restrict__ ks,
                           float* __restrict__ Ks, int N, int m, int T) {
  NPT_STAMP_BEGIN;
  using L = ThreadForm<n, MB>;
  constexpr int Tc = L::kTc;
  extern __shared__ __align__(16) float ring[];
  __shared__ float lxx_s[n * n];
  __shared__ float luu_s[MB * MB];
  const int lane = threadIdx.x;
  const int s_raw = blockIdx.x * kScenThread + lane;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;  // a ragged tail recomputes a real scenario, stores nothing
  const bool has_ld = luud != nullptr;

  for (int e = lane; e < n * n; e += kScenThread) lxx_s[e] = lxx[e];
  for (int e = lane; e < MB * MB; e += kScenThread) {
    const int r = e / MB, c = e % MB;
    luu_s[e] = (r < m && c < m) ? luu_reg[r * m + c] : (r == c ? 1.0f : 0.0f);
  }
  __syncthreads();

  const size_t st0 = static_cast<size_t>(s) * T;  // the scenario's stage 0
  const int nch = (T + Tc - 1) / Tc;
  // Chunk c holds stages lo(c) .. T - c Tc - 1: the last Tc stages first.
  auto chunk_lo = [&](int c) { return max(0, T - (c + 1) * Tc); };
  auto region = [&](int c) { return ring + ((c % kRing) * kScenThread + lane) * L::kRegion; };
  // The five runs of chunk c into its buffer, one commit group (empty past
  // the last chunk).
  auto issue = [&](int c) {
    if (c < nch) {
      const int lo = chunk_lo(c), cnt = T - c * Tc - lo;
      const size_t st = st0 + lo;
      float* const reg = region(c);
      async_copy::copy_run(reg + L::oA, As + st * n * n, cnt * n * n);
      async_copy::copy_run(reg + L::oB, Bs + st * n * m, cnt * n * m);
      async_copy::copy_run(reg + L::oLx, lxs + st * n, cnt * n);
      async_copy::copy_run(reg + L::oLu, lus + st * m, cnt * m);
      if (has_ld) async_copy::copy_run(reg + L::oLd, luud + st * m, cnt * m);
    }
    __pipeline_commit();
  };

  float v[n][n], Vx[n];  // Vxx (both triangles) and Vx
#pragma unroll
  for (int i = 0; i < n; ++i) {
    Vx[i] = lxT[static_cast<size_t>(s) * n + i];
#pragma unroll
    for (int j = 0; j < n; ++j) v[i][j] = lxxT[i * n + j];
  }
  for (int c = 0; c < kRing - 1; ++c) issue(c);
  NPT_STAMP(5);

  for (int c = 0; c < nch; ++c) {
    const int lo = chunk_lo(c), cnt = T - c * Tc - lo;
    const size_t st = st0 + lo;
    __pipeline_wait_prior(kRing - 2);  // chunk c has landed; the later ones fly on
    issue(c + kRing - 1);              // into the buffer chunk c - 1 left (this thread's own)
    const float* const reg = region(c);
    const float* const pA = reg + L::oA + async_copy::run_offset(As + st * n * n);
    const float* const pB = reg + L::oB + async_copy::run_offset(Bs + st * n * m);
    const float* const pX = reg + L::oLx + async_copy::run_offset(lxs + st * n);
    const float* const pU = reg + L::oLu + async_copy::run_offset(lus + st * m);
    const float* const pD = reg + L::oLd + async_copy::run_offset(has_ld ? luud + st * m : lus);
    // Stage q of the chunk into registers, zero-padded past m.
    auto load = [&](int q) {
      StageRegs<n, MB> g;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        g.lx[i] = pX[q * n + i];
#pragma unroll
        for (int j = 0; j < n; ++j) g.a[i][j] = pA[(q * n + i) * n + j];
#pragma unroll
        for (int c2 = 0; c2 < MB; ++c2)
          g.b[i][c2] = (MB == 1 || c2 < m) ? pB[(q * n + i) * m + c2] : 0.0f;
      }
#pragma unroll
      for (int c2 = 0; c2 < MB; ++c2) {
        const bool in = MB == 1 || c2 < m;
        g.lu[c2] = in ? pU[q * m + c2] : 0.0f;
        g.ld[c2] = (in && has_ld) ? pD[q * m + c2] : 0.0f;
      }
      return g;
    };
    NPT_STAMP(0);

    StageRegs<n, MB> cur = load(cnt - 1);
    for (int q = cnt - 1; q >= 0; --q) {
      const StageRegs<n, MB> nxt = load(q > 0 ? q - 1 : 0);  // the next step's, off the chain
      const int stage = lo + q;

      // W = Vxx A and W2 = Vxx B.
      float W[n][n], W2[n][MB];
#pragma unroll
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int k = 0; k < n; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < n; ++j) acc = fmaf(v[i][j], cur.a[j][k], acc);
          W[i][k] = acc;
        }
#pragma unroll
        for (int a = 0; a < MB; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < n; ++j) acc = fmaf(v[i][j], cur.b[j][a], acc);
          W2[i][a] = acc;
        }
      }
      NPT_STAMP(1);

      // Qu, the lower triangle of Quu and its Cholesky factor, and k.
      float Lf[MB][MB], dinv[MB], kk[MB];
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < n; ++j) acc = fmaf(cur.b[j][a], Vx[j], acc);
        kk[a] = cur.lu[a] + acc;
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          float q2 = 0.0f;
#pragma unroll
          for (int j = 0; j < n; ++j) q2 = fmaf(cur.b[j][a], W2[j][b], q2);
          q2 += luu_s[a * MB + b];
          if (a == b) q2 += cur.ld[a];
          Lf[a][b] = q2;
        }
      }
      cholesky<MB>(Lf, dinv);
      chol_solve<MB>(Lf, dinv, kk);
#pragma unroll
      for (int a = 0; a < MB; ++a) kk[a] = -kk[a];
      NPT_STAMP(2);

      // Qx, Qux = B'W and K, row by row of K' (column i of Qux).
      float qx[n], qux[n][MB], Kt[n][MB];
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < n; ++j) acc = fmaf(cur.a[j][i], Vx[j], acc);
        qx[i] = cur.lx[i] + acc;
        float y[MB];
#pragma unroll
        for (int a = 0; a < MB; ++a) {
          float q2 = 0.0f;
#pragma unroll
          for (int j = 0; j < n; ++j) q2 = fmaf(cur.b[j][a], W[j][i], q2);
          qux[i][a] = q2;
          y[a] = q2;
        }
        chol_solve<MB>(Lf, dinv, y);
#pragma unroll
        for (int a = 0; a < MB; ++a) Kt[i][a] = -y[a];
      }
      if (live) {
        float* const kout = ks + (st0 + stage) * m;
        float* const Kout = Ks + (st0 + stage) * m * n;
#pragma unroll
        for (int a = 0; a < MB; ++a) {
          if (MB == 1 || a < m) {
            kout[a] = kk[a];
#pragma unroll
            for (int i = 0; i < n; ++i) Kout[a * n + i] = Kt[i][a];
          }
        }
      }
      NPT_STAMP(3);

      // Vx' = Qx + Qux'k; Vxx' = Qxx + Qux'K on and above the diagonal,
      // mirrored below it.
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < MB; ++a) acc = fmaf(qux[i][a], kk[a], acc);
        Vx[i] = qx[i] + acc;
      }
#pragma unroll
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int k = i; k < n; ++k) {
          float q2 = 0.0f;
#pragma unroll
          for (int j = 0; j < n; ++j) q2 = fmaf(cur.a[j][i], W[j][k], q2);
          q2 += lxx_s[i * n + k];
          float r = 0.0f;
#pragma unroll
          for (int a = 0; a < MB; ++a) r = fmaf(qux[i][a], Kt[k][a], r);
          const float val = q2 + r;
          v[i][k] = val;
          v[k][i] = val;
        }
      }
      cur = nxt;
      NPT_STAMP(4);
    }
  }
  NPT_STAMP_END;
}

template <int n, int MB>
cudaError_t launch_thread(const float* As, const float* Bs, const float* lxs, const float* lus,
                          const float* luud, const float* lxx, const float* luu_reg,
                          const float* lxT, const float* lxxT, float* ks, float* Ks, int N,
                          int m, int T, cudaStream_t stream) {
  using L = ThreadForm<n, MB>;
  const size_t smem = L::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(backward_thread_kernel<n, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  backward_thread_kernel<n, MB><<<(N + kScenThread - 1) / kScenThread, kScenThread, smem,
                                  stream>>>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks,
                                            Ks, N, m, T);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The lane-row form (n > 4).

constexpr int kThreads = 128;

template <int NB, int MB>
struct Layout {
  // Stage buffers: the stage in use and kDepth - 1 in flight (a third
  // buffer measured 30% slower at NB = 12, N = 4096 on the H100).
  static constexpr int kDepth = 2;
  // The sums of Vxx' over j unroll by kJ: in full at (16, 4) ptxas needs
  // more than 255 registers and spills.
  static constexpr int kJ = (NB == 16 && MB == 4) ? 8 : NB;
  static constexpr int G = NB <= 8 ? 8 : 16;  // lanes per scenario
  static constexpr int kScen = kThreads / G;  // scenarios per block
  static constexpr int ldn = NB + 1;  // odd row strides: lane-indexed rows hit distinct banks
  static constexpr int ldm = MB + 1;
  // One stage buffer (kDepth per scenario).
  static constexpr int oA = 0;
  static constexpr int oB = oA + NB * ldn;
  static constexpr int oLx = oB + NB * ldm;
  static constexpr int oLu = oLx + NB;
  static constexpr int oLd = oLu + MB;
  static constexpr int kStage = oLd + MB;
  // Working matrices after the stage buffers.
  static constexpr int oW = kDepth * kStage;  // W = Vxx A       (NB, NB) ld ldn
  static constexpr int oW2 = oW + NB * ldn;   // W2 = Vxx B      (NB, MB) ld ldm
  static constexpr int oKt = oW2 + NB * ldm;  // K'              (NB, MB) ld ldm
  static constexpr int oQt = oKt + NB * ldm;  // Qux'            (NB, MB) ld ldm
  static constexpr int oVx = oQt + NB * ldm;  // Vx              (NB)
  static constexpr int kScenFloats = oVx + NB;
  // Block-wide: lxx (NB, NB) ld ldn and luu_reg (MB, MB), then the scenarios.
  static constexpr int kShared = NB * ldn + MB * MB;
  static constexpr size_t smem_bytes() {
    return sizeof(float) * static_cast<size_t>(kShared + kScen * kScenFloats);
  }
};

// Copy stage `stage` of scenario s into the stage buffer `buf`, real entries
// only (the padding was zeroed once), lane i of G taking every G-th entry of
// the padded (NB, NB) and (NB, MB) blocks: the loops unroll and their
// indices divide by compile-time constants.
template <int NB, int MB>
__device__ __forceinline__ void copy_stage(float* buf, const float* __restrict__ As,
                                           const float* __restrict__ Bs,
                                           const float* __restrict__ lxs,
                                           const float* __restrict__ lus,
                                           const float* __restrict__ luud, int s, int stage,
                                           int T, int n, int m, int i) {
  using L = Layout<NB, MB>;
  const size_t st = static_cast<size_t>(s) * T + stage;
  const float* a = As + st * n * n;
#pragma unroll
  for (int q = 0; q < (NB * NB + L::G - 1) / L::G; ++q) {
    const int e = q * L::G + i, r = e / NB, c = e % NB;
    if (e < NB * NB && r < n && c < n)
      __pipeline_memcpy_async(buf + L::oA + r * L::ldn + c, a + r * n + c, sizeof(float));
  }
  const float* b = Bs + st * n * m;
#pragma unroll
  for (int q = 0; q < (NB * MB + L::G - 1) / L::G; ++q) {
    const int e = q * L::G + i, r = e / MB, c = e % MB;
    if (e < NB * MB && r < n && c < m)
      __pipeline_memcpy_async(buf + L::oB + r * L::ldm + c, b + r * m + c, sizeof(float));
  }
  for (int e = i; e < n; e += L::G)
    __pipeline_memcpy_async(buf + L::oLx + e, lxs + st * n + e, sizeof(float));
  for (int e = i; e < m; e += L::G) {
    __pipeline_memcpy_async(buf + L::oLu + e, lus + st * m + e, sizeof(float));
    if (luud != nullptr)
      __pipeline_memcpy_async(buf + L::oLd + e, luud + st * m + e, sizeof(float));
  }
}

template <int NB, int MB>
__global__ void __launch_bounds__(kThreads, 1)
    backward_row_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                        const float* __restrict__ lxs, const float* __restrict__ lus,
                        const float* __restrict__ luud, const float* __restrict__ lxx,
                        const float* __restrict__ luu_reg, const float* __restrict__ lxT,
                        const float* __restrict__ lxxT, float* __restrict__ ks,
                        float* __restrict__ Ks, int N, int n, int m, int T) {
  using L = Layout<NB, MB>;
  constexpr int G = L::G, ldn = L::ldn, ldm = L::ldm, kDepth = L::kDepth;
  extern __shared__ __align__(16) float smem[];
  float* const lxx_s = smem;
  float* const luu_s = lxx_s + NB * ldn;
  const int g = threadIdx.x / G, i = threadIdx.x % G;
  const int s_raw = blockIdx.x * L::kScen + g;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;  // a ragged tail recomputes a real scenario, stores nothing
  float* const base = smem + L::kShared + g * L::kScenFloats;
  float* const W = base + L::oW;
  float* const W2 = base + L::oW2;
  float* const Kt = base + L::oKt;
  float* const Qt = base + L::oQt;
  float* const Vx = base + L::oVx;

  for (int e = threadIdx.x; e < NB * NB; e += kThreads) {
    const int r = e / NB, c = e % NB;
    lxx_s[r * ldn + c] = (r < n && c < n) ? lxx[r * n + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < MB * MB; e += kThreads) {
    const int r = e / MB, c = e % MB;
    luu_s[e] = (r < m && c < m) ? luu_reg[r * m + c] : (r == c ? 1.0f : 0.0f);
  }
  for (int e = i; e < kDepth * L::kStage; e += G) base[e] = 0.0f;
  for (int e = i; e < NB; e += G) Vx[e] = e < n ? lxT[static_cast<size_t>(s) * n + e] : 0.0f;
  const bool row = i < NB;  // lanes past NB hold no row (NB = 12 in 16-lane groups)
  float v[NB];              // row i of Vxx
#pragma unroll
  for (int j = 0; j < NB; ++j) v[j] = (i < n && j < n) ? lxxT[i * n + j] : 0.0f;
  __syncthreads();  // the zero padding is in place before the copies land

  // Stages T-1 .. T-kDepth+1 in flight before the first step, a commit group each.
#pragma unroll
  for (int t = 0; t < kDepth - 1; ++t) {
    if (t < T) copy_stage<NB, MB>(base + t * L::kStage, As, Bs, lxs, lus, luud, s, T - 1 - t, T,
                                  n, m, i);
    __pipeline_commit();
  }

  for (int t = 0; t < T; ++t) {
    const int stage = T - 1 - t;
    __pipeline_wait_prior(kDepth - 2);  // step t's group has landed; the next one may fly on
    __syncwarp();  // stage `stage` is in buffer t % kDepth, visible to the whole group
    if (t + kDepth - 1 < T)  // into the buffer step t - 1 read
      copy_stage<NB, MB>(base + ((t + kDepth - 1) % kDepth) * L::kStage, As, Bs, lxs, lus, luud,
                         s, stage - (kDepth - 1), T, n, m, i);
    __pipeline_commit();
    const float* const sb = base + (t % kDepth) * L::kStage;
    const float* const A = sb + L::oA;
    const float* const B = sb + L::oB;
    const float* const lx = sb + L::oLx;
    const float* const lu = sb + L::oLu;
    const float* const ld = sb + L::oLd;

    // Row i of W = Vxx A and of W2 = Vxx B.
    if (row) {
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(v[j], A[j * ldn + k], acc);
        W[i * ldn + k] = acc;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(v[j], B[j * ldm + a], acc);
        W2[i * ldm + a] = acc;
      }
    }
    __syncwarp();

    // Qu, the lower triangle of Quu and its Cholesky factor, and k, in every lane.
    float Lf[MB][MB], dinv[MB], kk[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) acc = fmaf(B[j * ldm + a], Vx[j], acc);
      kk[a] = lu[a] + acc;
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) q = fmaf(B[j * ldm + a], W2[j * ldm + b], q);
        q += luu_s[a * MB + b];
        if (a == b) q += ld[a];
        Lf[a][b] = q;
      }
    }
    cholesky<MB>(Lf, dinv);
    chol_solve<MB>(Lf, dinv, kk);
#pragma unroll
    for (int a = 0; a < MB; ++a) kk[a] = -kk[a];

    // Lane i: column i of Qux = B'W, Qx[i], and column i of K.
    float qux[MB], qx = 0.0f;
    if (row) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) acc = fmaf(A[j * ldn + i], Vx[j], acc);
      qx = lx[i] + acc;
      float y[MB];
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) q = fmaf(B[j * ldm + a], W[j * ldn + i], q);
        qux[a] = q;
        y[a] = q;
      }
      chol_solve<MB>(Lf, dinv, y);
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        Kt[i * ldm + a] = -y[a];
        Qt[i * ldm + a] = qux[a];
      }
      if (live && i < n) {
        float* Kout = Ks + (static_cast<size_t>(s) * T + stage) * m * n + i;
#pragma unroll
        for (int a = 0; a < MB; ++a)
          if (a < m) Kout[static_cast<size_t>(a) * n] = -y[a];
      }
    }
    if (live && i == 0) {
      float* kout = ks + (static_cast<size_t>(s) * T + stage) * m;
#pragma unroll
      for (int a = 0; a < MB; ++a)
        if (a < m) kout[a] = kk[a];
    }
    __syncwarp();  // K' and Qux' are complete and every read of Vx is done

    // Vx'[i] = Qx[i] + Qux[:, i]'k, and row i of Vxx' = Qxx + Qux'K, each
    // entry (i, k) formed as the upper one (r, c) = (min, max): the value the
    // upper triangle mirrored gives, with no exchange of rows.
    if (row) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < MB; ++a) acc = fmaf(qux[a], kk[a], acc);
      Vx[i] = qx + acc;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int r = min(i, k), c = max(i, k);
        float q = 0.0f;
#pragma unroll(L::kJ)
        for (int j = 0; j < NB; ++j) q = fmaf(A[j * ldn + r], W[j * ldn + c], q);
        q += lxx_s[r * ldn + c];
        float p = 0.0f;
#pragma unroll
        for (int a = 0; a < MB; ++a) p = fmaf(Qt[r * ldm + a], Kt[c * ldm + a], p);
        v[k] = q + p;
      }
    }
    __syncwarp();  // every read of W, W2, Kt, Qt, Vx and the stage buffer is done
  }
}

template <int NB, int MB>
cudaError_t launch_row(const float* As, const float* Bs, const float* lxs, const float* lus,
                       const float* luud, const float* lxx, const float* luu_reg,
                       const float* lxT, const float* lxxT, float* ks, float* Ks, int N, int n,
                       int m, int T, cudaStream_t stream) {
  using L = Layout<NB, MB>;
  // At most two NB = 16 blocks an SM: (16, 8)'s 168 registers allow a third,
  // and three ran 27% slower than two at N = 4096 on the H100 (0.63 against
  // 0.50 ms, probes/ilqr_chain.py); the other NB = 16 instances hold two by
  // their registers already.
  constexpr size_t kTwoBlocks16 = 80 * 1024;
  const size_t smem = NB == 16 && L::smem_bytes() < kTwoBlocks16 ? kTwoBlocks16 : L::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(backward_row_kernel<NB, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  backward_row_kernel<NB, MB><<<(N + L::kScen - 1) / L::kScen, kThreads, smem, stream>>>(
      As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, T);
  return cudaGetLastError();
}

inline int bucket_n(int n) { return n <= 4 ? n : n <= 8 ? 8 : n <= 12 ? 12 : 16; }
inline int bucket_m(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

}  // namespace ilqr_bwd

// ks (N, T, m) and Ks (N, T, m, n) from As (N, T, n, n), Bs (N, T, n, m),
// lxs (N, T, n), lus (N, T, m), luud (N, T, m) or null, the shared lxx (n, n)
// and luu_reg = luu + reg I (m, m), lxT (N, n) and lxxT (n, n), all fp32,
// row-major contiguous. Returns the CUDA error code of the launch.
extern "C" int npt_ilqr_backward(const float* As, const float* Bs, const float* lxs,
                                 const float* lus, const float* luud, const float* lxx,
                                 const float* luu_reg, const float* lxT, const float* lxxT,
                                 float* ks, float* Ks, int N, int n, int m, int T,
                                 void* stream) {
  using namespace ilqr_bwd;
  if (N < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bucket_n(n) * 16 + bucket_m(m)) {
#define NPT_THREAD(NN, MB)                                                                  \
  case NN * 16 + MB:                                                                        \
    return static_cast<int>(launch_thread<NN, MB>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, \
                                                  lxxT, ks, Ks, N, m, T, st));
#define NPT_ROW(NB, MB)                                                                        \
  case NB * 16 + MB:                                                                           \
    return static_cast<int>(launch_row<NB, MB>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, \
                                               ks, Ks, N, n, m, T, st));
#define NPT_CASES_M(CASE, NB) CASE(NB, 1) CASE(NB, 2) CASE(NB, 4) CASE(NB, 8)
    NPT_CASES_M(NPT_THREAD, 1) NPT_CASES_M(NPT_THREAD, 2) NPT_CASES_M(NPT_THREAD, 3)
    NPT_CASES_M(NPT_THREAD, 4)
    NPT_CASES_M(NPT_ROW, 8) NPT_CASES_M(NPT_ROW, 12) NPT_CASES_M(NPT_ROW, 16)
#undef NPT_CASES_M
#undef NPT_ROW
#undef NPT_THREAD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
