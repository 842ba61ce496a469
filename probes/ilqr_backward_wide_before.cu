// The wide K7 as it was before its redesign for the tensor cores (the
// parent's numpower_tpu_torch/csrc/ilqr_backward_wide.cu, kept unchanged
// below for probes/ilqr_wide_turns.py and probes/ilqr_wide_variants.py):
// one block a scenario, the products as fp32 FMAs on the CUDA cores, the
// Jacobians read row-major contiguous (the wrapper copied the column-major
// ones the linearization hands over).
//
// Fused batched iLQR backward pass (K7) past the narrow envelope: n > 16 or
// m > 8, any size.
//
// Replaces, as ilqr_backward.cu does below it, the TPU kernel
// numpower_tpu/kernels/ilqr_backward.py ilqr_backward_fused
// (_ilqr_bwd_kernel), which has no size check: both fused iLQR solvers call
// it for any plant. The function is ilqr_backward.cu's: for each scenario s,
// from Vx = lx_T, Vxx = lxx_T, for stages T-1 .. 0
//     Qx  = lx + A'Vx          Qu  = lu + B'Vx          [W | W2] = Vxx [A | B]
//     Qxx = lxx + A'W (upper)  Quu = luu_reg + diag(luu_diag) + B'W2     Qux = B'W
//     [k | K] = -Quu^{-1} [Qu | Qux]   (Cholesky of Quu's lower triangle)
//     Vx' = Qx + Qux'k         Vxx' = Qxx + Qux'K   (upper triangle formed, mirrored)
// k and K of each stage written at its forward index into (N, T, m) and
// (N, T, m, n).
//
// Why the narrow forms stop at (16, 8): they hold a row of Vxx (or a whole
// scenario) in one lane's registers and factor Quu in every lane's, with
// loops unrolled to compile-time buckets. At the eight-quadrotor formation
// (n = 48, m = 16) a scenario's working set is ~13.7k floats.
//
// Design: riccati_wide.cu's, with runtime (n, m) and rolled loops. One block
// a scenario. Its working set, WideLayout below, lives in dynamic shared
// memory: Vxx (and Qxx in its place during a step), the stage M = [A | B]
// with lx, lu and luu_diag, [W | W2] (Quu^{-1} in its place once read),
// Qux, [Qu | Qux], [k | K], Quu, Qx and Vx. A step, each phase a loop of the
// block's threads over work items, a barrier between phases:
//   1. [W | W2] = Vxx M: an item is a pair of M's slots (2p, 2p + 1) and a
//      tile of 8 rows; Vxx's row j (its column: Vxx is symmetric) read as
//      two 16-byte broadcasts, the pair's entries of M's row j as one 8-byte
//      load, 16 FMAs; then Qx and Qu;
//   2. M'[W | W2]: an item is a pair of slots and a tile of 8 of M's slots:
//      A'W + lxx into Vxx's place on and above the diagonal (only Qxx's
//      upper triangle is read), B'W into Qux and [Qu | Qux], B'W2 + luu_reg
//      + diag(luu_diag) into Quu;
//   3. for m <= 32, one warp inverts Quu in its registers (spd_inverse_warp,
//      buckets MB = 8, 16, 32): the factor's pivots and columns and L^{-1}'s
//      entries pass by __shfl_sync, with no shared-memory access and no
//      barrier on the chain; then [k | K] = -Quu^{-1} [Qu | Qux] by (column,
//      tile of 8 rows), m FMAs deep. Past m = 32 the block factors Quu in
//      shared memory and substitutes forward and back, right-looking, a warp
//      a row and its lanes the row's entries, 3m barriers a step;
//   4. the block stores k and K on consecutive addresses;
//   5. Vx', and Vxx' = Qxx + Qux'K: an item a column c and a tile of rows
//      r <= c, written at (r, c) and mirrored at (c, r); no two items touch
//      an entry another one reads.
// While a step computes, the next stage is copied into the other of two
// stage buffers by cp.async, a warp a row, 16 bytes a lane where the rows
// are 16-byte aligned (n or m a multiple of 4), else 4: M's rows are padded,
// A's part to a multiple of 8 columns and B's after it, so a broadcast never
// straddles A and B. Where two buffers do not fit in the 227 KB a block may
// have, one is copied at the top of each step; where one does not fit
// either (n ~ 90 at m = n / 2), the same kernel runs with its working set in
// a device workspace the caller allocates (npt_ilqr_backward_workspace), the
// stage copied by plain loads and stores. The padding of the tiles and
// slots is never written: it is read into accumulators whose results are
// dropped, and the sums over j run to n exactly.
//
// Why runtime sizes and rolled loops: riccati_wide.cu's unrolled 48-wide
// instances spilled and took ~3 minutes to compile (PERF.md); here
// one instance serves every (n, m) of an m bucket. Why the warp's inverse:
// the first form of this kernel factored Quu a thread a row and
// substituted a thread a column, chains of ~m^2 dependent
// shared-memory steps; a right-looking block factor with one FMA an item
// ran slower still (its many barriers); the warp's inverse cut the factor
// from ~8.6 to ~1.5 ms of the formation's kernel (probes/ilqr_wide_variants.py,
// PERF.md section 6). Why its buckets: the inverse's shuffles grow as MB^2,
// and one MB = 32 instance for every m <= 32 (the probe's mb32_only) ran
// (48, 16) at N = 4096, T = 50 in 16.83 ms against 10.38, (17, 1) in 5.16
// against 2.01 and (4, 12) in 5.24 against 2.56 (H100 80GB HBM3, 700 W).
//
// What bounds it: at the formation (N = 4096, T = 50) the fp32 operations
// the function needs (the upper triangles of Qxx and Vxx', Quu's half, an
// m^3 / 3 factor: chip_smoke.ilqr_backward_work), 566k a scenario-step,
// 1.16e11 in all (1.73 ms at 67 TFLOP/s), against 3.21 GB of traffic (0.96
// ms at 3.35 TB/s). Measured there on the H100: 10.4 ms, 17% of that bound,
// its phases latency-bound at 16 warps an SM (four 53.4 KB blocks); PERF.md,
// section 6 (chip_smoke.py phase 29).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ilqr_bwd {

constexpr int kTile = 8;  // rows of an item's register tile
// Threads a block by n + m: 64 to 32, 128 to 64, 256 past it (at (48, 16)
// 128 ran 17-31% faster than 256 and 64; at (48, 48) and (64, 32) 256 ran
// 16-32% faster than 128; at (4, 12) and (17, 1) 64 ran 26-31% faster than
// 128: probes/ilqr_wide_variants.py, PERF.md section 6).
constexpr int kWideThreadsSmall = 64;
constexpr int kWideThreads = 128;
constexpr int kWideThreadsBig = 256;

__host__ __device__ constexpr int round_up(int x, int q) { return (x + q - 1) / q * q; }

// The working set of one scenario, offsets in floats, every one 16-byte
// aligned. M's row: A's n entries at 0, B's m at nA; a stage buffer holds M
// (n rows), then lx, lu, luu_diag.
struct WideLayout {
  int ldv, nA, ldM, ldk, ldL, oLx, oLu, oLd, stage;
  int oV, oVx, oQx, oY, oQux, oKK, oXX, oL, oDinv, oStage, floats;
  __host__ __device__ WideLayout(int n, int m, int depth) {
    ldv = round_up(n, kTile);
    nA = ldv;
    ldM = nA + round_up(m, kTile);
    ldk = round_up(n + 1, 4);
    ldL = m + 1;  // odd: a warp's lanes on a row of L hit distinct banks
    oLx = n * ldM;
    oLu = oLx + round_up(n, 4);
    oLd = oLu + round_up(m, 4);
    stage = oLd + round_up(m, 4);
    oV = 0;                                    // Vxx, Qxx          (n, ldv)
    oVx = oV + n * ldv;                        // Vx                (n)
    oQx = oVx + round_up(n, 4);                // Qx                (n)
    // [W | W2] (n, ldM), read by phase 2 only; then Quu^{-1} (m, round_up(m,
    // kTile)) and [k | K] (m, ldk) in its place
    oY = oQx + round_up(n, 4);
    const int y = n * ldM, qi = round_up(m * round_up(m, kTile), 4);
    oXX = oY + qi;
    oQux = oY + (y > qi + m * ldk ? y : qi + m * ldk);  // Qux     (m, ldv)
    oKK = oQux + m * ldv;                      // [Qu | Qux], then Y  (m, ldk)
    oL = oKK + m * ldk;                        // Quu, L by columns (m, ldL)
    oDinv = oL + round_up(m * ldL, 4);         // 1 / L[a][a]       (m)
    oStage = oDinv + round_up(m, 4);           // depth stage buffers
    floats = oStage + depth * stage;
  }
};

// acc0 += row[0:8] x0 and acc1 += row[0:8] x1, the row read once.
__device__ __forceinline__ void fma_tile2(float (&acc0)[kTile], float (&acc1)[kTile],
                                          const float* row, float x0, float x1) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  const float r[kTile] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    acc0[q] = fmaf(r[q], x0, acc0[q]);
    acc1[q] = fmaf(r[q], x1, acc1[q]);
  }
}

__device__ __forceinline__ void fma_tile(float (&acc)[kTile], const float* row, float x) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  acc[0] = fmaf(a.x, x, acc[0]);
  acc[1] = fmaf(a.y, x, acc[1]);
  acc[2] = fmaf(a.z, x, acc[2]);
  acc[3] = fmaf(a.w, x, acc[3]);
  acc[4] = fmaf(b.x, x, acc[4]);
  acc[5] = fmaf(b.y, x, acc[5]);
  acc[6] = fmaf(b.z, x, acc[6]);
  acc[7] = fmaf(b.w, x, acc[7]);
}

// Quu^{-1} of the SPD Quu (m <= MB <= 32, entry (a, b) at Lq[b * ldL + a])
// by one warp in registers, into Qi (entry (a, b) at Qi[b * ldq + a]): lane
// i holds row i of Quu (the identity past m) and factors it, right-looking,
// each pivot and column entry passed by __shfl_sync; lane k then forms
// column k of L^{-1} by forward substitution (L's entries broadcast from
// their rows' lanes), and Quu^{-1} = L^{-T} L^{-1} from the columns. No
// shared-memory access and no barrier between the loads and the stores.
template <int MB>
__device__ __forceinline__ void spd_inverse_warp(const float* Lq, int ldL, int m, float* Qi,
                                                 int ldq, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  float row[MB];
#pragma unroll
  for (int k = 0; k < MB; ++k)
    row[k] = (lane < m && k < m) ? Lq[k * ldL + lane] : (lane == k ? 1.0f : 0.0f);
  float dinv = 1.0f;
#pragma unroll
  for (int j = 0; j < MB; ++j) {
    const float inv = rsqrtf(__shfl_sync(kAll, row[j], j));
    const float l = row[j] * inv;  // L[lane][j] for lane >= j
    if (lane == j) dinv = inv;
#pragma unroll
    for (int k = j + 1; k < MB; ++k) row[k] = fmaf(-l, __shfl_sync(kAll, l, k), row[k]);
    row[j] = l;
  }
  float col[MB];  // column `lane` of L^{-1}
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    float acc = i == lane ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < i; ++q) acc = fmaf(-__shfl_sync(kAll, row[q], i), col[q], acc);
    col[i] = acc * __shfl_sync(kAll, dinv, i);
  }
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < MB; ++i) acc = fmaf(col[i], __shfl_sync(kAll, col[i], b), acc);
    if (lane < m && b < m) Qi[b * ldq + lane] = acc;
  }
}

// One float, or four 16-byte-aligned floats, from device memory into the
// working set: by cp.async into shared memory, else by a load and a store.
template <bool kShared>
__device__ __forceinline__ void copy1(float* dst, const float* src) {
  if (kShared)
    __pipeline_memcpy_async(dst, src, sizeof(float));
  else
    *dst = *src;
}

template <bool kShared>
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  if (kShared)
    __pipeline_memcpy_async(dst, src, sizeof(float4));
  else
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// `rows` rows of `cols` floats, row-major at src (stride cols), into dst
// (stride ld, 16-byte-aligned rows): a warp a row, a lane four floats where
// src's rows are 16-byte aligned, else one.
template <bool kShared>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int rows,
                                          int cols, int warp, int nw, int lane) {
  if (cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int r = warp; r < rows; r += nw)
      for (int c = 4 * lane; c < cols; c += 128) copy4<kShared>(dst + r * ld + c, src + r * cols + c);
  } else {
    for (int r = warp; r < rows; r += nw)
      for (int c = lane; c < cols; c += 32) copy1<kShared>(dst + r * ld + c, src + r * cols + c);
  }
}

// kShared: the working set in dynamic shared memory and the stage copied by
// cp.async; otherwise in `work` (a block's slice of `floats` floats) and
// copied by plain loads and stores. depth: stage buffers, 2 (the next stage
// copied during a step) or 1 (copied at its top). MB: 8, 16 or 32, the
// warp's register inverse of Quu for m <= MB; 0, the block's factor (any m).
// The shared-memory form's bound keeps 128 registers a thread (four blocks
// an SM at 128 threads); the workspace form, bound by its memory, takes more.
template <bool kShared, int MB>
__global__ void __launch_bounds__(kWideThreadsBig, kShared ? 2 : 1)
    backward_wide_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                         const float* __restrict__ lxs, const float* __restrict__ lus,
                         const float* __restrict__ luud, const float* __restrict__ lxx,
                         const float* __restrict__ luu_reg, const float* __restrict__ lxT,
                         const float* __restrict__ lxxT, float* __restrict__ ks,
                         float* __restrict__ Ks, int n, int m, int T, int depth,
                         float* __restrict__ work) {
  extern __shared__ __align__(16) float wide_smem[];
  const WideLayout L(n, m, depth);
  const size_t s = blockIdx.x;
  float* const base = kShared ? wide_smem : work + s * static_cast<size_t>(L.floats);
  float* const V = base + L.oV;
  float* const Vx = base + L.oVx;
  float* const Qx = base + L.oQx;
  float* const Y = base + L.oY;
  float* const Qux = base + L.oQux;
  float* const KK = base + L.oKK;
  float* const XX = base + L.oXX;
  float* const Lq = base + L.oL;
  float* const dinv = base + L.oDinv;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32, warp = tid / 32, nw = nt / 32;
  const int nm = n + m, nc = n + 1, ldv = L.ldv, nA = L.nA, ldM = L.ldM, ldk = L.ldk;
  const int ldL = L.ldL, tilesV = ldv / kTile, tilesM = ldM / kTile, tilesB = (ldM - nA) / kTile;
  const bool has_ld = luud != nullptr;
  const int pairs = ldM / 2;  // slot pairs of M's rows (A's, then B's)
  auto slot = [&](int c) { return c < n ? c : nA + (c - n); };  // column c of M in a row

  // Stage `stage` into buffer `buf`: the rows of A and B at their slots.
  auto fetch = [&](int stage, float* buf) {
    const size_t st = s * T + stage;
    copy_rows<kShared>(buf, ldM, As + st * n * n, n, n, warp, nw, lane);
    copy_rows<kShared>(buf + nA, ldM, Bs + st * n * m, n, m, warp, nw, lane);
    for (int e = tid; e < n; e += nt) copy1<kShared>(buf + L.oLx + e, lxs + st * n + e);
    for (int e = tid; e < m; e += nt) {
      copy1<kShared>(buf + L.oLu + e, lus + st * m + e);
      if (has_ld) copy1<kShared>(buf + L.oLd + e, luud + st * m + e);
    }
    if (kShared) __pipeline_commit();
  };
  auto buffer = [&](int t) { return base + L.oStage + (depth == 2 ? (t & 1) : 0) * L.stage; };

  // Vxx = lxxT' (phase 1 reads rows of Vxx as its columns, which gives
  // lxxT M as the plain version's first step; the later Vxx are symmetric)
  for (int r = warp; r < n; r += nw)
    for (int c = lane; c < n; c += 32) V[c * ldv + r] = lxxT[r * n + c];
  for (int e = tid; e < n; e += nt) Vx[e] = lxT[s * n + e];
  if (!has_ld)
    for (int d = 0; d < depth; ++d)
      for (int e = tid; e < m; e += nt) base[L.oStage + d * L.stage + L.oLd + e] = 0.0f;
  if (T > 0 && depth == 2) fetch(T - 1, buffer(0));

  for (int t = 0; t < T; ++t) {
    const int stage = T - 1 - t;
    float* const M = buffer(t);
    if (depth == 1) fetch(stage, M);  // the buffer's last reader, phase 2, is barriers behind
    if (kShared) __pipeline_wait_prior(0);
    __syncthreads();  // the stage, Vxx and Vx are in place; buffer(t + 1) is read no more
    if (depth == 2 && t + 1 < T) fetch(stage - 1, buffer(t + 1));
    const float* const lx = M + L.oLx;
    const float* const lu = M + L.oLu;
    const float* const ld = M + L.oLd;

    // 1. [W | W2] = Vxx M by (pair of slots 2p, 2p + 1 of M's rows, tile of
    // rows): the rows of Vxx as two 16-byte broadcasts, the pair's entries
    // as one 8-byte load, 16 FMAs; then Qx and Qu
    for (int it = tid; it < pairs * tilesV; it += nt) {
      const int s0 = 2 * (it % pairs), r0 = (it / pairs) * kTile;
      float a0[kTile] = {}, a1[kTile] = {};
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const float2 mj = *reinterpret_cast<const float2*>(M + j * ldM + s0);
        fma_tile2(a0, a1, V + j * ldv + r0, mj.x, mj.y);
      }
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        if (r0 + q < n)
          *reinterpret_cast<float2*>(Y + (r0 + q) * ldM + s0) = make_float2(a0[q], a1[q]);
    }
    for (int c = tid; c < nm; c += nt) {
      const int sc = slot(c);
      float acc = 0.0f;
      for (int j = 0; j < n; ++j) acc = fmaf(M[j * ldM + sc], Vx[j], acc);
      if (c < n)
        Qx[c] = lx[c] + acc;
      else
        KK[(c - n) * ldk] = lu[c - n] + acc;
    }
    __syncthreads();

    // 2. M'[W | W2] by (pair of slots, tile of M's slots), the rows of M as
    // broadcasts: slots of A (columns c < n) over B's tiles and over A's
    // tiles on and above the diagonal (A'W + lxx into Vxx's place, its upper
    // triangle read; B'W into Qux and the right-hand sides), slots of B
    // (columns n + b) over B's tiles (Quu's column b, with luu_reg and
    // luu_diag); the slots' padding is computed and dropped
    auto store = [&](int sc, int k0, const float (&acc)[kTile]) {
      const int c = sc < nA ? sc : n + (sc - nA);
      if (sc < nA ? sc >= n : sc - nA >= m) return;  // a padding slot
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const int k = k0 + q;
        if (c < n) {
          if (k < n) {
            V[k * ldv + c] = acc[q] + lxx[k * n + c];
          } else if (k >= nA && k - nA < m) {
            Qux[(k - nA) * ldv + c] = acc[q];
            KK[(k - nA) * ldk + 1 + c] = acc[q];
          }
        } else if (k - nA < m) {
          const int a = k - nA, b = c - n;  // Quu[a][b], entry (a, b) of the factor's storage
          Lq[b * ldL + a] = acc[q] + luu_reg[a * m + b] + (a == b ? ld[b] : 0.0f);
        }
      }
    };
    const int pairsA = nA / 2, itemsA = pairsA * tilesM, pairsB = (ldM - nA) / 2;
    for (int it = tid; it < itemsA + pairsB * tilesB; it += nt) {
      int s0, k0;
      if (it < itemsA) {
        s0 = 2 * (it % pairsA);
        k0 = (it / pairsA) * kTile;
        if (k0 < nA && k0 > s0 + 1) continue;  // below Qxx's diagonal
      } else {
        const int f = it - itemsA;
        s0 = nA + 2 * (f % pairsB);
        k0 = nA + (f / pairsB) * kTile;
      }
      float a0[kTile] = {}, a1[kTile] = {};
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const float2 yj = *reinterpret_cast<const float2*>(Y + j * ldM + s0);
        fma_tile2(a0, a1, M + j * ldM + k0, yj.x, yj.y);
      }
      store(s0, k0, a0);
      store(s0 + 1, k0, a1);
    }
    __syncthreads();

    if constexpr (MB > 0) {
      // 3-4 (m <= MB). Quu^{-1} by warp 0 in registers into Y (read no more
      // this step), then [k | K] = -Quu^{-1} [Qu | Qux] by (column, tile of
      // rows), Quu^{-1}'s rows (its columns) as broadcasts
      float* const Qi = Y;
      const int ldq = round_up(m, kTile);
      if (warp == 0) spd_inverse_warp<MB>(Lq, ldL, m, Qi, ldq, lane);
      __syncthreads();
      const int tilesQ = ldq / kTile;
      for (int it = tid; it < nc * tilesQ; it += nt) {
        const int col = it % nc, a0 = (it / nc) * kTile;
        float acc[kTile] = {};
        for (int b = 0; b < m; ++b) fma_tile(acc, Qi + b * ldq + a0, KK[b * ldk + col]);
#pragma unroll
        for (int q = 0; q < kTile; ++q)
          if (a0 + q < m) XX[(a0 + q) * ldk + col] = -acc[q];
      }
      __syncthreads();
    } else {
    // 3. Quu = L L' in place (entry (i, k) of L at Lq[k * ldL + i]) and the
    // forward substitution L Y = [Qu | Qux] in KK, right-looking: at pivot j
    // the block scales column j of L and row j of Y (then final), and after
    // a barrier a warp takes each row i > j, its lanes the trailing entries
    // (i, k), j < k <= i, and the row's right-hand sides
    for (int j = 0; j < m; ++j) {
      const float inv = rsqrtf(Lq[j * ldL + j]);
      for (int i = j + 1 + tid; i < m; i += nt) Lq[j * ldL + i] *= inv;
      for (int col = tid; col < nc; col += nt) KK[j * ldk + col] *= inv;
      if (tid == 0) dinv[j] = inv;
      __syncthreads();
      for (int i = j + 1 + warp; i < m; i += nw) {
        const float lij = Lq[j * ldL + i];
        for (int k = j + 1 + lane; k <= i; k += 32) Lq[k * ldL + i] -= lij * Lq[j * ldL + k];
        for (int col = lane; col < nc; col += 32) KK[i * ldk + col] -= lij * KK[j * ldk + col];
      }
      __syncthreads();
    }

    // 4. the back substitution L' X = Y, right-looking from the last row: at
    // row a, x_a = Y[a] / L[a][a] is final; a warp a row q < a takes
    // Y[q] -= L[a][q] x_a, and the warp of row a stores -x_a into XX, so
    // that XX = [k | K] = -Quu^{-1} [Qu | Qux]
    for (int a = m - 1; a >= 0; --a) {
      const float da = dinv[a];
      for (int q = warp; q <= a; q += nw) {
        const float laq = Lq[q * ldL + a];
        for (int col = lane; col < nc; col += 32) {
          const float x = KK[a * ldk + col] * da;
          if (q == a)
            XX[a * ldk + col] = -x;
          else
            KK[q * ldk + col] -= laq * x;
        }
      }
      __syncthreads();
    }
    }
    {
      const size_t st = s * T + stage;
      for (int a = tid; a < m; a += nt) ks[st * m + a] = XX[a * ldk];
      float* const Kout = Ks + st * m * n;
      for (int a = warp; a < m; a += nw)
        for (int i = lane; i < n; i += 32) Kout[a * n + i] = XX[a * ldk + 1 + i];
    }

    // 5. Vx' = Qx + Qux'k, and Vxx' = Qxx + Qux'K by (column c, tile of rows
    // r <= c), written at (r, c) and (c, r)
    for (int c = tid; c < n; c += nt) {
      float acc = Qx[c];
      for (int a = 0; a < m; ++a) acc = fmaf(Qux[a * ldv + c], XX[a * ldk], acc);
      Vx[c] = acc;
    }
    for (int it = tid; it < n * tilesV; it += nt) {
      const int c = it % n, r0 = (it / n) * kTile;
      if (r0 > c) continue;
      float acc[kTile] = {};
      for (int a = 0; a < m; ++a) fma_tile(acc, Qux + a * ldv + r0, XX[a * ldk + 1 + c]);
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        const int r = r0 + q;
        if (r <= c) {
          const float v = V[r * ldv + c] + acc[q];
          V[r * ldv + c] = v;
          V[c * ldv + r] = v;
        }
      }
    }
  }
}

// The bytes of the shared-memory form's block at (n, m) and depth, and the
// most a block may have on the current device.
inline size_t wide_bytes(int n, int m, int depth) {
  return sizeof(float) * static_cast<size_t>(WideLayout(n, m, depth).floats);
}

inline cudaError_t wide_optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The depth of the shared-memory form at (n, m), or 0 where no form fits.
inline int wide_shared_depth(int n, int m, int optin) {
  for (int depth = 2; depth >= 1; --depth)
    if (wide_bytes(n, m, depth) <= static_cast<size_t>(optin)) return depth;
  return 0;
}

inline int wide_threads(int n, int m) {
  return n + m <= 32 ? kWideThreadsSmall : n + m <= 64 ? kWideThreads : kWideThreadsBig;
}

template <int MB>
cudaError_t launch_wide_mb(const float* As, const float* Bs, const float* lxs, const float* lus,
                           const float* luud, const float* lxx, const float* luu_reg,
                           const float* lxT, const float* lxxT, float* ks, float* Ks, int N,
                           int n, int m, int T, float* work, int depth, int threads,
                           cudaStream_t stream) {
  if (depth > 0) {
    const size_t smem = wide_bytes(n, m, depth);
    const cudaError_t err = cudaFuncSetAttribute(backward_wide_kernel<true, MB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    backward_wide_kernel<true, MB><<<N, threads, smem, stream>>>(
        As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, n, m, T, depth, nullptr);
  } else {
    if (work == nullptr) return cudaErrorInvalidValue;
    backward_wide_kernel<false, MB><<<N, threads, 0, stream>>>(
        As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, n, m, T, 1, work);
  }
  return cudaGetLastError();
}

cudaError_t launch_wide(const float* As, const float* Bs, const float* lxs, const float* lus,
                        const float* luud, const float* lxx, const float* luu_reg,
                        const float* lxT, const float* lxxT, float* ks, float* Ks, int N, int n,
                        int m, int T, float* work, cudaStream_t stream) {
  int optin = 0;
  const cudaError_t err = wide_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  const int depth = wide_shared_depth(n, m, optin), threads = wide_threads(n, m);
  if (m <= 8)
    return launch_wide_mb<8>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m,
                             T, work, depth, threads, stream);
  if (m <= 16)
    return launch_wide_mb<16>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m,
                              T, work, depth, threads, stream);
  if (m <= 32)
    return launch_wide_mb<32>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m,
                              T, work, depth, threads, stream);
  return launch_wide_mb<0>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, T,
                           work, depth, threads, stream);
}

}  // namespace ilqr_bwd

// The floats of device workspace npt_ilqr_backward needs for N scenarios at
// (n, m): 0 where the narrow form (n <= 16 and m <= 8) or the wide form's
// shared memory takes them, else N times one scenario's working set; -1 on a
// CUDA error (the current device's attribute unreadable).
extern "C" long long npt_ilqr_backward_workspace(int N, int n, int m) {
  using namespace ilqr_bwd;
  if (N < 1 || n < 1 || m < 1 || (n <= 16 && m <= 8)) return 0;
  int optin = 0;
  if (wide_optin_bytes(&optin) != cudaSuccess) return -1;
  if (wide_shared_depth(n, m, optin) > 0) return 0;
  return static_cast<long long>(N) * WideLayout(n, m, 1).floats;
}

// The wide form npt_ilqr_backward takes at (n, m) on the current device: 2
// or 1, the stage buffers of the shared-memory form; 0, the workspace form;
// -1 where the narrow forms take (n, m) or on a CUDA error.
extern "C" int npt_ilqr_backward_wide_depth(int n, int m) {
  using namespace ilqr_bwd;
  if (n < 1 || m < 1 || (n <= 16 && m <= 8)) return -1;
  int optin = 0;
  if (wide_optin_bytes(&optin) != cudaSuccess) return -1;
  return wide_shared_depth(n, m, optin);
}
