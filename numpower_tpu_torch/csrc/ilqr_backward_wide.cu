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
// (n = 48, m = 16) a scenario's working set is ~14k floats.
//
// What bounds it: at the formation (N = 4096, T = 50) the function needs
// 566k fp32 operations a scenario-step (the upper triangles of Qxx and
// Vxx', Quu's half, an m^3 / 3 factor: chip_smoke.ilqr_backward_work),
// 1.16e11 in all, and moves 3.21 GB (0.96 ms at 3.35 TB/s). In this form
// the products take 557k of them, on the tensor cores in three TF32 passes
// (3.42e11 operations, 0.69 ms at 495 TFLOP/s), and the CUDA cores the
// rest (0.03 ms at 67 TFLOP/s: chip_smoke.ilqr_backward_wide_ops), so the
// bound is the bytes' 0.96 ms; all of it as fp32 on the CUDA cores, the
// first form's bound, would take 1.73 ms. The first form of this kernel (probes/
// ilqr_backward_wide_before.cu) ran the products as fp32 FMAs fed by
// shared-memory broadcasts, 16 FMAs an item, at 10.4 ms: its phases
// latency-bound at 16 warps an SM, a warp inverting Quu while the block's
// other three waited, five barriers a step (PERF.md, section 6).
//
// Design. One block a scenario; its working set, WideLayout below, in
// dynamic shared memory. The three products of a step run on the tensor
// cores, mma.sync m16n8k8 TF32 in the 3xTF32 split: each operand x = hi +
// lo, hi = x truncated to TF32, lo = x - hi, and hi*hi into one fp32
// accumulator, hi*lo + lo*hi into a second, added after the k loop (the
// tensor cores' sum is not round-to-nearest, and the corrections would be
// cut against the large term; a single TF32 pass keeps ~3 digits, which
// the recursion does not hold to 1e-3). A warp's item is a 16 x 16 output
// block (two n8 tiles sharing the A fragment); where k runs along the rows
// of both operands (phases 1 and 2) a k-step's fragments come by two
// ldmatrix.x4 (32-bit words are pairs of b16: lane l gets word l % 4 of
// row l / 4 of each 8 x 4 block, the TF32 fragment's layout), else by
// 32-bit loads; the row strides (= 4 mod 8 where k runs along a row, = 8
// mod 16 where it runs down a column) keep every access of a warp on 32
// distinct banks. The stage is kept transposed, Mt = [A | B]' (row c the
// column c of M), so the linearization's column-major Jacobians are copied
// a column at a time, and both products read Mt with k along its rows. A
// step:
//   1. Y = Vxx M (items: 16 rows of Vxx x 16 slots of M), stored as Y'
//      (slot-major), then Qx, Qu = [lx | lu] + M'Vx on the CUDA cores, a
//      thread a column of M by 16-byte loads;
//   2. M'Y, only the blocks the function needs: Quu (the B slots), Qux (B
//      slots x A slots) and Qxx's upper block triangle (A'W + lxx into
//      Vxx's place, on and above the diagonal). For m <= 32 warp 0 takes
//      Quu's blocks and at once inverts Quu in its registers
//      (spd_inverse_warp: the factor's pivots and columns and L^{-1}'s
//      entries pass by __shfl_sync) while the block's other warps form
//      Qux and Qxx: the inverse no longer runs alone;
//   3. [k | K] = -Quu^{-1} [Qu | Qux] on the tensor cores too, by 16 x 16
//      blocks, Qu kept as the first column of Qux (past m = 32: the block
//      factors Quu in shared memory and substitutes forward and back,
//      right-looking, a warp a row);
//   4. k and K stored on consecutive addresses; Vx' = Qx + Qux'k, and
//      Vxx' = Qxx + Qux'K on the tensor cores over Vxx's upper block
//      triangle, written at (r, c) and mirrored at (c, r): no item reads an
//      entry another one writes.
// Four barriers a step (the first form had five). While a step computes,
// the next stage is copied into the other of two stage buffers by cp.async:
// 16 bytes a lane where M's columns are contiguous and 16-byte aligned (the
// linearization's layout), else 4. The wrapper passes As and Bs by their
// element strides, so neither layout is copied on the way in. (The copy
// engine, a bulk copy a column completing on the buffer's mbarrier, ran the
// formation no faster: probes/ilqr_wide_turns.py, PERF.md section 6.)
// Where two stage buffers do not fit in the 227 KB a block may have, one is
// copied at the top of each step; where one does not fit either (n ~ 90 at
// m = n / 2), the same kernel runs with its working set in a device
// workspace the caller allocates (npt_ilqr_backward_workspace), the stage
// copied by plain loads and stores. Padding (rows and slots to 16, k to 8)
// is zeroed once at the block's start and never written: it enters the
// products as zeros, and their results there are dropped.
//
// Why runtime sizes and rolled loops: riccati_wide.cu's unrolled 48-wide
// instances spilled and took ~3 minutes to compile (PERF.md); here one
// instance serves every (n, m) of an m bucket. Why the warp's inverse and
// its buckets MB = 8, 16, 32: its shuffles grow as MB^2, and one MB = 32
// instance for every m <= 32 ran the first form's formation 62% slower
// (probes/ilqr_wide_variants.py). The variants of this form and their times
// on the H100 are in probes/ilqr_wide_turns.py and PERF.md, section 6.
// Measured there (H100 80GB HBM3, 700 W) at the formation: 5.88 ms, 16% of
// the bound (the bytes'; 29% of the first form's all-fp32 bound); by ablation the two large
// products take ~1.2 ms each and the stage copy ~1.0 ms (both ways of
// copying alike), with most phases latency-bound at 16 warps an SM.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace ilqr_bwd {

// Threads a block by n + m: 64 to 32, 128 to 64, 256 past it.
constexpr int kWideThreadsSmall = 64;
constexpr int kWideThreads = 128;
constexpr int kWideThreadsBig = 256;

__host__ __device__ constexpr int round_up(int x, int q) { return (x + q - 1) / q * q; }

// Element strides of a stage operand (As or Bs): scenario, stage, row, column.
struct Strides {
  long long s, t, r, c;
};

// The working set of one scenario, offsets in floats, every one 16-byte
// aligned. Slots: M's columns, A's n at 0, B's m at 16 nb; rows of Vxx and
// slots padded to 16 (the products' m16 blocks), k to 8.
struct WideLayout {
  int n8, m8, m16, nb, mb, slots, ld, ldr, ldL, oLx, oLu, oLd, stage;
  int oV, oVx, oQx, oY, oXX, oQi, oR, oL, oDinv, oStage, floats;
  __host__ __device__ WideLayout(int n, int m, int depth) {
    n8 = round_up(n, 8);
    m8 = round_up(m, 8);
    nb = (n + 15) / 16;
    mb = (m + 15) / 16;
    m16 = 16 * mb;
    slots = 16 * (nb + mb);
    ld = n8 + 4;         // Vxx, Y', Mt: k along the row, = 4 mod 8
    // [Qu | Qux] and [k | K]: k down the column, = 8 mod 16, >= n + 1; an
    // item's 16 columns read past the row's end into the next row (or the
    // region's 16 floats of padding) only for columns whose results are dropped
    ldr = (n + 1 + 7) / 16 * 16 + 8;
    ldL = m + 1;         // odd: a warp's lanes on a row of L hit distinct banks
    oLx = slots * ld;    // a stage buffer: Mt (slots, ld), lx, lu, luu_diag
    oLu = oLx + round_up(n, 4);
    oLd = oLu + round_up(m, 4);
    stage = oLd + round_up(m, 4);
    oV = 0;                                    // Vxx, Qxx in its place   (16 nb, ld)
    oVx = oV + 16 * nb * ld;                   // Vx, zero past n         (n8)
    oQx = oVx + n8;                            // Qx                      (n)
    oY = oQx + round_up(n, 4);                 // Y' (slots, ld); then [k | K] (m16, ldr)
    const int y = slots * ld, xx = m16 * ldr + 16;
    oXX = oY;
    oQi = oY + (y > xx ? y : xx);              // Quu^{-1}, (a, b) at b m16 + a  (m16, m16)
    oR = oQi + m16 * m16;                      // [Qu | Qux]              (m16, ldr)
    oL = oR + m16 * ldr + 16;                  // Quu, L by columns       (m, ldL)
    oDinv = oL + round_up(m * ldL, 4);         // 1 / L[a][a]             (m)
    oStage = oDinv + round_up(m, 4);           // depth stage buffers
    floats = oStage + depth * stage;
  }
};

using tf32_mma::block16;

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

// The columns of an (n, cols) matrix at src, entry (j, c) at src[j sr + c
// sc], as the rows of dst (stride ld, 16-byte aligned): dst[c ld + j]. A
// warp a column and a lane four floats where the columns are contiguous
// and 16-byte aligned; a warp a column and a lane a float where they are
// contiguous but not aligned; else a warp a row of src and a lane a column
// (a row-major src read along its rows).
template <bool kShared>
__device__ __forceinline__ void copy_columns(float* dst, int ld, const float* src, int n, int cols,
                                             long long sr, long long sc, int warp, int nw,
                                             int lane) {
  if (sr == 1) {
    if (n % 4 == 0 && sc % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      for (int c = warp; c < cols; c += nw)
        for (int j = 4 * lane; j < n; j += 128) copy4<kShared>(dst + c * ld + j, src + c * sc + j);
    } else {
      for (int c = warp; c < cols; c += nw)
        for (int j = lane; j < n; j += 32) copy1<kShared>(dst + c * ld + j, src + c * sc + j);
    }
  } else {
    for (int j = warp; j < n; j += nw)
      for (int c = lane; c < cols; c += 32) copy1<kShared>(dst + c * ld + j, src + j * sr + c * sc);
  }
}

// kShared: the working set in dynamic shared memory and the stage copied by
// cp.async; otherwise in `work` (a block's slice of
// `floats` floats) and copied by plain loads and stores. depth: stage
// buffers, 2 (the next stage copied during a step) or 1 (copied at its top).
// MB: 8, 16 or 32, the warp's register inverse of Quu for m <= MB; 0, the
// block's factor (any m). The shared-memory form's bound keeps 128 registers
// a thread for MB = 16 and 32 (four blocks an SM at 128 threads: the
// formation's (48, 16)); MB = 8, MB = 0 and the workspace form take more
// (at 128 they spilled), with fewer blocks an SM.
template <bool kShared, int MB>
__global__ void __launch_bounds__(kWideThreadsBig, kShared && (MB == 16 || MB == 32) ? 2 : 1)
    backward_wide_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                         Strides sa, Strides sb, const float* __restrict__ lxs,
                         const float* __restrict__ lus, const float* __restrict__ luud,
                         const float* __restrict__ lxx, const float* __restrict__ luu_reg,
                         const float* __restrict__ lxT, const float* __restrict__ lxxT,
                         float* __restrict__ ks, float* __restrict__ Ks, int n, int m, int T,
                         int depth, float* __restrict__ work) {
  extern __shared__ __align__(16) float wide_smem[];
  const WideLayout L(n, m, depth);
  const size_t s = blockIdx.x;
  float* const base = kShared ? wide_smem : work + s * static_cast<size_t>(L.floats);
  float* const V = base + L.oV;
  float* const Vx = base + L.oVx;
  float* const Qx = base + L.oQx;
  float* const Y = base + L.oY;
  float* const XX = base + L.oXX;
  float* const Qi = base + L.oQi;
  float* const R = base + L.oR;  // [Qu | Qux]: Qu(a) at R[a ldr], Qux(a, c) at R[a ldr + 1 + c]
  float* const Lq = base + L.oL;
  float* const dinv = base + L.oDinv;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32, warp = tid / 32, nw = nt / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nc = n + 1, ld = L.ld, ldr = L.ldr, ldL = L.ldL, m8 = L.m8, m16 = L.m16, nb = L.nb;
  const int mb = L.mb;
  const int kn = L.n8 / 8, km = m8 / 8, bslot = 16 * nb;  // k-steps over n and m; B's first slot
  const bool has_ld = luud != nullptr;

  // Stage `stage` into buffer `buf`: A's columns at Mt's rows 0.., B's at
  // 16 nb.., then lx, lu and luu_diag.
  auto fetch = [&](int stage, float* buf) {
    const size_t st = s * T + stage;
    copy_columns<kShared>(buf, ld, As + s * sa.s + stage * sa.t, n, n, sa.r, sa.c, warp, nw, lane);
    copy_columns<kShared>(buf + bslot * ld, ld, Bs + s * sb.s + stage * sb.t, n, m, sb.r, sb.c,
                          warp, nw, lane);
    for (int e = tid; e < n; e += nt) copy1<kShared>(buf + L.oLx + e, lxs + st * n + e);
    for (int e = tid; e < m; e += nt) {
      copy1<kShared>(buf + L.oLu + e, lus + st * m + e);
      if (has_ld) copy1<kShared>(buf + L.oLd + e, luud + st * m + e);
    }
    if (kShared) __pipeline_commit();
  };
  auto buffer = [&](int t) { return base + L.oStage + (depth == 2 ? (t & 1) : 0) * L.stage; };

  // Every float of the working set zero (the padding stays so), then Vxx =
  // lxxT and Vx = lxT
  for (int e = tid; e < L.floats; e += nt) base[e] = 0.0f;
  __syncthreads();
  for (int r = warp; r < n; r += nw)
    for (int c = lane; c < n; c += 32) V[r * ld + c] = lxxT[r * n + c];
  for (int e = tid; e < n; e += nt) Vx[e] = lxT[s * n + e];
  if (T > 0 && depth == 2) fetch(T - 1, buffer(0));

  for (int t = 0; t < T; ++t) {
    const int stage = T - 1 - t;
    float* const M = buffer(t);  // Mt: entry (j, c) of M at M[slot(c) ld + j]
    if (depth == 1) fetch(stage, M);  // the buffer's last reader, phase 2, is barriers behind
    if (kShared) __pipeline_wait_prior(0);
    __syncthreads();  // the stage, Vxx and Vx are in place; buffer(t + 1) is read no more
    if (depth == 2 && t + 1 < T) fetch(stage - 1, buffer(t + 1));
    const float* const lx = M + L.oLx;
    const float* const lu = M + L.oLu;
    const float* const ldg = M + L.oLd;

    // 1. Y = Vxx M by (16 rows of Vxx, 16 slots), stored as Y' (entry (i,
    // c) at Y[c ld + i], i < n8: the k range of phase 2); then Qx and Qu
    for (int it = warp; it < nb * (nb + mb); it += nw) {
      const int p = it % nb, q = it / nb;
      float out[2][4];
      block16<true, kShared>(V + 16 * p * ld, ld, M + 16 * q * ld, ld, kn, lane, out);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * p + g + 8 * (e >> 1), c = 16 * q + 8 * h + 2 * t4 + (e & 1);
          if (i < L.n8) Y[c * ld + i] = out[h][e];
        }
    }
    for (int c = tid; c < n + m; c += nt) {  // a thread a column of M, 16-byte loads
      const float4* col = reinterpret_cast<const float4*>(M + (c < n ? c : bslot + c - n) * ld);
      const float4* vx = reinterpret_cast<const float4*>(Vx);
      float acc[2] = {};
      for (int j = 0; j < L.n8 / 4; ++j) {
        const float4 a = col[j], v = vx[j];
        float& sum = acc[j & 1];
        sum = fmaf(a.x, v.x, fmaf(a.y, v.y, fmaf(a.z, v.z, fmaf(a.w, v.w, sum))));
      }
      if (c < n)
        Qx[c] = lx[c] + (acc[0] + acc[1]);
      else
        R[(c - n) * ldr] = lu[c - n] + (acc[0] + acc[1]);
    }
    __syncthreads();

    // 2. M'Y by 16 x 16 blocks: Quu's (B slots x B slots, with luu_reg and
    // luu_diag, into the factor's storage), Qux's (B slots x A slots) and
    // Qxx's upper block triangle (A'W + lxx into Vxx's place, c <= c').
    // For m <= MB warp 0 takes Quu's blocks and inverts Quu in its
    // registers while the other warps take the rest
    const int nquu = mb * mb, nqux = mb * nb, items = nquu + nqux + nb * (nb + 1) / 2;
    auto block = [&](int it) {
      int p, q, kind;  // kind 0 Quu, 1 Qux, 2 Qxx; (p, q) the row and column blocks
      if (it < nquu) {
        kind = 0, p = it % mb, q = it / mb;
      } else if (it < nquu + nqux) {
        kind = 1, p = (it - nquu) % mb, q = (it - nquu) / mb;
      } else {
        kind = 2, q = 0;
        for (p = it - nquu - nqux; p > q; ++q) p -= q + 1;  // (p, q), p <= q, column by column
      }
      const int r0 = (kind == 2 ? 0 : bslot) + 16 * p, c0 = (kind == 0 ? bslot : 0) + 16 * q;
      float out[2][4];
      block16<true, kShared>(M + r0 * ld, ld, Y + c0 * ld, ld, kn, lane, out);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * p + g + 8 * (e >> 1), c = 16 * q + 8 * h + 2 * t4 + (e & 1);
          const float v = out[h][e];
          if (kind == 0) {
            if (r < m && c < m)  // Quu[r][c], entry (r, c) of the factor's storage
              Lq[c * ldL + r] = v + luu_reg[r * m + c] + (r == c ? ldg[c] : 0.0f);
          } else if (kind == 1) {
            if (r < m && c < n) R[r * ldr + 1 + c] = v;
          } else if (c < n && r <= c) {
            V[r * ld + c] = v + lxx[r * n + c];
          }
        }
    };
    if (MB > 0 && warp == 0) {
      for (int it = 0; it < nquu; ++it) block(it);
      __syncwarp();
      if constexpr (MB > 0) spd_inverse_warp<MB>(Lq, ldL, m, Qi, m16, lane);
    } else {
      const int w = MB > 0 ? warp - 1 : warp, ws = MB > 0 ? nw - 1 : nw;
      for (int it = (MB > 0 ? nquu : 0) + w; it < items; it += ws) block(it);
    }
    __syncthreads();

    if constexpr (MB > 0) {
      // 3. [k | K] = -Quu^{-1} [Qu | Qux] on the tensor cores, by 16 x 16
      // blocks (rows of Quu^{-1}, columns of [Qu | Qux]), k = b down
      // Quu^{-1}'s and [Qu | Qux]'s columns; Quu^{-1}'s rows past m are zero,
      // and so are [k | K]'s
      const int ncb = (nc + 15) / 16;
      for (int it = warp; it < mb * ncb; it += nw) {
        const int p = it % mb, q = it / mb;
        float out[2][4];
        block16<false, kShared>(Qi + 16 * p, m16, R + 16 * q, ldr, km, lane, out);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int a = 16 * p + g + 8 * (e >> 1), col = 16 * q + 8 * h + 2 * t4 + (e & 1);
            if (col < nc) XX[a * ldr + col] = -out[h][e];
          }
      }
      __syncthreads();
    } else {
      // 3. [Qu | Qux] into XX (the rows past m zero); Quu = L L' in place
      // (entry (i, k) of L at Lq[k * ldL + i]) and the forward substitution
      // L Y = XX in place, right-looking: at pivot j the block scales column
      // j of L and row j of Y (then final), and after a barrier a warp
      // takes each row i > j, its lanes the trailing entries (i, k), j < k
      // <= i, and the row's right-hand sides
      for (int it = tid; it < m16 * nc; it += nt) {
        const int a = it / nc, col = it % nc;
        XX[a * ldr + col] = a >= m ? 0.0f : R[a * ldr + col];
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float inv = rsqrtf(Lq[j * ldL + j]);
        for (int i = j + 1 + tid; i < m; i += nt) Lq[j * ldL + i] *= inv;
        for (int col = tid; col < nc; col += nt) XX[j * ldr + col] *= inv;
        if (tid == 0) dinv[j] = inv;
        __syncthreads();
        for (int i = j + 1 + warp; i < m; i += nw) {
          const float lij = Lq[j * ldL + i];
          for (int k = j + 1 + lane; k <= i; k += 32) Lq[k * ldL + i] -= lij * Lq[j * ldL + k];
          for (int col = lane; col < nc; col += 32) XX[i * ldr + col] -= lij * XX[j * ldr + col];
        }
        __syncthreads();
      }
      // the back substitution L' X = Y in place, right-looking from the
      // last row: at row a, x_a = Y[a] / L[a][a] is final, and a warp a row
      // q < a takes Y[q] -= L[a][q] x_a; then XX = -X = [k | K]
      for (int a = m - 1; a >= 0; --a) {
        const float da = dinv[a];
        for (int q = warp; q < a; q += nw) {
          const float laq = Lq[q * ldL + a];
          for (int col = lane; col < nc; col += 32)
            XX[q * ldr + col] -= laq * (XX[a * ldr + col] * da);
        }
        __syncthreads();
      }
      for (int it = tid; it < m * nc; it += nt) {
        const int a = it / nc, col = it % nc;
        XX[a * ldr + col] *= -dinv[a];
      }
      __syncthreads();
    }

    // 4. k and K stored; Vx' = Qx + Qux'k; Vxx' = Qxx + Qux'K by 16 x 16
    // blocks of its upper block triangle, k = a down Qux's and K's columns,
    // written at (r, c) and (c, r) for r <= c
    {
      const size_t st = s * T + stage;
      for (int a = tid; a < m; a += nt) ks[st * m + a] = XX[a * ldr];
      float* const Kout = Ks + st * m * n;
      for (int a = warp; a < m; a += nw)
        for (int i = lane; i < n; i += 32) Kout[a * n + i] = XX[a * ldr + 1 + i];
    }
    for (int c = tid; c < n; c += nt) {
      float acc = Qx[c];
      for (int a = 0; a < m; ++a) acc = fmaf(R[a * ldr + 1 + c], XX[a * ldr], acc);
      Vx[c] = acc;
    }
    for (int it = warp; it < nb * (nb + 1) / 2; it += nw) {
      int p = it, q = 0;
      for (; p > q; ++q) p -= q + 1;
      float out[2][4];
      block16<false, kShared>(R + 1 + 16 * p, ldr, XX + 1 + 16 * q, ldr, km, lane, out);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * p + g + 8 * (e >> 1), c = 16 * q + 8 * h + 2 * t4 + (e & 1);
          if (c < n && r <= c) {
            const float v = V[r * ld + c] + out[h][e];
            V[r * ld + c] = v;
            V[c * ld + r] = v;
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
cudaError_t launch_wide_mb(const float* As, const float* Bs, Strides sa, Strides sb,
                           const float* lxs, const float* lus, const float* luud,
                           const float* lxx, const float* luu_reg, const float* lxT,
                           const float* lxxT, float* ks, float* Ks, int N, int n, int m, int T,
                           float* work, int depth, int threads, cudaStream_t stream) {
  if (depth > 0) {
    const size_t smem = wide_bytes(n, m, depth);
    const cudaError_t err = cudaFuncSetAttribute(backward_wide_kernel<true, MB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    backward_wide_kernel<true, MB><<<N, threads, smem, stream>>>(
        As, Bs, sa, sb, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, n, m, T, depth, nullptr);
  } else {
    if (work == nullptr) return cudaErrorInvalidValue;
    backward_wide_kernel<false, MB><<<N, threads, 0, stream>>>(
        As, Bs, sa, sb, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, n, m, T, 1, work);
  }
  return cudaGetLastError();
}

// The wide form with As and Bs at their element strides.
cudaError_t launch_wide_strided(const float* As, const float* Bs, Strides sa, Strides sb,
                                const float* lxs, const float* lus, const float* luud,
                                const float* lxx, const float* luu_reg, const float* lxT,
                                const float* lxxT, float* ks, float* Ks, int N, int n, int m,
                                int T, float* work, cudaStream_t stream) {
  int optin = 0;
  const cudaError_t err = wide_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  const int depth = wide_shared_depth(n, m, optin), threads = wide_threads(n, m);
#define NPT_WIDE_MB(MB)                                                                       \
  launch_wide_mb<MB>(As, Bs, sa, sb, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, \
                     T, work, depth, threads, stream)
  if (m <= 8) return NPT_WIDE_MB(8);
  if (m <= 16) return NPT_WIDE_MB(16);
  if (m <= 32) return NPT_WIDE_MB(32);
  return NPT_WIDE_MB(0);
#undef NPT_WIDE_MB
}

}  // namespace ilqr_bwd

// The floats of device workspace npt_ilqr_backward_wide needs for N scenarios at
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

// The wide form npt_ilqr_backward_wide takes at (n, m) on the current device: 2
// or 1, the stage buffers of the shared-memory form; 0, the workspace form;
// -1 where the narrow forms take (n, m) or on a CUDA error.
extern "C" int npt_ilqr_backward_wide_depth(int n, int m) {
  using namespace ilqr_bwd;
  if (n < 1 || m < 1 || (n <= 16 && m <= 8)) return -1;
  int optin = 0;
  if (wide_optin_bytes(&optin) != cudaSuccess) return -1;
  return wide_shared_depth(n, m, optin);
}

// The wide K7 (n > 16 or m > 8; npt_ilqr_backward takes the narrow forms)
// with As (N, T, n, n) and Bs (N, T, n, m) at any element strides
// (scenario, stage, row, column): the linearization's column-major
// Jacobians (row stride 1) are read in place. The other operands as
// npt_ilqr_backward's, row-major contiguous; `work` a device workspace of
// npt_ilqr_backward_workspace(N, n, m) floats, null where that is 0.
// Returns the CUDA error code of the launch.
extern "C" int npt_ilqr_backward_wide(const float* As, const float* Bs, const float* lxs,
                                      const float* lus, const float* luud, const float* lxx,
                                      const float* luu_reg, const float* lxT, const float* lxxT,
                                      float* ks, float* Ks, int N, int n, int m, int T,
                                      float* work, long long sa_s, long long sa_t,
                                      long long sa_r, long long sa_c, long long sb_s,
                                      long long sb_t, long long sb_r, long long sb_c,
                                      void* stream) {
  using namespace ilqr_bwd;
  if (N < 1 || n < 1 || m < 1 || T < 0 || (n <= 16 && m <= 8))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wide_strided(
      As, Bs, Strides{sa_s, sa_t, sa_r, sa_c}, Strides{sb_s, sb_t, sb_r, sb_c}, lxs, lus, luud,
      lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, T, work, static_cast<cudaStream_t>(stream)));
}
