// Wide batched Kalman and RTS mean passes: K9 past its narrow buckets
// (n > 16 or p > 8) and K10 past n = 16, for any (n, p).
//
// Replaces the TPU kernels numpower_tpu/kernels/kalman_batched.py
// kalman_mean_pass_pallas (_kf_mean_kernel) and numpower_tpu/kernels/
// rts_batched.py rts_mean_pass_pallas (_rts_mean_kernel), which hold no size
// check, where the narrow forms (csrc/kalman_mean.cu, csrc/rts_mean.cu: one
// lane a trajectory, its state in registers) end. K9 runs, for every
// trajectory s and step t,
//     x_p = x A' + u_t,  v = y_t - x_p C',  x = x_p + v W_t,
//     alpha = v invL_t',  ll -= 0.5 |alpha|^2 + cst_t,
// and writes xs_f, xs_p (T, N, n) and ll (N,); K10 sets x_s[T-1] = x_last
// and runs x_s[t] = x_s[t+1] G_t' + e_t for t = T-2 .. 0 into xs (T, N, n):
// the JAX package's time-major layouts, the narrow forms' arguments.
//
// What bounds it. Each step is a chain of small products of a tile of
// trajectories with matrices every trajectory shares: at the four-quadrotor
// formation (n = 48, p = 24, N = 4096, T = 50) K9's products are N T (2n^2 +
// 4np + 2p^2) = 2.12 GFLOP, 12.9 us on the tensor cores in three TF32
// passes (3 x 2.12 GFLOP at 495 TFLOP/s; 32.1 us were it all fp32 at 67),
// against 99.1 MB of data and outputs (29.6 us at 3.35 TB/s; 138.4 MB and
// 41.3 us with inputs): bytes. K10 moves 78.6 MB (23.5 us) for 0.92 GFLOP
// (13.8 us): bytes. The recurrence leaves a block no parallelism but its
// tile's rows and a product's output columns, so a step is a chain of three
// dependent products, each a few k-steps deep. K9's form 0:
//   - a block of eight warps takes a tile of 16 trajectories (one m16 row
//     tile; 2 blocks an SM at N = 4096), and each product of a step runs on
//     the tensor cores: mma.sync m16n8k8 in the rounded 3xTF32 form of
//     tf32_mma.cuh (hi rounded to the nearest TF32; each k-step's hi*hi from
//     a fresh accumulator added in fp32), the A fragment of the tile by
//     ldmatrix, the matrix's B words by 32-bit shared loads (A, C, invL_t as
//     rows at a stride of an odd count of 16-byte pieces, W_t depth-major at
//     a stride of 8 or 24 mod 32: no bank conflict). The algebra is the JAX
//     kernel's: x_p = x A' + u_t, v = y_t - x_p C', then x = x_p + v W_t
//     and alpha = v invL_t', the three products in that order;
//   - each phase's n8 output tiles are spread over the warps, one at a time
//     a warp: x A' (6 tiles at the formation), then x_p C' (3) beside the
//     previous step's alpha (3; v in two buffers, so a step's v is read in
//     the next), then x = x_p + v W_t (6): the step's chain is three
//     products, the last 3 k-steps deep; a product's k-loop holds no branch
//     (the next k-step's fragments are loaded before this one's products,
//     the last one's again), since a branch there put a WARPSYNC before
//     every ldmatrix and mma.sync;
//   - x, x_p and v live in shared memory, zero padded to multiples of 8;
//     A and C are copied once; the last two warps, idle in every phase at
//     n = 48, issue the step's cp.async copies, one part a phase: W_t (a
//     step ahead into two buffers, or at the step into one where two do not
//     fit) beside x A', the tile's rows of y and u of the next step beside
//     x_p C', invL_t (one buffer, read in the next step) beside v W_t;
//   - x_f and x_p also go to dense buffers, and one thread stores each as
//     one bulk copy (cp.async.bulk) after the writers' proxy fence and a
//     barrier, double buffered (16-byte stores of every thread where the run
//     is not 16-byte aligned; from the tile, a warp a row, where the dense
//     buffers do not fit);
//   - each trajectory's ll is summed over the alpha tiles' row sums, each
//     reduced by shuffles in a fixed order, so a run is reproducible bit
//     for bit; the arithmetic is the form's before alpha moved (its means
//     and ll held the same distances from plain and float64).
// Where form 0 does not fit in shared memory (K9 past about (140, 70)),
// forms 1 and 2 keep the CUDA cores' tile products below (kalman_wide_ffma_
// kernel): a block of 256 threads takes S trajectories (32, halved to 4
// while its shared memory does not fit), a thread 4 trajectories x 4
// output components over the depth in quads of 4 from 16-byte shared loads,
// the matrices read through L1 (form 1), and past n + p of about 3,500 the
// tile in a device workspace the wrapper allocates (form 2). K10 keeps that
// design in all three forms (its form 0 with G_t' in shared memory). No
// (n, p) is refused for its size. In forms 1 and 2 and K10 every sum over
// the depth runs in ascending order, as one dot product (in blocks of 128
// past that depth, each block's sum added in order).
//
// Measured (H100 80GB HBM3, 700 W; probes/kalman_wide_turns.py at the
// formation, in turns with the form before, 301-302 us own): K9 form 0
// 157.3-157.4 us own (161.3-161.4 with inputs, 328.6-328.7 before), 19% of
// its bytes bound; K10 116 us, 20.3% of its bytes bound. With alpha beside
// v W_t and the copies on the last warp alone, the same products ran 181-184
// us: that warp's copies (~3,200 cycles of a ~6,400-cycle step) held the
// barrier after x A'. Now the copies cost nothing measurable (taken out:
// 165.3 against 165.8 us by events), alpha ~8 us (no_alpha 158.0); one
// copying warp instead of two ran as fast (163.9). Earlier forms of this
// design: every mma.sync replaced by an add ran as fast (the tensor cores
// cost nothing here); four warps a block, two tiles a warp (245-250 us); the
// tile kept as its TF32 hi and lo planes (242-245 us, and no room at (130,
// 67)); the cross terms in two accumulators, or from fresh ones (no faster);
// the k-loop unrolled 1, 3 or 6 times (within 3%); x_p C' split over two
// halves of its depth (184 against 173 unsplit).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "tf32_mma.cuh"

namespace kalman_wide {

constexpr int kMaxTile = 32;  // trajectories a block (S), at most, of forms 1 and 2
constexpr int kMinTile = 4;   // a thread's 4 rows
constexpr int kThreads = 256;  // a block's, forms 1 and 2
constexpr int kMmaTile = 16;      // trajectories a block of form 0: one m16 row tile
constexpr int kMmaThreads = 256;  // form 0's block: eight warps
constexpr int kMmaWarps = kMmaThreads / 32;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// A row stride of at least x floats (x a multiple of 4) with an odd count of
// 16-byte pieces: consecutive rows start in distinct 16-byte bank groups.
__host__ __device__ inline int odd_stride(int x) { return ((x >> 2) & 1) ? x : x + 4; }

// A row stride of at least x floats (x a multiple of 4) that is 8 or 24 mod
// 32: the 32-bit loads of an m16n8k8 B fragment from a depth-major matrix
// (rows k + t and k + t + 4, columns j + g: lane (g, t)) meet no bank conflict.
__host__ __device__ inline int depth_stride(int x) {
  while ((x & 31) != 8 && (x & 31) != 24) x += 4;
  return x;
}

__host__ __device__ inline int log2_of(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The block's floats: in shared memory (forms 0 and 1) or in the device
// workspace (form 2), all offsets multiples of 4 floats.
struct Geo {
  int n, p, nP, pP;  // widths, and rounded up to multiples of 4
  int S, lgST;       // trajectories a block; log2 of its 4-row groups ST = S / 4
  int ldX, ldV;      // row strides of the tile's x and x_p (ldX), and v (ldV)
  int ldA, ldC, ldL, ldG;
  int oA, oC, oW, oL, oG, oX, oXp, oV, oPart, oY, oU, oE;
  int wBuf, lBuf, gBuf, yBuf, uBuf, eBuf;  // floats of one buffer of each staged input
  int floats;                              // the block's floats in all
  // K9's form 0 alone: W_t's row stride; the dense buffers of x_f and x_p
  // (oSF, oSP, sBuf floats each), present where `dense`, for the bulk
  // stores; the buffers of W_t (2: staged a step ahead; 1: at the step)
  int ldW, oSF, oSP, sBuf, dense, wBufs;
};

// K9's layout in form 0 (tensor cores; matrices, tile and inputs in shared
// memory) for a tile of kMmaTile trajectories: n and p padded to multiples of
// 8 (the products' k-steps and n8 tiles, zeros past the edges); the tile's
// x, x_p, v (two buffers: a step's v is read in the next) and the matrices
// read as rows (A, C, invL_t) at strides of an odd count of 16-byte pieces
// (ldmatrix's eight rows and the B fragments' 32-bit loads meet no bank
// conflict), W_t depth-major at depth_stride; invL_t in one buffer (staged
// in its step's last phase, read in the next step); with `dense` two
// buffers each of x_f and x_p as dense runs of rows x n.
inline Geo layout_k9_mma(int n, int p, bool has_u, int w_bufs, int dense) {
  Geo g{};
  constexpr int S = kMmaTile;
  g.n = n, g.p = p, g.nP = round8(n), g.pP = round8(p), g.S = S;
  g.ldX = odd_stride(g.nP), g.ldV = odd_stride(g.pP);
  g.ldA = odd_stride(g.nP), g.ldC = odd_stride(g.nP), g.ldL = odd_stride(g.pP);
  g.ldW = depth_stride(g.nP);
  g.wBufs = w_bufs, g.dense = dense;
  int o = 0;
  g.oA = o, o += g.nP * g.ldA;
  g.oC = o, o += g.pP * g.ldC;
  g.wBuf = g.pP * g.ldW, g.oW = o, o += w_bufs * g.wBuf;
  g.lBuf = g.pP * g.ldL, g.oL = o, o += g.lBuf;
  g.oX = o, o += S * g.ldX;
  g.oXp = o, o += S * g.ldX;
  g.oV = o, o += 2 * S * g.ldV;
  g.oPart = o, o += (g.pP / 8) * S;
  g.yBuf = async_copy::slot_floats(S * p), g.oY = o, o += 2 * g.yBuf;
  g.uBuf = has_u ? async_copy::slot_floats(S * n) : 0, g.oU = o, o += 2 * g.uBuf;
  g.sBuf = dense ? round4(S * n) : 0;
  g.oSF = o, o += 2 * g.sBuf;
  g.oSP = o, o += 2 * g.sBuf;
  g.floats = o;
  return g;
}

// K9's layout in forms 1 (the matrices read through L1, the inputs staged)
// and 2 (the tile in the workspace, nothing staged) for tiles of S
// trajectories.
inline Geo layout_k9(int n, int p, int S, int form, bool has_u) {
  Geo g{};
  g.n = n, g.p = p, g.nP = round4(n), g.pP = round4(p), g.S = S, g.lgST = log2_of(S / 4);
  g.ldX = odd_stride(g.nP), g.ldV = odd_stride(g.pP);
  int o = 0;
  g.oX = o, o += S * g.ldX;
  g.oXp = o, o += S * g.ldX;
  g.oV = o, o += S * g.ldV;
  g.oPart = o, o += (g.pP / 4) * S;
  if (form <= 1) {
    g.yBuf = async_copy::slot_floats(S * p), g.oY = o, o += 2 * g.yBuf;
    g.uBuf = has_u ? async_copy::slot_floats(S * n) : 0, g.oU = o, o += 2 * g.uBuf;
  }
  g.floats = o;
  return g;
}

// K10's layout: the tile's x twice (this step's and the next), G_t' (form 0)
// and the rows of e_t (forms 0, 1) staged.
inline Geo layout_k10(int n, int S, int form) {
  Geo g{};
  g.n = n, g.p = 0, g.nP = round4(n), g.pP = 0, g.S = S, g.lgST = log2_of(S / 4);
  g.ldX = odd_stride(g.nP), g.ldG = g.nP;
  int o = 0;
  if (form == 0) g.gBuf = g.nP * g.nP, g.oG = o, o += 2 * g.gBuf;  // depth-major (i, k)
  g.oX = o, o += 2 * S * g.ldX;
  if (form <= 1) g.eBuf = async_copy::slot_floats(S * n), g.oE = o, o += 2 * g.eBuf;
  g.floats = o;
  return g;
}

// (row, column) of the flat index e = e0, e0 + step, ... over an array of
// `cols` columns, without a divide a step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int e0, int step, int cols_) : cols(cols_) {
    r = e0 / cols, c = e0 - r * cols, dr = step / cols, dc = step - dr * cols;
  }
  __device__ void next() {
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  }
};

// The (rows x cols) row-major matrix at src into shared memory at dst (row
// stride ld) by cp.async: 16-byte pieces where the rows allow, else 4 bytes.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int rows,
                                           int cols, int tid, int nthr) {
  if ((cols & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    for (Walk w(tid, nthr, cols >> 2); w.r < rows; w.next())
      __pipeline_memcpy_async(dst + w.r * ld + 4 * w.c,
                              src + static_cast<size_t>(w.r) * cols + 4 * w.c, 16);
  } else {
    for (Walk w(tid, nthr, cols); w.r < rows; w.next())
      __pipeline_memcpy_async(dst + w.r * ld + w.c, src + static_cast<size_t>(w.r) * cols + w.c,
                              4);
  }
}

// A thread's share of staging a (rows x cols) row-major matrix from device
// memory into shared memory at row stride ld, the same shape every step:
// its first 16-byte piece's Walk formed once, so that a step's copy divides
// nothing; stage_rows where the rows are not whole 16-byte pieces.
struct RowStager {
  Walk w;
  int rows, cols, ld;
  __device__ RowStager(int rows_, int cols_, int ld_, int tid, int nthr)
      : w(tid, nthr, max(1, cols_ >> 2)), rows(rows_), cols(cols_), ld(ld_) {}
  __device__ void operator()(float* dst, const float* src, int tid, int nthr) const {
    if ((cols & 3) != 0 || (reinterpret_cast<uintptr_t>(src) & 15u) != 0) {
      stage_rows(dst, ld, src, rows, cols, tid, nthr);
      return;
    }
    for (Walk v = w; v.r < rows; v.next())
      __pipeline_memcpy_async(dst + v.r * ld + 4 * v.c,
                              src + static_cast<size_t>(v.r) * cols + 4 * v.c, 16);
  }
};

// rows x n floats of the tile (row stride ld) to the contiguous run at dst:
// a warp a row, its lanes along it.
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, int ld,
                                           int rows, int n, int tid, int nthr) {
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += nthr >> 5)
    for (int c = lane; c < n; c += 32) dst[r * n + c] = src[r * ld + c];
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// row[k .. k+3], each entry past kmax zero, through L1.
__device__ __forceinline__ float4 ldg4(const float* row, int k, int kmax) {
  return make_float4(k < kmax ? __ldg(row + k) : 0.0f, k + 1 < kmax ? __ldg(row + k + 1) : 0.0f,
                     k + 2 < kmax ? __ldg(row + k + 2) : 0.0f,
                     k + 3 < kmax ? __ldg(row + k + 3) : 0.0f);
}

// The matrix operand of a tile product, quad kq of the depth. Output-major
// (M[j][k], the thread's columns j = jt + JT c): m[c] = M[j_c][4kq .. 4kq+3].
// Depth-major (M[k][j], the thread's columns j = 4 jt + c): m[d] =
// M[4kq + d][4jt .. 4jt+3]. In shared memory (zero padded), or in device
// memory (rows x cols at stride ld, read through L1 with zeros past the
// edges).
struct SharedDepth {
  const float* base;
  int ld, jt;
  __device__ void operator()(int kq, float4 (&m)[4]) const {
#pragma unroll
    for (int d = 0; d < 4; ++d)
      m[d] = *reinterpret_cast<const float4*>(base + (4 * kq + d) * ld + 4 * jt);
  }
};
struct GlobalRows {
  const float* base;
  int ld, rows, cols, jt, JT;
  __device__ void operator()(int kq, float4 (&m)[4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = jt + JT * c;
      m[c] = j < rows ? ldg4(base + static_cast<size_t>(j) * ld, 4 * kq, cols)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
};
struct GlobalDepth {
  const float* base;
  int ld, depth, cols, jt;
  __device__ void operator()(int kq, float4 (&m)[4]) const {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int k = 4 * kq + d;
      m[d] = k < depth ? ldg4(base + static_cast<size_t>(k) * ld, 4 * jt, cols)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
};

// acc[a][c] = sum_k in[(st + ST a) ld + k] M(k, column c) for the tile's 4
// rows and 4 columns, over K4 quads of the depth. Each depth step is one FMA
// into each of the 16 sums (16 independent chains), k ascending; past
// kBlockQuads quads the depth is summed in blocks of that many, each block's
// sum then added, so that a long depth (n in the thousands) keeps fp32's
// accuracy.
constexpr int kBlockQuads = 32;

template <bool kDepthMajor, class Mat>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const float* in, int ld, int st,
                                             int ST, int K4, const Mat& mat) {
  const float* const row0 = in + st * ld;
  const int step = ST * ld;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  for (int k0 = 0; k0 < K4; k0 += kBlockQuads) {
    float sum[4][4] = {};
    const int k1 = min(K4, k0 + kBlockQuads);
#pragma unroll 2
    for (int kq = k0; kq < k1; ++kq) {
      float x[4][4], m[4][4];  // x[a][d]: row a at depth 4kq + d; m[c][d]: column c
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(row0 + a * step + 4 * kq);
        x[a][0] = v.x, x[a][1] = v.y, x[a][2] = v.z, x[a][3] = v.w;
      }
      float4 q[4];
      mat(kq, q);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kDepthMajor) m[j][i] = lane_of(q[i], j);  // q[d] holds columns
          else m[i][j] = lane_of(q[i], j);                        // q[c] holds depths
        }
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[a][c] = fmaf(x[a][d], m[c][d], sum[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = acc[a][c] + sum[a][c];
  }
}

struct K9Args {
  const float *A, *C, *W, *iL, *cst, *x0s, *ys, *us;
  float *xf, *xp, *ll, *ws;
  int N, T;
};

// The bulk copies (the TMA's cp.async.bulk) that take form 0's stores off
// its threads: a dense run of shared memory to device memory, issued by one
// thread after every writer's proxy fence and a block barrier, in bulk
// groups that the issuing thread waits for before a buffer is written again.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(tf32_mma::smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the reads of every bulk group but the last kPending done
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A product's B operand for one n8 output tile, B(k, c) = m[c sc + k sk]
// from the tile's first column (in shared memory, zero padded), as lane
// (g, t)'s words of its fragments: B(8kk + t, g) at q[kk step] and
// B(8kk + t + 4, g) at q[kk step + off].
struct BLane {
  const float* q;
  int step, off;
  __device__ BLane(const float* m, int sc, int sk, int g, int t)
      : q(m + g * sc + t * sk), step(8 * sk), off(4 * sk) {}
  __device__ void load(uint32_t (&b)[2], int kk) const {
    b[0] = __float_as_uint(q[kk * step]);
    b[1] = __float_as_uint(q[kk * step + off]);
  }
};

// One k-step of one n8 tile in the rounded 3xTF32 form (tf32_mma.cuh's mma3
// with kRound, for a tile alone): cr += lo(a) hi(b) + hi(a) lo(b), and hi(a)
// hi(b) from a fresh accumulator added to hh in fp32.
__device__ __forceinline__ void mma3_tile(float (&hh)[4], float (&cr)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&b)[2]) {
  uint32_t bh[2], bl[2];
  tf32_mma::split_tf32<true>(b[0], bh[0], bl[0]);
  tf32_mma::split_tf32<true>(b[1], bh[1], bl[1]);
  tf32_mma::mma_tf32(cr, al, bh);
  tf32_mma::mma_tf32(cr, ah, bl);
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  tf32_mma::mma_tf32(part, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) hh[e] += part[e];
}

// out = the tile's 16 rows (A operand at a_addr, this lane's ldmatrix
// address: rows lane % 8 + 8 ((lane / 8) % 2), depths 4 (lane / 16)) times
// one n8 tile of B over `ksteps` k-steps of 8, k ascending. The fragments of
// k-step kk + 1 are loaded before k-step kk's products (ldmatrix and
// mma.sync are volatile asm, kept in source order), the last k-step's again
// at the end: no branch in the loop, since a branch there put a WARPSYNC
// before every ldmatrix and mma.sync. out[e] is entry (g + 8 (e >> 1),
// 2t + (e & 1)).
__device__ __forceinline__ void rows_product(float (&out)[4], uint32_t a_addr, int ksteps,
                                             const BLane& bl) {
  float hh[4] = {}, cr[4] = {};
  uint32_t a[4], b[2];
  tf32_mma::ldsm_x4(a, a_addr);
  bl.load(b, 0);
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t ah[4], al[4];
    const uint32_t bk[2] = {b[0], b[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_mma::split_tf32<true>(a[e], ah[e], al[e]);
    const int next = min(kk + 1, ksteps - 1);
    tf32_mma::ldsm_x4(a, a_addr + 32 * next);
    bl.load(b, next);
    mma3_tile(hh, cr, ah, al, bk);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = hh[e] + cr[e];
}

// K9's form 0: a block of eight warps takes kMmaTile trajectories; the
// step's three dependent products on the tensor cores, each phase's n8
// output tiles spread over the warps, one at a time: x A' (phase A), x_p C'
// and the previous step's alpha = v invL' (phase B), v W_t (phase C); the
// step's copies issued by the last two warps, idle in every phase at n = 48.
__global__ void __launch_bounds__(kMmaThreads, 2) kalman_wide_kernel(const K9Args a, const Geo g) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  constexpr int S = kMmaTile;
  constexpr int kStagers = 64;  // the last two warps' threads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' (g, t)
  const int n = g.n, p = g.p, N = a.N, T = a.T;
  const int JA = g.nP >> 3, JB = g.pP >> 3, KA = g.nP >> 3, KB = g.pP >> 3;
  const int s0 = blockIdx.x * S, rows = min(S, N - s0);
  const bool has_u = a.us != nullptr, dense = g.dense != 0, two_w = g.wBufs == 2;
  const int vBuf = S * g.ldV;  // floats of one buffer of v
  float* const X = sm + g.oX;
  float* const Xp = sm + g.oXp;
  float* const part = sm + g.oPart;
  const float* const Lt = sm + g.oL;
  // this lane's ldmatrix row address in a tile of row stride ld
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 4 * (lane >> 4);
  const uint32_t aX = tf32_mma::smem_u32(X + a_row * g.ldX + a_col);
  const uint32_t aXp = tf32_mma::smem_u32(Xp + a_row * g.ldX + a_col);
  const uint32_t aV = tf32_mma::smem_u32(sm + g.oV + a_row * g.ldV + a_col);

  for (int e = tid; e < g.floats; e += kMmaThreads) sm[e] = 0.0f;
  __syncthreads();
  stage_rows(sm + g.oA, g.ldA, a.A, n, n, tid, kMmaThreads);
  stage_rows(sm + g.oC, g.ldC, a.C, p, n, tid, kMmaThreads);
  stage_rows(X, g.ldX, a.x0s + static_cast<size_t>(s0) * n, rows, n, tid, kMmaThreads);

  // the copies are issued by the last two warps alone (the ones the
  // products leave idle where n <= 48 and p <= 24), spread over the step's
  // phases: W (phase A), the tile's rows of y and u (B), invL_t (C)
  const int st = tid - (kMmaThreads - kStagers);
  const bool stager = st >= 0;
  // the rows' ll, kept by the last warp's lanes
  const bool keeps_ll = warp == kMmaWarps - 1 && lane < rows;
  const RowStager stage_w(p, n, g.ldW, st, kStagers), stage_l(p, p, g.ldL, st, kStagers);
  auto stage_wt = [&](int t, int b) {  // W_t into buffer b
    stage_w(sm + g.oW + b * g.wBuf, a.W + static_cast<size_t>(t) * p * n, st, kStagers);
  };
  auto stage_yu = [&](int t) {  // the tile's rows of y_t and u_t into buffer t % 2
    const int b = t & 1;
    async_copy::copy_run_by_block(sm + g.oY + b * g.yBuf,
                                  a.ys + (static_cast<size_t>(t) * N + s0) * p, rows * p, st,
                                  kStagers);
    if (has_u)
      async_copy::copy_run_by_block(sm + g.oU + b * g.uBuf,
                                    a.us + (static_cast<size_t>(t) * N + s0) * n, rows * n, st,
                                    kStagers);
  };
  // rows x n floats of x_f or x_p of step t out: from the dense buffer by one
  // bulk copy where the run is 16-byte aligned (a bulk group a call, empty
  // otherwise, so that the waits below count alike), else by 16-byte stores
  // of every thread; without dense buffers from the tile, a warp a row
  auto store = [&](float* out, int t, const float* dense_src, const float* tile) {
    float* const dst = out + (static_cast<size_t>(t) * N + s0) * n;
    const int bytes = 4 * rows * n;
    if (!dense) {
      store_rows(dst, tile, g.ldX, rows, n, tid, kMmaThreads);
    } else if (((reinterpret_cast<uintptr_t>(dst) | static_cast<uintptr_t>(bytes)) & 15u) == 0) {
      if (tid == 0) bulk_store(dst, dense_src, bytes), bulk_commit();
    } else {
      if (tid == 0) bulk_commit();
      async_copy::store_run_by_block(dst, dense_src, rows * n, tid, kMmaThreads);
    }
  };
  // a phase's output tile j and its entry e: the trajectory (row) and component
  auto row_of = [&](int e) { return gq + 8 * (e >> 1); };
  auto col_of = [&](int j, int e) { return 8 * j + 2 * tq + (e & 1); };
  // tile j of alpha = v invL' (v in buffer b, invL in its buffer): the rows'
  // |alpha|^2 over its 8 columns, in a fixed order, into part
  auto alpha_tile = [&](int j, int b) {
    float out[4];
    rows_product(out, aV + 4 * b * vBuf, KB, BLane(Lt + 8 * j * g.ldL, g.ldL, 1, gq, tq));
    float lo = out[0] * out[0], hi = out[2] * out[2];
    lo = fmaf(out[1], out[1], lo);
    hi = fmaf(out[3], out[3], hi);
    lo = lo + __shfl_xor_sync(0xffffffffu, lo, 1);
    hi = hi + __shfl_xor_sync(0xffffffffu, hi, 1);
    lo = lo + __shfl_xor_sync(0xffffffffu, lo, 2);
    hi = hi + __shfl_xor_sync(0xffffffffu, hi, 2);
    if (tq == 0) part[j * S + gq] = lo, part[j * S + gq + 8] = hi;
  };
  // ll -= 0.5 |alpha|^2 + cst of the step whose squares part holds
  float ll = 0.0f;
  auto add_ll = [&](float cst) {
    float sq = 0.0f;
    for (int j = 0; j < JB; ++j) sq = sq + part[j * S + lane];
    ll = ll - 0.5f * sq - cst;
  };

  // three commit groups a step, in this order: W (phase A), y and u (B),
  // invL (C); so the step's first wait leaves only the last step's invL in
  // flight, and the wait before phase B lands it
  if (stager && two_w) stage_wt(0, 0);
  __pipeline_commit();
  if (stager) stage_yu(0);
  __pipeline_commit();
  __pipeline_commit();
  float cst_prev = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float cst_t = __ldg(a.cst + t);  // used a step later
    __pipeline_wait_prior(1);
    if (dense && tid == 0) bulk_wait_read<2>();  // x_p of step t - 2 has left its buffer
    __syncthreads();  // step t's inputs landed; step t - 1 done
    const int wb = two_w ? (t & 1) : 0;
    const size_t run = static_cast<size_t>(t) * N + s0;  // the tile's first row at step t

    // phase A: x_f of step t - 1 out; W of step t + 1 (two buffers) or t in;
    // x_p = x A' + u_t
    if (t > 0) store(a.xf, t - 1, sm + g.oSF + ((t - 1) & 1) * g.sBuf, X);
    if (stager) {
      if (!two_w) stage_wt(t, 0);
      else if (t + 1 < T) stage_wt(t + 1, (t + 1) & 1);
    }
    __pipeline_commit();
    {
      const float* U = nullptr;
      if (has_u) {
        const float* const src = a.us + run * n;
        U = sm + g.oU + (t & 1) * g.uBuf + async_copy::run_offset(src);
      }
      float* const SP = sm + g.oSP + (t & 1) * g.sBuf;
      for (int j = warp; j < JA; j += kMmaWarps) {
        float out[4];
        rows_product(out, aX, KA, BLane(sm + g.oA + 8 * j * g.ldA, g.ldA, 1, gq, tq));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row_of(e), c = col_of(j, e);
          const bool real = r < rows && c < n;
          float v = out[e];
          if (U != nullptr && real) v = v + U[r * n + c];
          Xp[r * g.ldX + c] = v;
          if (dense && real) SP[r * n + c] = v;
        }
      }
    }
    __pipeline_wait_prior(1);  // invL of step t - 1 landed
    if (dense) fence_proxy_async();
    __syncthreads();

    // phase B: x_p out; the rows of y and u of step t + 1 in; v = y_t - x_p
    // C' into v's buffer t % 2, and alpha of step t - 1 from the other:
    // x_p C''s JB tiles, then alpha's, as one list over the warps
    store(a.xp, t, sm + g.oSP + (t & 1) * g.sBuf, Xp);
    if (stager && t + 1 < T) stage_yu(t + 1);
    __pipeline_commit();
    {
      const float* const src = a.ys + run * p;
      const float* const Y = sm + g.oY + (t & 1) * g.yBuf + async_copy::run_offset(src);
      float* const V = sm + g.oV + (t & 1) * vBuf;
      for (int u = warp; u < (t > 0 ? 2 * JB : JB); u += kMmaWarps) {
        if (u >= JB) {
          alpha_tile(u - JB, (t - 1) & 1);
          continue;
        }
        float out[4];
        rows_product(out, aXp, KA, BLane(sm + g.oC + 8 * u * g.ldC, g.ldC, 1, gq, tq));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row_of(e), c = col_of(u, e);
          const float y = (r < rows && c < p) ? Y[r * p + c] : 0.0f;
          V[r * g.ldV + c] = y - out[e];
        }
      }
    }
    if (!two_w) __pipeline_wait_prior(1);  // W_t landed
    if (dense && tid == 0) bulk_wait_read<3>();  // x_f of step t - 2 has left its buffer
    __syncthreads();

    // phase C: invL_t in; ll of step t - 1; x = x_p + v W_t
    if (stager) stage_l(sm + g.oL, a.iL + static_cast<size_t>(t) * p * p, st, kStagers);
    __pipeline_commit();
    if (t > 0 && keeps_ll) add_ll(cst_prev);
    {
      const float* const Wt = sm + g.oW + wb * g.wBuf;
      float* const SF = sm + g.oSF + (t & 1) * g.sBuf;
      const uint32_t aVt = aV + 4 * (t & 1) * vBuf;
      for (int q = warp; q < JA; q += kMmaWarps) {
        float out[4];
        rows_product(out, aVt, KB, BLane(Wt + 8 * q, 1, g.ldW, gq, tq));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row_of(e), c = col_of(q, e);
          const float v = Xp[r * g.ldX + c] + out[e];
          X[r * g.ldX + c] = v;
          if (dense && r < rows && c < n) SF[r * n + c] = v;
        }
      }
    }
    if (dense) fence_proxy_async();
    cst_prev = cst_t;
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // step T - 1's v and invL in place
  for (int j = warp; j < JB; j += kMmaWarps) alpha_tile(j, (T - 1) & 1);
  __syncthreads();
  if (keeps_ll) {
    add_ll(cst_prev);
    a.ll[s0 + lane] = ll;
  }
  store(a.xf, T - 1, sm + g.oSF + ((T - 1) & 1) * g.sBuf, X);
  if (dense && tid == 0) bulk_wait_all();
}

// K9's forms 1 and 2 (its form 0 is kalman_wide_kernel above). Registers
// for one block an SM: at two (128 registers a thread) form 1 spilled, and
// its shared memory holds one or two blocks at the n it takes.
template <int kForm>
__global__ void __launch_bounds__(kThreads, 1)
    kalman_wide_ffma_kernel(const K9Args a, const Geo g) {
  constexpr bool kStage = kForm <= 1;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const ar = kStage ? sm : a.ws + static_cast<size_t>(blockIdx.x) * g.floats;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n = g.n, p = g.p, S = g.S, lgST = g.lgST, ST = S >> 2;
  const int JTn = g.nP >> 2, JTp = g.pP >> 2, N = a.N, T = a.T;
  const int s0 = blockIdx.x * S, rows = min(S, N - s0);
  const bool has_u = a.us != nullptr;
  float* const X = ar + g.oX;
  float* const Xp = ar + g.oXp;
  float* const V = ar + g.oV;
  float* const part = ar + g.oPart;

  // zero padding: only real entries are written from here on
  for (int e = tid; e < g.floats; e += nthr) ar[e] = 0.0f;
  __syncthreads();
  // the tile's x0 rows, copied with step 0's inputs
  if constexpr (kStage) {
    stage_rows(X, g.ldX, a.x0s + static_cast<size_t>(s0) * n, rows, n, tid, nthr);
  } else {
    for (Walk w(tid, nthr, n); w.r < rows; w.next())
      X[w.r * g.ldX + w.c] = __ldg(a.x0s + static_cast<size_t>(s0 + w.r) * n + w.c);
  }

  // step t's inputs into buffer t % 2
  auto stage = [&](int t) {
    if constexpr (kStage) {
      const int b = t & 1;
      async_copy::copy_run_by_block(sm + g.oY + b * g.yBuf,
                                    a.ys + (static_cast<size_t>(t) * N + s0) * p, rows * p, tid,
                                    nthr);
      if (has_u)
        async_copy::copy_run_by_block(sm + g.oU + b * g.uBuf,
                                      a.us + (static_cast<size_t>(t) * N + s0) * n, rows * n,
                                      tid, nthr);
      __pipeline_commit();
    }
  };
  // ll -= 0.5 |alpha|^2 + cst of the step whose partial sums `part` holds
  float ll = 0.0f;
  auto reduce_ll = [&](float cst) {
    if (tid < rows) {
      float sq = 0.0f;
      for (int jt = 0; jt < JTp; ++jt) sq = sq + part[jt * S + tid];
      ll = ll - 0.5f * sq - cst;
    }
  };

  stage(0);
  float cst_prev = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float cst_t = __ldg(a.cst + t);  // used a step later
    if constexpr (kStage) __pipeline_wait_prior(0);
    __syncthreads();  // step t's inputs landed; step t - 1 done
    if (t + 1 < T) stage(t + 1);  // into step t - 1's buffer
    const size_t run = static_cast<size_t>(t) * N + s0;  // the tile's first row at step t

    // phase A: step t - 1's ll and x_f out; x_p = x A' + u_t
    if (t > 0) {
      reduce_ll(cst_prev);
      store_rows(a.xf + (run - N) * n, X, g.ldX, rows, n, tid, nthr);
    }
    {
      const float* U = nullptr;
      if (has_u) {
        const float* const src = a.us + run * n;
        U = kStage ? sm + g.oU + (t & 1) * g.uBuf + async_copy::run_offset(src) : src;
      }
      for (int q = tid; q < (JTn << lgST); q += nthr) {
        const int st = q & (ST - 1), jt = q >> lgST;
        float acc[4][4];
        tile_product<false>(acc, X, g.ldX, st, ST, JTn, GlobalRows{a.A, n, n, n, jt, JTn});
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = st + ST * r, j = jt + JTn * c;
            float v = acc[r][c];
            if (U != nullptr && s < rows && j < n) v = v + U[s * n + j];
            Xp[s * g.ldX + j] = v;
          }
      }
    }
    __syncthreads();

    // phase B: x_p out; v = y_t - x_p C'
    store_rows(a.xp + run * n, Xp, g.ldX, rows, n, tid, nthr);
    {
      const float* const src = a.ys + run * p;
      const float* const Y = kStage ? sm + g.oY + (t & 1) * g.yBuf + async_copy::run_offset(src)
                                    : src;
      for (int q = tid; q < (JTp << lgST); q += nthr) {
        const int st = q & (ST - 1), jt = q >> lgST;
        float acc[4][4];
        tile_product<false>(acc, Xp, g.ldX, st, ST, JTn, GlobalRows{a.C, n, p, n, jt, JTp});
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = st + ST * r, j = jt + JTp * c;
            const float y = (s < rows && j < p) ? Y[s * p + j] : 0.0f;
            V[s * g.ldV + j] = y - acc[r][c];
          }
      }
    }
    __syncthreads();

    // phase C: x = x_p + v W_t; alpha = v invL_t' and its squares a tile,
    // the two products' tiles on distinct threads where the block has them
    {
      const int tiles_x = JTn << lgST, tiles = tiles_x + (JTp << lgST);
      const float* const Wt = a.W + static_cast<size_t>(t) * p * n;
      const float* const Lt = a.iL + static_cast<size_t>(t) * p * p;
      for (int q = tid; q < tiles; q += nthr) {
        float acc[4][4];
        if (q < tiles_x) {
          const int st = q & (ST - 1), jt = q >> lgST;
          tile_product<true>(acc, V, g.ldV, st, ST, JTp, GlobalDepth{Wt, n, p, n, jt});
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int e = (st + ST * r) * g.ldX + 4 * jt + c;
              X[e] = Xp[e] + acc[r][c];
            }
        } else {
          const int qq = q - tiles_x, st = qq & (ST - 1), jt = qq >> lgST;
          tile_product<false>(acc, V, g.ldV, st, ST, JTp, GlobalRows{Lt, p, p, p, jt, JTp});
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float sq = acc[r][0] * acc[r][0];
#pragma unroll
            for (int c = 1; c < 4; ++c) sq = fmaf(acc[r][c], acc[r][c], sq);
            part[jt * S + st + ST * r] = sq;
          }
        }
      }
    }
    cst_prev = cst_t;
  }
  __syncthreads();
  reduce_ll(cst_prev);
  if (tid < rows) a.ll[s0 + tid] = ll;
  store_rows(a.xf + (static_cast<size_t>(T - 1) * N + s0) * n, X, g.ldX, rows, n, tid, nthr);
}

struct K10Args {
  const float *G, *es, *x_last;
  float *xs, *ws;
  int N, T;
};

// K10 keeps room for two blocks an SM (128 registers a thread) in the
// shared-memory forms, one in the workspace form, whose guarded reads of
// device memory need more registers (it spilled at 128).
template <int kForm>
__global__ void __launch_bounds__(kThreads, kForm == 2 ? 1 : 2)
    rts_wide_kernel(const K10Args a, const Geo g) {
  constexpr bool kMats = kForm == 0, kStage = kForm <= 1;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const ar = kStage ? sm : a.ws + static_cast<size_t>(blockIdx.x) * g.floats;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n = g.n, S = g.S, lgST = g.lgST, ST = S >> 2, JTn = g.nP >> 2;
  const int N = a.N, T = a.T;
  const int s0 = blockIdx.x * S, rows = min(S, N - s0);
  float* const X0 = ar + g.oX;
  float* const X1 = X0 + S * g.ldX;

  for (int e = tid; e < g.floats; e += nthr) ar[e] = 0.0f;
  __syncthreads();
  if constexpr (kStage) {  // copied with step 0's inputs
    stage_rows(X0, g.ldX, a.x_last + static_cast<size_t>(s0) * n, rows, n, tid, nthr);
  } else {
    for (Walk w(tid, nthr, n); w.r < rows; w.next())
      X0[w.r * g.ldX + w.c] = __ldg(a.x_last + static_cast<size_t>(s0 + w.r) * n + w.c);
  }

  // step q (t = T - 2 - q)'s inputs into buffer q % 2
  auto stage = [&](int q) {
    if constexpr (kStage) {
      const int t = T - 2 - q, b = q & 1;
      if constexpr (kMats)
        stage_rows(sm + g.oG + b * g.gBuf, g.ldG, a.G + static_cast<size_t>(t) * n * n, n, n,
                   tid, nthr);
      async_copy::copy_run_by_block(sm + g.oE + b * g.eBuf,
                                    a.es + (static_cast<size_t>(t) * N + s0) * n, rows * n, tid,
                                    nthr);
      __pipeline_commit();
    }
  };

  stage(0);
  for (int q = 0; q + 1 < T; ++q) {
    const int t = T - 2 - q;
    if constexpr (kStage) __pipeline_wait_prior(0);
    __syncthreads();  // step q's inputs landed; step q - 1 done
    if (t > 0) stage(q + 1);  // into step q - 1's buffer
    const float* const Xc = (q & 1) ? X1 : X0;
    float* const Xn = (q & 1) ? X0 : X1;
    // x_s[t + 1] out (x_last at q = 0); x_s[t] = x_s[t + 1] G_t' + e_t
    store_rows(a.xs + (static_cast<size_t>(t + 1) * N + s0) * n, Xc, g.ldX, rows, n, tid, nthr);
    const float* const src = a.es + (static_cast<size_t>(t) * N + s0) * n;
    const float* const E = kStage ? sm + g.oE + (q & 1) * g.eBuf + async_copy::run_offset(src)
                                  : src;
    for (int tq = tid; tq < (JTn << lgST); tq += nthr) {
      const int st = tq & (ST - 1), jt = tq >> lgST;
      float acc[4][4];
      if constexpr (kMats)
        tile_product<true>(acc, Xc, g.ldX, st, ST, JTn,
                           SharedDepth{sm + g.oG + (q & 1) * g.gBuf, g.ldG, jt});
      else
        tile_product<true>(acc, Xc, g.ldX, st, ST, JTn,
                           GlobalDepth{a.G + static_cast<size_t>(t) * n * n, n, n, n, jt});
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = st + ST * r, k = 4 * jt + c;
          const float e = (s < rows && k < n) ? E[s * n + k] : 0.0f;
          Xn[s * g.ldX + k] = acc[r][c] + e;
        }
    }
  }
  __syncthreads();
  store_rows(a.xs + static_cast<size_t>(s0) * n, ((T - 1) & 1) ? X1 : X0, g.ldX, rows, n, tid,
             nthr);
}

inline cudaError_t optin_bytes(int* bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The form a kernel takes, its tile and its block's threads: K10 in form 0
// with the largest tile whose block fits the shared memory, else form 1
// likewise, else form 2 with the smallest tile; K9 in form 0 (one tile of
// kMmaTile) with two buffers of W_t and the dense buffers of its bulk
// stores where they fit, else with one buffer and none, else in forms 1 and
// 2 as K10.
struct Plan {
  int form, S;
  Geo g;
  int threads;
};

inline bool fits(const Geo& g, int optin) {
  return static_cast<size_t>(g.floats) * sizeof(float) <= static_cast<size_t>(optin);
}

template <class Layout>
inline Plan plan_of(int optin, int first_form, Layout layout) {
  for (int form = first_form; form <= 1; ++form)
    for (int S = kMaxTile; S >= kMinTile; S /= 2) {
      const Geo g = layout(S, form);
      if (fits(g, optin)) return Plan{form, S, g, kThreads};
    }
  return Plan{2, kMinTile, layout(kMinTile, 2), kThreads};
}

inline Plan plan_k9(int optin, int n, int p, bool has_u) {
  for (const int full : {1, 0}) {
    const Geo g = layout_k9_mma(n, p, has_u, full ? 2 : 1, full);
    if (fits(g, optin)) return Plan{0, kMmaTile, g, kMmaThreads};
  }
  return plan_of(optin, 1, [=](int S, int form) { return layout_k9(n, p, S, form, has_u); });
}
inline Plan plan_k10(int optin, int n) {
  return plan_of(optin, 0, [=](int S, int form) { return layout_k10(n, S, form); });
}


template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, const Plan& plan, const Args& a, int N, cudaStream_t stream) {
  const size_t smem = plan.form <= 1 ? sizeof(float) * static_cast<size_t>(plan.g.floats) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(N + plan.S - 1) / plan.S, plan.threads, smem, stream>>>(a, plan.g);
  return cudaGetLastError();
}

}  // namespace kalman_wide

// The wide K9: as npt_kalman_mean (kalman_mean.cu), for any n, p >= 1, with
// ws the device workspace of npt_kalman_mean_wide_workspace floats (null
// where that is 0). Returns the CUDA error code of the launch.
extern "C" int npt_kalman_mean_wide(const float* A, const float* C, const float* W,
                                    const float* iL, const float* cst, const float* x0s,
                                    const float* ys, const float* us, float* xf, float* xp,
                                    float* ll, float* ws, int N, int T, int n, int p,
                                    void* stream) {
  using namespace kalman_wide;
  if (N < 1 || T < 1 || n < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  const cudaError_t err = optin_bytes(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan plan = plan_k9(optin, n, p, us != nullptr);
  if (plan.form == 2 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const K9Args a{A, C, W, iL, cst, x0s, ys, us, xf, xp, ll, ws, N, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan.form) {
    case 0: return static_cast<int>(launch(kalman_wide_kernel, plan, a, N, st));
    case 1: return static_cast<int>(launch(kalman_wide_ffma_kernel<1>, plan, a, N, st));
    default: return static_cast<int>(launch(kalman_wide_ffma_kernel<2>, plan, a, N, st));
  }
}

// The wide K10: as npt_rts_mean (rts_mean.cu), for any n >= 1, T >= 2, with
// ws as above (npt_rts_mean_wide_workspace floats).
extern "C" int npt_rts_mean_wide(const float* G, const float* es, const float* x_last, float* xs,
                                 float* ws, int N, int T, int n, void* stream) {
  using namespace kalman_wide;
  if (N < 1 || T < 2 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  const cudaError_t err = optin_bytes(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan plan = plan_k10(optin, n);
  if (plan.form == 2 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const K10Args a{G, es, x_last, xs, ws, N, T};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan.form) {
    case 0: return static_cast<int>(launch(rts_wide_kernel<0>, plan, a, N, st));
    case 1: return static_cast<int>(launch(rts_wide_kernel<1>, plan, a, N, st));
    default: return static_cast<int>(launch(rts_wide_kernel<2>, plan, a, N, st));
  }
}

// The plan of the wide K9 at (n, p) (with inputs or not) and of the wide K10
// at n on the current device: 100 form + tile (form 0: matrices and tile in
// shared memory, K9's products on the tensor cores; 1: the matrices read
// through L1; 2: the tile in the workspace); -1 on a CUDA error.
extern "C" int npt_kalman_mean_wide_plan(int n, int p, int has_u) {
  using namespace kalman_wide;
  int optin = 0;
  if (n < 1 || p < 1 || optin_bytes(&optin) != cudaSuccess) return -1;
  const Plan plan = plan_k9(optin, n, p, has_u != 0);
  return 100 * plan.form + plan.S;
}

extern "C" int npt_rts_mean_wide_plan(int n) {
  using namespace kalman_wide;
  int optin = 0;
  if (n < 1 || optin_bytes(&optin) != cudaSuccess) return -1;
  const Plan plan = plan_k10(optin, n);
  return 100 * plan.form + plan.S;
}

// The floats of device workspace the wide K9 (K10) needs for N
// trajectories: 0 where its tile fits in shared memory; -1 on a CUDA error.
extern "C" long long npt_kalman_mean_wide_workspace(int N, int n, int p, int has_u) {
  using namespace kalman_wide;
  int optin = 0;
  if (N < 1 || n < 1 || p < 1 || optin_bytes(&optin) != cudaSuccess) return -1;
  const Plan plan = plan_k9(optin, n, p, has_u != 0);
  if (plan.form != 2) return 0;
  return static_cast<long long>((N + plan.S - 1) / plan.S) * plan.g.floats;
}

extern "C" long long npt_rts_mean_wide_workspace(int N, int n) {
  using namespace kalman_wide;
  int optin = 0;
  if (N < 1 || n < 1 || optin_bytes(&optin) != cudaSuccess) return -1;
  const Plan plan = plan_k10(optin, n);
  if (plan.form != 2) return 0;
  return static_cast<long long>((N + plan.S - 1) / plan.S) * plan.g.floats;
}
