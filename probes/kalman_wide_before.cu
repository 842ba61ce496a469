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
// formation (n = 48, p = 24, N = 4096, T = 50) K9 does N T (2n^2 + 4np +
// 2p^2 + n + 4p) = 2.15 GFLOP, 32.1 us at the H100's 67 TFLOP/s of fp32,
// against 99.1 MB of data and outputs (29.6 us at 3.35 TB/s; 138.4 MB and
// 41.3 us with inputs): operations without inputs, bytes with them. K10 moves
// 78.6 MB (23.5 us) for 0.92 GFLOP (13.8 us): bytes. One lane a trajectory
// holding x in registers (the narrow forms) spills past n = 16 and runs
// every product as n^2 dependent FMAs on one lane. So here:
//   - a block of 256 threads takes a tile of S trajectories (32, halved
//     while the block's shared memory does not fit, to 4), and each product
//     of a step is a tile product over its threads: a thread computes 4
//     trajectories x 4 output components in registers, over the depth in
//     quads of 4, from 16-byte shared loads of the tile's rows and of the
//     matrix (8 loads a 64 FMAs), with rolled loops over runtime n and p:
//     no bucket, no unrolled 48-wide instance (the lesson of the wide K5
//     and K7: those spilled and took minutes to compile);
//   - the tile's x, x_p and v live in shared memory, zero padded to
//     multiples of 4, each row stride an odd count of 16-byte pieces so that
//     the eight rows a quarter warp reads meet no bank conflict (a thread's
//     4 rows are s = st + (S / 4) a, a < 4); A and C (K9) and x0 are copied
//     once, W_t and invL_t (K9) or G_t' (K10) and the tile's rows of y_t and
//     u_t (e_t) one step ahead by cp.async into two buffers, while the step
//     before computes;
//   - the step's three dependent phases (x_p; v; x and alpha, the last two
//     products on distinct threads) are split by block barriers, and a
//     phase stores the state the phase before made (x_p, x_f) as one
//     contiguous run of S rows, a warp a row;
//   - each trajectory's ll is reduced over the alpha tiles' partial sums in
//     a fixed order by one thread, so a run is reproducible bit for bit;
//   - where the matrices do not fit beside the tile (K9 past about
//     (120, 60), K10 past n = 160) they are read through L1 (__ldg) instead
//     (form 1), and where even a tile of 4 trajectories does not fit (n + p
//     past about 3,500) the tile lives in a device workspace the wrapper
//     allocates (form 2). No (n, p) is refused for its size.
// Every sum over the depth runs in ascending order, as one dot product (in
// blocks of 128 past that depth, each block's sum added in order).
//
// Measured (H100 80GB HBM3, 700 W; probes/estimation_wide.py at the
// formation): K9 303 us own (330 with inputs), 10.6% of its operations
// bound; K10 116 us, 20.3% of its bytes bound. Taken out one at a time from
// K9's 303 us: the tile products 140 us, the stores of x_f and x_p 65 us,
// the staged copies 3 us; the rest (epilogues, barriers, ll), ~100 us, is
// latency: one block of 8 warps an SM at N = 4096. Measured away: a tile
// summed by 2-4 threads and joined by shuffles (412 us: the shuffles share
// the shared-memory pipe the products already fill), 96 or 128 threads a
// block (425, 403 us), tiles of 16 or 8 trajectories (326, 568 us); 512
// threads gave 286 us, not taken (it halves the registers a thread may
// hold, which the larger forms use).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace kalman_wide {

constexpr int kMaxTile = 32;  // trajectories a block (S), at most
constexpr int kMinTile = 4;   // a thread's 4 rows
constexpr int kThreads = 256;  // a block's

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// A row stride of at least x floats (x a multiple of 4) with an odd count of
// 16-byte pieces: consecutive rows start in distinct 16-byte bank groups.
__host__ __device__ inline int odd_stride(int x) { return ((x >> 2) & 1) ? x : x + 4; }

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
};

// K9's layout in form `form` (0: matrices and tile in shared memory, the
// inputs staged; 1: the matrices read through L1; 2: the tile in the
// workspace, nothing staged) for tiles of S trajectories.
inline Geo layout_k9(int n, int p, int S, int form, bool has_u) {
  Geo g{};
  g.n = n, g.p = p, g.nP = round4(n), g.pP = round4(p), g.S = S, g.lgST = log2_of(S / 4);
  g.ldX = odd_stride(g.nP), g.ldV = odd_stride(g.pP);
  g.ldA = odd_stride(g.nP), g.ldC = odd_stride(g.nP), g.ldL = odd_stride(g.pP);
  int o = 0;
  if (form == 0) {
    g.oA = o, o += g.nP * g.ldA;
    g.oC = o, o += g.pP * g.ldC;
    g.wBuf = g.pP * g.nP, g.oW = o, o += 2 * g.wBuf;  // W_t depth-major: (p, n), stride nP
    g.lBuf = g.pP * g.ldL, g.oL = o, o += 2 * g.lBuf;
  }
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
struct SharedRows {
  const float* base;
  int ld, jt, JT;
  __device__ void operator()(int kq, float4 (&m)[4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      m[c] = *reinterpret_cast<const float4*>(base + (jt + JT * c) * ld + 4 * kq);
  }
};
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

// The kernels keep room for two blocks an SM (128 registers a thread) in the
// shared-memory forms, one in the workspace form, whose guarded reads of
// device memory need more registers (K10's spilled at 128).
template <int kForm>
__global__ void __launch_bounds__(kThreads, kForm == 2 ? 1 : 2)
    kalman_wide_kernel(const K9Args a, const Geo g) {
  constexpr bool kMats = kForm == 0, kStage = kForm <= 1;
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
  // A and C (form 0) and the tile's x0 rows, copied with step 0's inputs
  if constexpr (kMats) {
    stage_rows(sm + g.oA, g.ldA, a.A, n, n, tid, nthr);
    stage_rows(sm + g.oC, g.ldC, a.C, p, n, tid, nthr);
  }
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
      if constexpr (kMats) {
        stage_rows(sm + g.oW + b * g.wBuf, g.nP, a.W + static_cast<size_t>(t) * p * n, p, n, tid,
                   nthr);
        stage_rows(sm + g.oL + b * g.lBuf, g.ldL, a.iL + static_cast<size_t>(t) * p * p, p, p,
                   tid, nthr);
      }
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
        if constexpr (kMats)
          tile_product<false>(acc, X, g.ldX, st, ST, JTn, SharedRows{sm + g.oA, g.ldA, jt, JTn});
        else
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
        if constexpr (kMats)
          tile_product<false>(acc, Xp, g.ldX, st, ST, JTn, SharedRows{sm + g.oC, g.ldC, jt, JTp});
        else
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
          if constexpr (kMats)
            tile_product<true>(acc, V, g.ldV, st, ST, JTp,
                               SharedDepth{sm + g.oW + (t & 1) * g.wBuf, g.nP, jt});
          else
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
          if constexpr (kMats)
            tile_product<false>(acc, V, g.ldV, st, ST, JTp,
                                SharedRows{sm + g.oL + (t & 1) * g.lBuf, g.ldL, jt, JTp});
          else
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

// The form a kernel takes and its tile: form 0 with the largest tile whose
// block fits the shared memory, else form 1 likewise, else form 2 with the
// smallest tile.
struct Plan {
  int form, S;
  Geo g;
};

template <class Layout>
inline Plan plan_of(int optin, Layout layout) {
  for (int form = 0; form <= 1; ++form)
    for (int S = kMaxTile; S >= kMinTile; S /= 2) {
      const Geo g = layout(S, form);
      if (static_cast<size_t>(g.floats) * sizeof(float) <= static_cast<size_t>(optin))
        return Plan{form, S, g};
    }
  return Plan{2, kMinTile, layout(kMinTile, 2)};
}

inline Plan plan_k9(int optin, int n, int p, bool has_u) {
  return plan_of(optin, [=](int S, int form) { return layout_k9(n, p, S, form, has_u); });
}
inline Plan plan_k10(int optin, int n) {
  return plan_of(optin, [=](int S, int form) { return layout_k10(n, S, form); });
}


template <class Kernel, class Args>
cudaError_t launch(Kernel kernel, const Plan& plan, const Args& a, int N, cudaStream_t stream) {
  const size_t smem = plan.form <= 1 ? sizeof(float) * static_cast<size_t>(plan.g.floats) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(N + plan.S - 1) / plan.S, kThreads, smem, stream>>>(a, plan.g);
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
    case 0: return static_cast<int>(launch(kalman_wide_kernel<0>, plan, a, N, st));
    case 1: return static_cast<int>(launch(kalman_wide_kernel<1>, plan, a, N, st));
    default: return static_cast<int>(launch(kalman_wide_kernel<2>, plan, a, N, st));
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
// shared memory; 1: the matrices read through L1; 2: the tile in the
// workspace); -1 on a CUDA error.
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
