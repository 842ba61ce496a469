// Shared pieces of the box-QP kernels (boxqp_fista.cu, boxqp_admm.cu): the
// fused ones that form g (or c) from x0 and the two-step ones that read g.
//
// Layout. One block solves a tile of kTileS = 32 scenarios; 4096 scenarios make
// 128 blocks for the H100's 132 SMs. The block has 256 threads. Thread
// (rg, cg) = (warp, lane) owns a 4 x 4 micro-tile of the (32, d) iterate:
// scenarios 4rg..4rg+3 and columns 4cg..4cg+3. Its share of every carry (U, Y,
// g for FISTA; s, p, c for ADMM) stays in its registers for the whole solve, so
// the elementwise update needs no shared memory. Only the left operand of the
// iteration product is shared: each thread writes its micro-tile of it,
// transposed, into `opT` (d rows of 32 scenarios), and every thread reads it
// back for its product. The four-float slot of a row that holds a row group
// is swizzled (op_slot), so that the 32 lanes of a warp, which write four
// neighbouring rows each, spread over all 32 banks.
//
// Product. out[s][j] = sum_k opT[k][s] * mat[k][j], with mat (d x d) resident
// in shared memory for the whole solve. Per k a thread loads one float4 of
// opT (the same address across the warp: a broadcast) and one float4 of mat
// (512 contiguous bytes across the warp), then issues 16 FMAs. Sums run over
// k in order and in fp32.
//
// Precision classes (numpower_tpu/kernels/precision.py). kHighest is the
// fp32 product above. The split classes form x = hi + lo with hi = bf16_rn(x)
// and lo = x - hi (exact in fp32) for both operands and sum hi*hi + hi*lo +
// lo*hi (kBf16x3), plus lo*lo (kBf16x4), each term an fp32 FMA: the function
// the TPU's multi-pass bf16 schemes compute. hi(mat) is matb, staged already;
// lo(mat) is one subtraction per load, so no shared memory is added. The
// left operand is split as it is loaded.
//
// Envelope. A warp spans 32 x 4 = 128 columns, so d <= kMaxD = 128. Shared
// memory holds mat twice (fp32, and rounded to bf16 for the coarse phase),
// opT, the (n, d) fold of the prediction chain and the tile's x0: at
// d = 128, n = 32 that is 164 KiB of the 227 KiB a block may have, so the
// kernel needs the dynamic shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace boxqp {

constexpr int kTileS = 32;    // scenarios per block
constexpr int kMaxD = 128;    // decision variables (columns) per scenario
constexpr int kMaxN = 32;     // state dimension of the in-kernel g / c formation
constexpr int kThreads = 256;  // 8 warps: warp = row group, lane = column group
constexpr int kStride = kMaxD;  // row stride of mat and w in shared memory

// Floats of dynamic shared memory for a given (d, n).
__host__ __device__ inline size_t smem_floats(int d, int n) {
  return 2 * static_cast<size_t>(d) * kStride     // mat, matb
         + static_cast<size_t>(d) * kTileS         // opT
         + static_cast<size_t>(n) * kStride        // w
         + static_cast<size_t>(n) * kTileS;        // x0T
}

struct Smem {
  float* mat;   // (d, kStride) fp32, columns >= d zero
  float* matb;  // the same rounded to bf16 (held as fp32)
  float* opT;   // (d, kTileS) left operand of the product, transposed
  float* w;     // (n, kStride) fold of the prediction chain, columns >= d zero
  float* x0T;   // (n, kTileS) the tile's initial states, transposed
};

__device__ inline Smem carve(float* base, int d, int n) {
  Smem s;
  s.mat = base;
  s.matb = s.mat + d * kStride;
  s.opT = s.matb + d * kStride;
  s.w = s.opT + d * kTileS;
  s.x0T = s.w + n * kStride;
  return s;
}

// Round-to-nearest-even to bf16 and back: what a single-pass bf16 matrix
// unit does to each operand before it multiplies and accumulates in fp32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// float4 index in opT (or x0T) of row k, row group rg.
__device__ __forceinline__ int op_slot(int k, int rg) {
  return k * (kTileS / 4) + (rg ^ ((k >> 2) & 7));
}

// Stage the block's inputs: mat and its bf16 copy from the row-major (d, d)
// `m`, the fold from the row-major (n, d) `fold`, and the tile's rows of the
// row-major (N, n) `x0` (rows >= N read as zero).
__device__ inline void stage_inputs(const Smem& sm, const float* __restrict__ m,
                                    const float* __restrict__ fold,
                                    const float* __restrict__ x0, int row0,
                                    int N, int n, int d) {
  for (int i = threadIdx.x; i < d * kStride; i += kThreads) {
    const int k = i / kStride, j = i % kStride;
    const float v = j < d ? m[k * d + j] : 0.0f;
    sm.mat[i] = v;
    sm.matb[i] = bf16_round(v);
  }
  for (int i = threadIdx.x; i < n * kStride; i += kThreads) {
    const int k = i / kStride, j = i % kStride;
    sm.w[i] = j < d ? fold[k * d + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < n * kTileS; i += kThreads) {
    const int k = i / kTileS, s = i % kTileS;
    const int row = row0 + s;
    sm.x0T[4 * op_slot(k, s / 4) + s % 4] =
        row < N ? x0[static_cast<size_t>(row) * n + k] : 0.0f;
  }
}

// The thread's micro-tile of the row-major (N, d) `src`: entries outside
// (N, d), and every entry when `src` is null, read as zero.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int row0, int N,
                                          int d, int rg, int cg, float v[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * rg + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * cg + c;
      v[r][c] = (src != nullptr && row < N && col < d)
                    ? src[static_cast<size_t>(row) * d + col] : 0.0f;
    }
  }
}

// Write the thread's micro-tile into the row-major (N, d) `dst`, real entries only.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float v[4][4],
                                           int row0, int N, int d, int rg, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * rg + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * cg + c;
      if (row < N && col < d) dst[static_cast<size_t>(row) * d + col] = v[r][c];
    }
  }
}

enum Precision : int { kHighest = 0, kBf16x3 = 3, kBf16x4 = 4 };

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
}

// acc[r][c] = sum_{k < depth} op[4rg + r][k] * mat[k][4cg + c] in the
// precision class kPrec, with op held transposed and swizzled in opT.
// mat_hi is hi(mat) in the same layout (matb); with kRoundHi it is unused
// and hi(mat) is rounded as it is loaded (the (n, d) fold, which has no
// bf16 copy).
template <int kPrec = kHighest, bool kRoundHi = false>
__device__ __forceinline__ void tile_product(const float* __restrict__ opT,
                                             const float* __restrict__ mat,
                                             const float* __restrict__ mat_hi,
                                             int depth, int rg, int cg,
                                             float acc[4][4]) {
  static_assert(kPrec == kHighest || kPrec == kBf16x3 || kPrec == kBf16x4,
                "unknown precision class");
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  const float4* a4 = reinterpret_cast<const float4*>(opT);
  const float4* b4 = reinterpret_cast<const float4*>(mat) + cg;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float4 a = a4[op_slot(k, rg)];
    const float4 b = b4[k * (kStride / 4)];
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
    if constexpr (kPrec == kHighest) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    } else {
      const float4 bh4 = kRoundHi ? bf16_round4(b)
                                  : reinterpret_cast<const float4*>(mat_hi)[k * (kStride / 4) + cg];
      const float bh[4] = {bh4.x, bh4.y, bh4.z, bh4.w};
      float ah[4], al[4], bl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = bf16_round(av[i]);
        al[i] = av[i] - ah[i];
        bl[i] = bv[i] - bh[i];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = fmaf(ah[r], bh[c], acc[r][c]);
          v = fmaf(ah[r], bl[c], v);
          v = fmaf(al[r], bh[c], v);
          if constexpr (kPrec == kBf16x4) v = fmaf(al[r], bl[c], v);
          acc[r][c] = v;
        }
    }
  }
}

// The product of one iteration: in the coarse phase single-pass bf16 (opT
// holds the operand rounded, matb the matrix), in the tail class kTailPrec.
template <int kTailPrec>
__device__ __forceinline__ void iteration_product(const Smem& sm, bool coarse, int d, int rg,
                                                  int cg, float acc[4][4]) {
  if constexpr (kTailPrec == kHighest) {
    tile_product(sm.opT, coarse ? sm.matb : sm.mat, nullptr, d, rg, cg, acc);
  } else if (coarse) {
    tile_product(sm.opT, sm.matb, nullptr, d, rg, cg, acc);
  } else {
    tile_product<kTailPrec>(sm.opT, sm.mat, sm.matb, d, rg, cg, acc);
  }
}

// Write the thread's micro-tile of the next left operand into opT, rounded to
// bf16 when the next product is a coarse one. Columns >= d have no row in opT.
__device__ __forceinline__ void store_operand(float* __restrict__ opT,
                                              const float v[4][4], bool round,
                                              int rg, int cg, int d) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = 4 * cg + c;
    if (j < d) {
      float4 out;
      out.x = round ? bf16_round(v[0][c]) : v[0][c];
      out.y = round ? bf16_round(v[1][c]) : v[1][c];
      out.z = round ? bf16_round(v[2][c]) : v[2][c];
      out.w = round ? bf16_round(v[3][c]) : v[3][c];
      reinterpret_cast<float4*>(opT)[op_slot(j, rg)] = out;
    }
  }
}

// Max of a non-negative float (or NaN, which wins) over the block, folded
// into *out with atomicMax on the int bits: for non-negative IEEE floats the
// int order is the float order, and max is order-free, so the result is
// deterministic. *out must be zeroed before the launch. `scratch` holds one
// int per warp; the call ends with the block synchronised.
__device__ inline void block_max_into(float v, float* out, int* scratch) {
  int b = __float_as_int(v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) b = max(b, __shfl_xor_sync(0xffffffffu, b, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = scratch[0];
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, scratch[w]);
    atomicMax(reinterpret_cast<int*>(out), m);
  }
  __syncthreads();
}

// max for the residual reduction that keeps a NaN (|NaN| has the sign bit
// clear, so its int bits exceed every finite value's).
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
}

}  // namespace boxqp
