// The box-QP tile as it was before the wide tile's redesign (the parent's
// numpower_tpu_torch/csrc/boxqp_tile.cuh, unchanged below): its wide
// product skipped a warpgroup whose rows were all past d, which made ptxas
// serialize every wgmma of the wide kernels, and loaded slab s + 1 before
// issuing slab s's passes. Built by probes/boxqp_wide_turns.py.
//
// Shared pieces of the box-QP kernels (boxqp_fista.cu, boxqp_admm.cu): the
// fused ones that form g (or c) from x0 and the two-step ones that read g.
//
// Layout. One block solves a tile of kTileS = 32 scenarios; 4096 scenarios make
// 128 blocks for the H100's 132 SMs. The block has 256 threads, two
// warpgroups. Each iteration's (32, d) x (d, d) product runs transposed on the
// tensor cores: out' (d x 32) = A op', with A = mat' (out = op @ mat). M = d
// padded to 128, warpgroup w taking rows 64w..64w+63; N = the 32 scenarios;
// K = d padded to 128, eight k-steps of wgmma.mma_async.m64n32k16.f32.bf16.bf16.
// A is staged once per block, transposed as it is loaded (no symmetry of mat
// is assumed); rows and columns past d are zero.
//
// Fragment. Thread (w, q, l) = (warpgroup, warp in it, lane) holds entry r
// (0..15) of the m64n32 accumulator at row j = 64w + 16q + l/4 + 8((r >> 1) & 1)
// and scenario s = 2(l % 4) + 8(r >> 2) + (r & 1) (Frag). Every carry (U, Y, g
// for FISTA; s, p, c for ADMM) lives in this layout for the whole solve, so
// the elementwise update needs no shuffle, and entries r and r + 1 are the
// neighbours (j, s), (j, s + 1) of the next right operand: one 32-bit store.
//
// Shared memory, no swizzle (core matrices of 8 rows x 16 bytes):
//   A, K-major: (j, k) at (j / 8) 2048 + (k / 8) 128 + (j % 8) 16 + (k % 8) 2
//     bytes; the descriptor's LBO (next core matrix along K) 128, SBO (next
//     along M) 2048; three splits hi, mid, lo of 32 KB;
//   B, MN-major (transposed): (k, s) at (k / 8) 512 + (s / 8) 128 + (k % 8) 16
//     + (s % 8) 2 bytes; LBO (along K) 512, SBO (along N) 128; three splits of
//     8 KB, twice: the operand of iteration k + 1 is stored while the other
//     warpgroup may still read that of iteration k, so one barrier a step
//     suffices.
//
// Precision classes, as bf16 passes of one instruction (numpower_tpu/kernels/
// precision.py). x = hi + mid + lo, each part bf16, is exact for fp32
// normals. The coarse phase is 1 pass, hi*hi: both operands rounded to bf16,
// summed in fp32, the TPU's single-pass DEFAULT product. "bf16x3" is 3
// passes, hi*hi + hi*mid + mid*hi (mid is the bf16 lo of the two-way split);
// "bf16x4" adds mid*mid; "highest" is 6: hi*hi, hi*mid, mid*hi, hi*lo, lo*hi,
// mid*mid, the multi-pass fp32 of the JAX package's precision note, as
// accurate as the fp32 product. hi*hi goes to one accumulator and the
// corrections to a second, added in fp32 on the CUDA cores after the wait:
// the tensor cores' fp32 sum is not round-to-nearest, and the corrections
// (2^-8 to 2^-16 relative) would be cut against the large term.
//
// Envelope. Any state dimension n >= 1; d <= kMaxD = 128 on the narrow tile
// (M and K of the padded product), 128 < d <= kMaxWideD = 1024 on the wide
// one below, the JAX package's VMEM bound. The narrow tile's shared memory
// holds A (96 KB), the two B buffers (48 KB) and one chunk of the (n, d)
// fold of the prediction chain with the tile's x0: 164 KiB of the 227 KiB a
// block may have, so the kernels need the dynamic shared-memory opt-in. Past
// d = 128 that layout does not fit (at d = 400 A's splits alone take
// 1.5 MB).
//
// The fold in chunks. g = x0 @ W (ADMM's c = x0 @ Wc) sums over the n rows
// of the fold. The kernels stage kFoldRows = 32 rows of it (and the same 32
// columns of the tile's x0) at a time into one region and add each chunk's
// terms in k order before the next chunk is staged, so shared memory is
// sized by min(n, 32) and the sum is the one over all n in order: at
// n <= 32 there is one chunk, staged with the matrix.
//
// Wide tile. A cluster of b = ceil(d / 128) CTAs (b <= 8, the portable
// cluster size) solves one 32-scenario tile. CTA r owns rows 128r..128r+127
// of every product and of every carry: the fragment, the carries in
// registers, the elementwise update, store_operand and block_max_into stay
// per CTA as above, on local rows (global row = 128r + local). Each
// iteration:
//   - each CTA publishes its slice of the next operand (its 128 k-rows of B,
//     the narrow B layout) in one of two buffers, then the cluster barrier
//     (release/acquire): the buffer of iteration k + 1 is written while peers
//     may still read that of iteration k, so one barrier an iteration
//     suffices, the narrow tile's two-buffer argument lifted to the cluster;
//   - the product walks K in 64-wide slabs through a two-stage ring: the
//     CTA's 128 x 64 panel of A for the slab, in the parts the class reads,
//     comes by 16-byte cp.async from device memory (L2-resident: 6 MB of
//     splits at d = 1024), where the wrapper put it once, split and laid
//     out as the slab's core matrices (kernels/boxqp_fista._wide_operand);
//     the slab's 64 k-rows of B come from the owning CTA's published buffer
//     through distributed shared memory (ld.shared::cluster). Slab s + 1 is
//     loaded while the tensor cores run slab s; one block barrier a slab.
// Shared memory: the A ring 2 x 3 x 16 KB, the B ring 2 x 3 x 4 KB, the
// published slice 2 x 3 x 8 KB, a chunk of the fold's 128 columns and x0:
// 188 KiB at any n >= 32. The launch (launch_wide) asks
// cudaOccupancyMaxActiveClusters first and refuses a cluster that cannot be
// scheduled; a CTA leaves only after a last cluster barrier, so no peer
// reads its shared memory after it exits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace boxqp {

constexpr int kTileS = 32;     // scenarios per block: the product's N
constexpr int kMaxD = 128;     // decision variables per scenario: the product's M and K
constexpr int kFoldRows = 32;  // rows of the fold (and columns of x0) staged at once
constexpr int kThreads = 256;  // two warpgroups of 64 product rows each
constexpr int kSplits = 3;     // hi, mid, lo
constexpr int kAElems = kMaxD * kMaxD;  // bf16 elements of one split of A
constexpr int kBElems = kMaxD * kTileS;  // bf16 elements of one split of B
// The wide tile: rows a CTA owns, CTAs a cluster may have, the bound on d,
// and the ring's slab of K with its elements per split of A and of B.
constexpr int kTileD = 128;
constexpr int kMaxCtas = 8;
constexpr int kMaxWideD = kTileD * kMaxCtas;
constexpr int kSlabK = 64;
constexpr int kASlabElems = kTileD * kSlabK;
constexpr int kBSlabElems = kSlabK * kTileS;
static_assert(kTileD == kMaxD, "the wide tile reuses the narrow fragment and B layout");

enum Precision : int { kHighest = 0, kBf16x3 = 3, kBf16x4 = 4 };

// bf16 passes of a product in class `prec`, and the parts of each operand
// they read; kCoarse is the coarse phase's single pass.
constexpr int kCoarse = 1;
__host__ __device__ constexpr int passes(int prec) { return prec == kHighest ? 6 : prec; }
__host__ __device__ constexpr int parts(int npasses) {
  return npasses == 1 ? 1 : (npasses == 6 ? 3 : 2);
}

// Rows of the fold a chunk holds for a fold of n rows: the shared region's.
__host__ __device__ constexpr int fold_rows(int n) { return n < kFoldRows ? n : kFoldRows; }

// Bytes of dynamic shared memory for a fold of n rows.
__host__ __device__ inline size_t smem_bytes(int n) {
  const size_t rows = static_cast<size_t>(fold_rows(n));
  return sizeof(__nv_bfloat16) * (kSplits * static_cast<size_t>(kAElems) + 2 * kSplits * kBElems) +
         sizeof(float) * (rows * kMaxD + rows * kTileS);
}

struct Smem {
  __nv_bfloat16* a;  // kSplits x A, K-major core matrices
  __nv_bfloat16* b;  // 2 buffers x kSplits x B, MN-major core matrices
  float* w;          // (fold_rows(n), kMaxD) a chunk of the fold, columns >= d zero
  float* x0T;        // (fold_rows(n), kTileS) the chunk's columns of the tile's x0, transposed
};

__device__ inline Smem carve(unsigned char* base, int n) {
  Smem s;
  s.a = reinterpret_cast<__nv_bfloat16*>(base);
  s.b = s.a + kSplits * kAElems;
  s.w = reinterpret_cast<float*>(s.b + 2 * kSplits * kBElems);
  s.x0T = s.w + fold_rows(n) * kMaxD;
  return s;
}

// Element index of A's (j, k) and of B's (k, s) in the layouts above.
__device__ __forceinline__ int a_index(int j, int k) {
  return (j >> 3) * 1024 + (k >> 3) * 64 + (j & 7) * 8 + (k & 7);
}
__device__ __forceinline__ int b_index(int k, int s) {
  return (k >> 3) * 256 + (s >> 3) * 64 + (k & 7) * 8 + (s & 7);
}

// Where this thread's accumulator entries sit (see Fragment above).
struct Frag {
  int wg;  // warpgroup
  int j0;  // row of entry 0; entries with (r >> 1) & 1 sit 8 rows below
  int s0;  // scenario of entry 0
};

__device__ inline Frag frag() {
  const int t = threadIdx.x, lane = t % 32;
  return {t / 128, 64 * (t / 128) + 16 * ((t % 128) / 32) + lane / 4, 2 * (lane % 4)};
}
__device__ __forceinline__ int frag_j(const Frag& f, int r) { return f.j0 + 8 * ((r >> 1) & 1); }
__device__ __forceinline__ int frag_s(const Frag& f, int r) { return f.s0 + 8 * (r >> 2) + (r & 1); }

// Round-to-nearest-even to bf16 and back: what a single-pass bf16 matrix
// unit does to each operand before it multiplies and accumulates in fp32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The exact split x = hi + mid + lo of two neighbours x0, x1, each part bf16
// (round to nearest even), as bf16 pairs packed in 32 bits (x0 the low half,
// the lower address); kParts of them (1: hi; 2: hi, mid; 3: all).
template <int kParts>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&part)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  part[0] = reinterpret_cast<const uint32_t&>(hi);
  if constexpr (kParts >= 2) {
    const float r0 = x0 - __low2float(hi), r1 = x1 - __high2float(hi);
    const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
    part[1] = reinterpret_cast<const uint32_t&>(mid);
    if constexpr (kParts == 3) {
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(r0 - __low2float(mid), r1 - __high2float(mid));
      part[2] = reinterpret_cast<const uint32_t&>(lo);
    }
  }
}

// Stage chunk k0 / kFoldRows of the fold: rows k0.. of the row-major (n, d)
// `fold`, the block's columns j0..j0 + 127 (columns >= d as zero), and the
// same columns k0.. of the tile's rows of the row-major (N, n) `x0` (rows >= N
// as zero), transposed. No barrier.
__device__ __forceinline__ void stage_fold_chunk(const Smem& sm, const float* __restrict__ fold,
                                                 const float* __restrict__ x0, int row0, int N,
                                                 int n, int d, int j0, int k0) {
  const int rows = fold_rows(n - k0);
  for (int i = threadIdx.x; i < rows * kMaxD; i += kThreads) {
    const int k = k0 + i / kMaxD, j = j0 + i % kMaxD;
    sm.w[i] = j < d ? fold[k * d + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < rows * kTileS; i += kThreads) {
    const int k = k0 + i / kTileS, row = row0 + i % kTileS;
    sm.x0T[i] = row < N ? x0[static_cast<size_t>(row) * n + k] : 0.0f;
  }
}

// Stage the block's inputs: A = m' in its three splits from the row-major
// (d, d) `m`, and the fold's first chunk (stage_fold_chunk). Ends with the
// writes visible to the tensor cores' (async) proxy and the block synchronised.
__device__ inline void stage_inputs(const Smem& sm, const float* __restrict__ m,
                                    const float* __restrict__ fold,
                                    const float* __restrict__ x0, int row0, int N, int n,
                                    int d) {
  // A(j, k) = m(k, j). Item (j, kb) reads rows 8kb..8kb+7 of column j (each
  // read coalesced across the warp's 32 columns) and writes its 8 k's, one
  // 16-byte row of a core matrix, per split.
  for (int i = threadIdx.x; i < kAElems / 8; i += kThreads) {
    const int j = i % kMaxD, k0 = 8 * (i / kMaxD);
    uint32_t part[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 2 * q;
      split_pair<3>(j < d && k < d ? m[k * d + j] : 0.0f,
                    j < d && k + 1 < d ? m[(k + 1) * d + j] : 0.0f, part[q]);
    }
#pragma unroll
    for (int p = 0; p < kSplits; ++p) {
      *reinterpret_cast<uint4*>(sm.a + p * kAElems + a_index(j, k0)) =
          make_uint4(part[0][p], part[1][p], part[2][p], part[3][p]);
    }
  }
  stage_fold_chunk(sm, fold, x0, row0, N, n, d, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The thread's entries of the row-major (N, d) `src`, its rows j_off + j
// (j_off: the first row a wide CTA owns): entries outside (N, d), and every
// entry when `src` is null, read as zero.
__device__ __forceinline__ void load_frag(const float* __restrict__ src, int row0, int N, int d,
                                          const Frag& f, float (&v)[16], int j_off = 0) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + frag_s(f, r), j = j_off + frag_j(f, r);
    v[r] = (src != nullptr && row < N && j < d) ? src[static_cast<size_t>(row) * d + j] : 0.0f;
  }
}

// Write the thread's entries into the row-major (N, d) `dst`, real entries
// only, at rows j_off + j.
__device__ __forceinline__ void store_frag(float* __restrict__ dst, const float (&v)[16],
                                           int row0, int N, int d, const Frag& f,
                                           int j_off = 0) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + frag_s(f, r), j = j_off + frag_j(f, r);
    if (row < N && j < d) dst[static_cast<size_t>(row) * d + j] = v[r];
  }
}

// out(j, s) += sum_{k < rows} x0T(k, s) w(k, j) over the staged chunk, in the
// class kPrec, as fp32 FMAs straight into the fragment. The split classes
// form x = hi + lo with hi = bf16_rn(x), lo = x - hi (exact in fp32) for both
// operands and add hi*hi + hi*lo + lo*hi (kBf16x3), plus lo*lo (kBf16x4), in
// order over k: the function of the TPU kernels' g and c precision classes.
template <int kPrec>
__device__ __forceinline__ void fold_chunk_product(const Smem& sm, int rows, const Frag& f,
                                                   float (&out)[16]) {
  static_assert(kPrec == kHighest || kPrec == kBf16x3 || kPrec == kBf16x4,
                "unknown precision class");
  for (int k = 0; k < rows; ++k) {
    const float wv[2] = {sm.w[k * kMaxD + f.j0], sm.w[k * kMaxD + f.j0 + 8]};
    float xv[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 x = *reinterpret_cast<const float2*>(&sm.x0T[k * kTileS + f.s0 + 8 * q]);
      xv[2 * q] = x.x;
      xv[2 * q + 1] = x.y;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = xv[2 * (r >> 2) + (r & 1)], b = wv[(r >> 1) & 1];
      if constexpr (kPrec == kHighest) {
        out[r] = fmaf(a, b, out[r]);
      } else {
        const float ah = bf16_round(a), bh = bf16_round(b);
        const float al = a - ah, bl = b - bh;
        float v = fmaf(ah, bh, out[r]);
        v = fmaf(ah, bl, v);
        v = fmaf(al, bh, v);
        if constexpr (kPrec == kBf16x4) v = fmaf(al, bl, v);
        out[r] = v;
      }
    }
  }
}

// out(j, s) = sum_{k < n} x0(s, k) fold(k, j) for the fragment's rows
// j0 + j (j0: the first row a wide CTA owns) and the tile's scenarios, in
// the class kPrec, for any n: the first chunk is the one the tile staged
// with its inputs; each later one is staged over it once every thread has
// added the last (stage, synchronise, add, synchronise before the next), so
// the terms are added in k order, as one loop over n would add them. The
// fold is under 1% of a solve's work at n = 48: plain FMAs on the CUDA
// cores. Every thread of the block calls it.
template <int kPrec>
__device__ inline void fold_product(const Smem& sm, const float* __restrict__ fold,
                                    const float* __restrict__ x0, int row0, int N, int n, int d,
                                    int j0, const Frag& f, float (&out)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) out[r] = 0.0f;
  fold_chunk_product<kPrec>(sm, fold_rows(n), f, out);
  for (int k0 = kFoldRows; k0 < n; k0 += kFoldRows) {
    __syncthreads();  // every thread has added the chunk before
    stage_fold_chunk(sm, fold, x0, row0, N, n, d, j0, k0);
    __syncthreads();
    fold_chunk_product<kPrec>(sm, fold_rows(n - k0), f, out);
  }
}

// Store the thread's entries as the right operand of the next product in
// buffer `buf`: kParts = 1 the bf16 hi only (a coarse product), 2 hi and mid,
// 3 hi, mid and lo. Rows j >= d are written as zero. Entries r and r + 1 are
// (j, s) and (j, s + 1): one 32-bit store per part.
template <int kParts>
__device__ __forceinline__ void store_operand(const Smem& sm, int buf, const float (&v)[16],
                                              const Frag& f, int d) {
  uint32_t* b = reinterpret_cast<uint32_t*>(sm.b + buf * kSplits * kBElems);
#pragma unroll
  for (int r = 0; r < 16; r += 2) {
    const int j = frag_j(f, r);
    const bool real = j < d;
    uint32_t part[3];
    split_pair<kParts>(real ? v[r] : 0.0f, real ? v[r + 1] : 0.0f, part);
    const int at = b_index(j, frag_s(f, r)) / 2;
#pragma unroll
    for (int p = 0; p < kParts; ++p) b[p * kBElems / 2 + at] = part[p];
  }
}

// Store v as the operand of the next product, a coarse one or one of
// kTailPasses passes, in buffer `buf`; then make it visible to the tensor
// cores (async proxy) and synchronise the block.
template <int kTailPasses>
__device__ __forceinline__ void store_iterate(const Smem& sm, int buf, const float (&v)[16],
                                              const Frag& f, int d, bool coarse) {
  if (coarse) {
    store_operand<parts(kCoarse)>(sm, buf, v, f, d);
  } else {
    store_operand<parts(kTailPasses)>(sm, buf, v, f, d);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Shared-memory matrix descriptor, no swizzle: start address, LBO and SBO in
// 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const __nv_bfloat16* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// d += A(64 x 16) B(16 x 32) on the warpgroup's tensor cores, A K-major and
// B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Keep the compiler from moving reads or writes of d across the asynchronous
// product.
__device__ __forceinline__ void fence_operand(float (&d)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

// out' = A op' over the warpgroup's 64 rows, op in buffer `buf`, in kPasses
// bf16 passes (1, 3, 4 or 6; see Precision classes above): the hi*hi pass in
// one accumulator, the corrections in another, added after the wait. A
// warpgroup whose rows are all past d runs no pass and returns zeros; the
// k-steps stop at d. Every thread of the block calls it.
template <int kPasses>
__device__ __forceinline__ void product(const Smem& sm, int buf, int d, const Frag& f,
                                        float (&out)[16]) {
  static_assert(kPasses == 1 || kPasses == 3 || kPasses == 4 || kPasses == 6,
                "a class is 1, 3, 4 or 6 passes");
  float hh[16], corr[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) hh[r] = corr[r] = 0.0f;
  if (64 * f.wg < d) {
    const __nv_bfloat16* a = sm.a + f.wg * 8 * 1024;
    const __nv_bfloat16* b = sm.b + buf * kSplits * kBElems;
    // descriptors of the splits at k-step 0; k-step ks adds 16 ks (A, 256
    // bytes) and 64 ks (B, 1024 bytes) to the address field
    const uint64_t ah = smem_desc(a, 128, 2048), bh = smem_desc(b, 512, 128);
    const uint64_t am = smem_desc(a + kAElems, 128, 2048), bm = smem_desc(b + kBElems, 512, 128);
    const uint64_t al = smem_desc(a + 2 * kAElems, 128, 2048);
    const uint64_t bl = smem_desc(b + 2 * kBElems, 512, 128);
    fence_operand(hh);
    fence_operand(corr);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const int ksteps = (d + 15) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint64_t da = 16 * ks, db = 64 * ks;
      wgmma_m64n32k16(hh, ah + da, bh + db);
      if constexpr (kPasses >= 3) {
        wgmma_m64n32k16(corr, ah + da, bm + db);
        wgmma_m64n32k16(corr, am + da, bh + db);
      }
      if constexpr (kPasses == 6) {
        wgmma_m64n32k16(corr, ah + da, bl + db);
        wgmma_m64n32k16(corr, al + da, bh + db);
      }
      if constexpr (kPasses >= 4) wgmma_m64n32k16(corr, am + da, bm + db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operand(hh);
    fence_operand(corr);
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) out[r] = kPasses == 1 ? hh[r] : hh[r] + corr[r];
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

// -- The tiles -----------------------------------------------------------
// The kernels' bodies (boxqp_fista.cu, boxqp_admm.cu) are written once over a
// tile: NarrowTile is the layout above (one block a 32-scenario tile, d <=
// 128), each member the call the narrow kernels always made; WideTile is
// the cluster (Wide tile above). Both keep the carries in the fragment on
// the CTA's local rows: j_off is the CTA's first row, d_loc the real rows
// from there, row0 the tile's first scenario.

struct NarrowTile {
  Smem sm;
  int d;
  __device__ NarrowTile(unsigned char* base, int n, int d_, const float*) : sm(carve(base, n)), d(d_) {}
  __device__ int row0() const { return blockIdx.x * kTileS; }
  __device__ int j_off() const { return 0; }
  __device__ int d_loc() const { return d; }
  // A = m' in its three splits and the fold's first chunk (stage_inputs).
  __device__ void stage(const float* __restrict__ m, const float* __restrict__ fold,
                        const float* __restrict__ x0, int N, int n) const {
    stage_inputs(sm, m, fold, x0, row0(), N, n, d);
  }
  template <int kPasses>
  __device__ void product(int buf, const Frag& f, float (&out)[16]) const {
    boxqp::product<kPasses>(sm, buf, d, f, out);
  }
  template <int kTailPasses>
  __device__ void store_iterate(int buf, const float (&v)[16], const Frag& f, bool coarse) const {
    boxqp::store_iterate<kTailPasses>(sm, buf, v, f, d, coarse);
  }
  __device__ void finish() const {}
};

// This CTA's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster arrives and waits; the writes to shared memory
// before it are visible to the cluster's reads after it (release/acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes of CTA `rank`'s shared memory at the address `p` has in ours.
__device__ __forceinline__ uint4 load_peer(const void* p, int rank) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p)), peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(addr), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(peer)
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
}

// CTAs of the wide tile's cluster for d.
__host__ __device__ constexpr int wide_ctas(int d) { return (d + kTileD - 1) / kTileD; }

// Bytes of dynamic shared memory of the wide tile for a fold of n rows.
__host__ __device__ inline size_t wide_smem_bytes(int n) {
  const size_t rows = static_cast<size_t>(fold_rows(n));
  return sizeof(__nv_bfloat16) *
             (2 * kSplits * static_cast<size_t>(kASlabElems) + 2 * kSplits * kBSlabElems +
              2 * kSplits * kBElems) +
         sizeof(float) * (rows * kTileD + rows * kTileS);
}

struct WideTile {
  Smem sm;                         // b: the published slice's two buffers; w, x0T as narrow
  __nv_bfloat16* ring_a;           // 2 stages x kSplits x a 128 x 64 slab of A
  __nv_bfloat16* ring_b;           // 2 stages x kSplits x a 64 x 32 slab of B
  const __nv_bfloat16* panel;      // this CTA's rows of A, split and laid out by slab
  int d, ctas, rank, slabs_pad;    // slabs_pad: the panel's slabs per part, 2 ctas

  // `m` is the wrapper's operand: for each CTA r, part p (hi, mid, lo) and
  // slab s of K, the 128 x 64 block A[128r.., 64s..] as core matrices, K-major
  // ((j, k) at (j / 8) 512 + (k / 8) 64 + (j % 8) 8 + k % 8), zero past d.
  __device__ WideTile(unsigned char* base, int n, int d_, const float* m)
      : d(d_), ctas(wide_ctas(d_)), rank(cluster_rank()), slabs_pad(2 * wide_ctas(d_)) {
    ring_a = reinterpret_cast<__nv_bfloat16*>(base);
    ring_b = ring_a + 2 * kSplits * kASlabElems;
    sm.a = nullptr;
    sm.b = ring_b + 2 * kSplits * kBSlabElems;
    sm.w = reinterpret_cast<float*>(sm.b + 2 * kSplits * kBElems);
    sm.x0T = sm.w + fold_rows(n) * kTileD;
    panel = reinterpret_cast<const __nv_bfloat16*>(m) +
            static_cast<size_t>(rank) * kSplits * slabs_pad * kASlabElems;
  }
  __device__ int row0() const { return (blockIdx.x / ctas) * kTileS; }
  __device__ int j_off() const { return kTileD * rank; }
  __device__ int d_loc() const { return d - kTileD * rank; }

  // The first chunk of the fold's columns this CTA owns and of the tile's
  // x0 (stage_fold_chunk); A streams per product.
  __device__ void stage(const float*, const float* __restrict__ fold,
                        const float* __restrict__ x0, int N, int n) const {
    stage_fold_chunk(sm, fold, x0, row0(), N, n, d, j_off(), 0);
    __syncthreads();
  }

  // Start slab `slab` of a product into ring stage `stage`: kParts parts of
  // A's panel by cp.async, and of B from the published buffer `buf` of the
  // CTA that owns the slab's k-rows (two slabs a CTA).
  template <int kParts>
  __device__ void load_slab(int slab, int stage, int buf) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const __nv_bfloat16* src = panel + static_cast<size_t>(p * slabs_pad + slab) * kASlabElems;
      __nv_bfloat16* dst = ring_a + (stage * kSplits + p) * kASlabElems;
#pragma unroll
      for (int q = 0; q < kASlabElems / 8 / kThreads; ++q) {
        const int at = 8 * (t + q * kThreads);
        cp_async16(dst + at, src + at);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int owner = slab / 2, half = slab % 2;
    static_assert(kBSlabElems / 8 == kThreads, "one 16-byte piece of B a thread and part");
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const __nv_bfloat16* src = sm.b + (buf * kSplits + p) * kBElems + half * kBSlabElems;
      const uint4 v = load_peer(src + 8 * t, owner);
      *reinterpret_cast<uint4*>(ring_b + (stage * kSplits + p) * kBSlabElems + 8 * t) = v;
    }
  }

  // out' = A op' over this CTA's rows, op in the published buffers `buf` of
  // the cluster, in kPasses bf16 passes as the narrow product: the hi*hi pass
  // in one accumulator, the corrections in another. The k-steps stop at d.
  // Every thread of the CTA calls it, after the cluster barrier that
  // published op.
  template <int kPasses>
  __device__ void product(int buf, const Frag& f, float (&out)[16]) const {
    static_assert(kPasses == 1 || kPasses == 3 || kPasses == 4 || kPasses == 6,
                  "a class is 1, 3, 4 or 6 passes");
    constexpr int kParts = parts(kPasses);
    float hh[16], corr[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) hh[r] = corr[r] = 0.0f;
    const int ksteps = (d + 15) / 16, slabs = (ksteps + 3) / 4;
    const bool rows = 64 * f.wg < d_loc();
    load_slab<kParts>(0, 0, buf);
    for (int s = 0; s < slabs; ++s) {
      const int stage = s & 1;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // slab s staged; slab s - 1's passes done (waited below)
      if (s + 1 < slabs) load_slab<kParts>(s + 1, stage ^ 1, buf);
      if (rows) {
        const __nv_bfloat16* a = ring_a + stage * kSplits * kASlabElems + f.wg * 8 * 512;
        const __nv_bfloat16* b = ring_b + stage * kSplits * kBSlabElems;
        const uint64_t ah = smem_desc(a, 128, 1024), bh = smem_desc(b, 512, 128);
        const uint64_t am = smem_desc(a + kASlabElems, 128, 1024);
        const uint64_t bm = smem_desc(b + kBSlabElems, 512, 128);
        const uint64_t al = smem_desc(a + 2 * kASlabElems, 128, 1024);
        const uint64_t bl = smem_desc(b + 2 * kBSlabElems, 512, 128);
        fence_operand(hh);
        fence_operand(corr);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const int steps = min(4, ksteps - 4 * s);
        for (int ks = 0; ks < steps; ++ks) {
          const uint64_t da = 16 * ks, db = 64 * ks;
          wgmma_m64n32k16(hh, ah + da, bh + db);
          if constexpr (kPasses >= 3) {
            wgmma_m64n32k16(corr, ah + da, bm + db);
            wgmma_m64n32k16(corr, am + da, bh + db);
          }
          if constexpr (kPasses == 6) {
            wgmma_m64n32k16(corr, ah + da, bl + db);
            wgmma_m64n32k16(corr, al + da, bh + db);
          }
          if constexpr (kPasses >= 4) wgmma_m64n32k16(corr, am + da, bm + db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operand(hh);
        fence_operand(corr);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) out[r] = kPasses == 1 ? hh[r] : hh[r] + corr[r];
  }

  // Publish v, this CTA's rows of the next operand (a coarse one or one of
  // kTailPasses passes), in buffer `buf`, then the cluster barrier.
  template <int kTailPasses>
  __device__ void store_iterate(int buf, const float (&v)[16], const Frag& f, bool coarse) const {
    if (coarse) {
      store_operand<parts(kCoarse)>(sm, buf, v, f, d_loc());
    } else {
      store_operand<parts(kTailPasses)>(sm, buf, v, f, d_loc());
    }
    cluster_sync();
  }

  // No CTA leaves while a peer may still read its published buffers.
  __device__ void finish() const { cluster_sync(); }
};

// The wide tile's launch of `kernel` for N scenarios, a fold of n rows and d
// on `stream`: a cluster of wide_ctas(d) CTAs for each 32-scenario tile (the
// cluster dimension in `attr`), its shared memory opted in. Returns the CUDA
// error code of the opt-in.
template <typename... Params>
int wide_config(void (*kernel)(Params...), int N, int n, int d, void* stream,
                cudaLaunchAttribute (&attr)[1], cudaLaunchConfig_t& cfg) {
  const int ctas = wide_ctas(d);
  cfg = {};
  cfg.gridDim = dim3(ctas * ((N + kTileS - 1) / kTileS), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = wide_smem_bytes(n);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(cfg.dynamicSmemBytes)));
}

// The clusters of `kernel` in the launch `cfg` that the card can hold at
// once (cudaOccupancyMaxActiveClusters) into `clusters`; the CUDA error code.
template <typename... Params>
int active_clusters(void (*kernel)(Params...), const cudaLaunchConfig_t& cfg, int& clusters) {
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg));
}

// The clusters of `kernel` on the wide tile for d and a fold of n rows that
// the card can hold at once, or minus the CUDA error code.
template <typename... Params>
int wide_active_clusters(void (*kernel)(Params...), int n, int d) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  int err = wide_config(kernel, kTileS, n, d, nullptr, attr, cfg);
  if (err == 0) err = active_clusters(kernel, cfg, clusters);
  return err == 0 ? clusters : -err;
}

// Launch `kernel` on the wide tile (wide_config) with `args`. A cluster that
// cannot be scheduled (cudaOccupancyMaxActiveClusters 0) is refused with
// cudaErrorInvalidConfiguration. Returns the CUDA error code (0 on success).
template <typename... Params, typename... Args>
int launch_wide(void (*kernel)(Params...), int N, int n, int d, void* stream, Args&&... args) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  int err = wide_config(kernel, N, n, d, stream, attr, cfg);
  if (err == 0) err = active_clusters(kernel, cfg, clusters);
  if (err == 0 && clusters == 0) err = static_cast<int>(cudaErrorInvalidConfiguration);
  if (err == 0) err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...));
  return err == 0 ? static_cast<int>(cudaGetLastError()) : err;
}

}  // namespace boxqp
