// The TF32 tensor-core helpers of the wide kernels (csrc/ilqr_backward_wide.cu,
// csrc/riccati_wide.cu): the 3xTF32 split of fp32 operands and mma.sync
// m16n8k8 products of 16 x 16 output blocks, with fragments by ldmatrix.
//
// 3xTF32: each operand x = hi + lo, hi = x in TF32, lo = x - hi; hi*hi into
// one fp32 accumulator, hi*lo + lo*hi into a second, added after the k loop
// (the tensor cores' sum is not round-to-nearest, and the corrections would
// be cut against the large term). A single TF32 pass keeps ~3 digits, which
// neither kernel's recursion holds to 1e-3. Two forms (block16's kRound):
//  - hi truncated, hi*hi summed over the k loop in the tensor cores' own
//    accumulator: ~2^-20 of each term's size (the wide K7's);
//  - hi rounded to the nearest TF32, and each k-step's hi*hi from a fresh
//    accumulator added to the sum by an fp32 add (round-to-nearest): near
//    fp32's own error whatever the operands (the wide K5's, whose P' =
//    Q + A'PA - (B'PA)'K cancels terms of |P||A|^2; the first form's error
//    there left the plain version's bounds on the formation, 8x the plain
//    version's distance from float64; probes/riccati_wide_turns.py).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo with hi = x truncated to TF32 (its low 13 bits cleared), or
// with kRound rounded to the nearest (half of the low 13 bits' range added
// first: ties away from zero), and lo = x - hi, exact in fp32; mma.sync
// reads lo's top 19 bits. Two or three instructions (cvt.rna.tf32.f32 took
// more: probes/ilqr_wide_turns.py).
template <bool kRound = false>
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (kRound ? x + 0x1000u : x) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product with an fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 4 blocks of 32-bit words from shared memory, a lane's row
// address each (lanes 8i..8i + 7 the rows of block i): lane l receives word
// l % 4 of row l / 4 of each block. On fp32 data this is the m16n8k8 TF32
// fragment: one instruction for the four loads of an A fragment, or the
// four of two B fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// hh += hi(a) hi(b); cr += hi(a) lo(b) + lo(a) hi(b), for the two n8 tiles
// of an item, from the raw fragments (kRound: split_tf32's, and hi(a) hi(b)
// from a fresh accumulator added to hh in fp32).
template <bool kRound = false>
__device__ __forceinline__ void mma3(float (&hh)[2][4], float (&cr)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  uint32_t ah[4], al[4], bh[4], bl[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    split_tf32<kRound>(a[e], ah[e], al[e]);
    split_tf32<kRound>(b[e], bh[e], bl[e]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t bhh[2] = {bh[2 * h], bh[2 * h + 1]}, blh[2] = {bl[2 * h], bl[2 * h + 1]};
    mma_tf32(cr[h], al, bhh);
    mma_tf32(cr[h], ah, blh);
    if constexpr (kRound) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(part, ah, bhh);
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[h][e] += part[e];
    } else {
      mma_tf32(hh[h], ah, bhh);
    }
  }
}

// A 16 x 16 output block by one warp: out(r, c) = sum_k A(r, k) B(k, c), k
// < 8 ksteps, in the 3xTF32 split. kKRow: A(r, k) at A[r lda + k] and B(k,
// c) at B[c ldb + k] (k along the rows; in shared memory the fragments come
// by ldmatrix, rows 16-byte aligned); else A(r, k) at A[k lda + r] and B(k,
// c) at B[k ldb + c], by 32-bit loads. Lane (g, t) = (lane / 4, lane % 4)
// holds, in out[h], the m16n8 fragment of columns 8h..8h + 7: entry e at
// row g + 8 (e >> 1), column 8h + 2t + (e & 1). (Even and odd k-steps in two
// accumulators, to halve the chain of dependent mma.sync, ran the formation
// slower: more registers at the 128 a thread four blocks an SM allow.)
// kRound: mma3's rounded form.
template <bool kKRow, bool kShared, bool kRound = false>
__device__ __forceinline__ void block16(const float* A, int lda, const float* B, int ldb,
                                        int ksteps, int lane, float (&out)[2][4]) {
  const int g = lane / 4, t = lane % 4;
  float hh[2][4] = {}, cr[2][4] = {};
  // lane l addresses row l % 8 of block l / 8: A's blocks (rows 0-7, k 0-3),
  // (8-15, 0-3), (0-7, 4-7), (8-15, 4-7); B's (columns 0-7, k 0-3), (0-7,
  // 4-7), (8-15, 0-3), (8-15, 4-7)
  uint32_t pa = 0, pb = 0;
  if constexpr (kKRow && kShared) {
    const int blk = lane / 8, r = lane % 8;
    pa = smem_u32(A + (r + 8 * (blk & 1)) * lda + 4 * (blk >> 1));
    pb = smem_u32(B + (r + 8 * (blk >> 1)) * ldb + 4 * (blk & 1));
  }
  auto at = [](const float* P, int ldp, int row, int k) {
    return __float_as_uint(kKRow ? P[row * ldp + k] : P[k * ldp + row]);
  };
#pragma unroll 2
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4], b[4];
    if constexpr (kKRow && kShared) {
      ldsm_x4(a, pa + 32 * kk);
      ldsm_x4(b, pb + 32 * kk);
    } else {
      const int k0 = 8 * kk + t;
      a[0] = at(A, lda, g, k0), a[1] = at(A, lda, g + 8, k0);
      a[2] = at(A, lda, g, k0 + 4), a[3] = at(A, lda, g + 8, k0 + 4);
      b[0] = at(B, ldb, g, k0), b[1] = at(B, ldb, g, k0 + 4);
      b[2] = at(B, ldb, 8 + g, k0), b[3] = at(B, ldb, 8 + g, k0 + 4);
    }
    mma3<kRound>(hh, cr, a, b);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[h][e] = hh[h][e] + cr[h][e];
}

}  // namespace tf32_mma
