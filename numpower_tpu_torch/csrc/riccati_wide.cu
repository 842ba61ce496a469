// Fused per-scenario backward Riccati recursion (K5) past the narrow
// envelope: 16 < n <= 48 or 8 < m <= 48.
//
// Replaces, as riccati.cu does below it, the TPU kernel
// numpower_tpu/kernels/riccati.py riccati_batched_fused (_riccati_kernel),
// which takes any (n, m): the JAX package's "auto" takes it for n <= 48 on
// the TPU. The function is riccati.cu's: for each scenario s with its own
// (A, B) and the shared Q, R, QF, from P = QF, T times
//     S  = R + B'(PB)
//     K  = S^{-1} B'(PA)
//     P' = Q + A'(PA) - (B'PA)' K           (upper triangle formed, mirrored)
// K of stage T-1-t written at its forward index into Ks (N, T, m, n), and
// P0 = P into (N, n, n).
//
// Why the narrow design stops at 16. It gives a scenario 16 or 32 lanes,
// lane c holding column c of M = [A | B] and its products in registers, and
// factors S (m <= 8) in every lane's registers. At n = 48, m = 16 a column
// of M'PM alone is 64 floats, and S has 136 entries.
//
// What bounds it: at the four-quadrotor formation (n = 48, m = 16, N = 4096,
// T = 30) the function needs 557k operations a scenario-step (Y = PM, the
// upper triangle of A'PA, B'PA, S's half, K, P''s upper triangle:
// chip_smoke.riccati_wide_ops), all of them products that run here on the
// tensor cores in three TF32 passes, 2.05e11 operations, 0.41 ms at 495
// TFLOP/s, against 466 MB of traffic (0.14 ms): the tensor operations bound
// it. All of it as fp32 on the CUDA cores would take 1.18 ms. The first form
// of this kernel (probes/riccati_wide_before.cu: a thread a column of M, the
// products as single fp32 FMA chains fed by shared-memory broadcasts, S
// factored by the block with two barriers a pivot, rolled substitutions,
// 64 threads a block) took 6.34 ms there (PERF.md, section 6).
//
// Design: the wide K7's (csrc/ilqr_backward_wide.cu), without its stage
// stream. One block a scenario; its working set (WideLayout) in dynamic
// shared memory, P resident, and [A | B] staged once, transposed (row c of
// Mt the column c; A's columns at slot 0, B's at slot NB), since A and B are
// the same at every stage. The products run on the tensor cores, mma.sync
// m16n8k8 in tf32_mma.cuh's rounded 3xTF32 form (hi rounded to the nearest
// TF32, each k-step's hi*hi added in fp32): P' = Q + A'PA - (B'PA)'K
// cancels terms of |P||A|^2, and the truncated form's ~2^-20 a term left
// the plain version's bounds at the formation whatever A is (its error
// 8x the plain version's distance from float64; with A itself or A
// negated: probes/riccati_wide_turns.py, PERF.md). A warp a 16 x 16 output
// block (tf32_mma.cuh's block16: fragments by ldmatrix where k runs along the
// rows of both operands, by 32-bit loads where it runs down their columns;
// row strides = 4 mod 8 and = 8 mod 16 keep a warp's accesses on distinct
// banks). A step, four barriers:
//   1. Y = P [A | B] by (16 rows of P, 16 slots), stored as Y' (slot-major);
//   2. [A | B]'Y, only the blocks the recursion needs: S = R + B'PB (B slots
//      x B slots), B'PA (B slots x A slots) and the upper block triangle of
//      A'PA + Q (into P's place, on and above the diagonal). For m <= 32
//      warp 0 takes S's blocks and at once inverts S in its registers
//      (spd_inverse_sweep, Gauss-Jordan) while the block's other warps form
//      B'PA and A'PA;
//   3. K = S^{-1} B'PA on the tensor cores, by 16 x 16 blocks (past
//      m = 32: the block factors S in shared memory and substitutes
//      forward and back, right-looking, a warp a row, as the wide K7);
//   4. K stored on consecutive addresses; P' = Q + A'PA - (B'PA)'K on the
//      tensor cores over P's upper block triangle, written at (r, c) and
//      mirrored at (c, r): no item reads an entry another one writes.
// Padding (rows and slots to 16 past n, B's slots to MB past m) is zeroed
// once at the block's start and never written: it enters the products as
// zeros, and their results there are dropped; S's inverse is that of S
// bordered by the identity. The bucket (NB, MB) fixes the layout, the items
// and the loops' trip counts at compile time; n and m guard only the loads
// and stores. Threads a block by NB + MB: 64 to 32, 128 to 64, 256 past
// it, with at most 128 registers a thread (four blocks of 128 threads an SM
// at the formation, 16 warps; it takes 79, and shared memory allows five).
// The variants tried and the times on the H100 are in
// probes/riccati_wide_turns.py and PERF.md, section 6. Measured there (H100
// 80GB HBM3, 700.00 W) at the formation: 2.36 ms own against the first
// form's 6.2-6.4 in turns; the truncated form on A, 2.09 ms, left the plain
// version's bounds there. By ablation (on an earlier form that staged
// A - I) Y = PM and [A | B]'Y took ~0.7 ms each, the 3xTF32 corrections
// ~0.5 of it, the Ks stores ~0.2.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace riccati {

constexpr int kWideMaxN = 48;
constexpr int kWideMaxM = 48;

using tf32_mma::block16;

__host__ __device__ constexpr int wide_round_up(int x, int q) { return (x + q - 1) / q * q; }

// The working set of a wide bucket (NB, MB), offsets in floats, every one
// 16-byte aligned: P (NB, ld), Mt (slots, ld), Y' (slots, ld) whose place K
// (m16, ldr) takes after step 2, S^{-1} by columns (m16, ldq; MB <= 32),
// B'PA (m16, ldr), S and its factor by columns (MB, ldL), 1 / L[a][a] (MB).
template <int NB, int MB>
struct WideLayout {
  static constexpr int nb = NB / 16, mb = (MB + 15) / 16, m16 = 16 * mb;
  static constexpr int slots = 16 * (nb + mb);
  static constexpr int threads = NB + MB <= 32 ? 64 : NB + MB <= 64 ? 128 : 256;
  static constexpr int ld = NB + 4;   // P, Mt, Y': k along the row, = 4 mod 8
  static constexpr int ldr = NB + 8;  // B'PA, K: k down the column, = 8 mod 16
  static constexpr int ldq = m16 + 8;  // S^{-1}: k down the column, = 8 mod 16
  static constexpr int ldL = MB + 1;  // odd: a warp's lanes on a row of L hit distinct banks
  static constexpr int oM = NB * ld;
  static constexpr int oY = oM + slots * ld;
  static constexpr int oQi = oY + (slots * ld > m16 * ldr ? slots * ld : m16 * ldr);
  static constexpr int oR = oQi + (MB <= 32 ? m16 * ldq : 0);
  static constexpr int oL = oR + m16 * ldr;
  static constexpr int oD = oL + wide_round_up(MB * ldL, 4);
  static constexpr int floats = oD + wide_round_up(MB, 4);
};

// S^{-1} of the SPD S (m <= MB <= 32, entry (a, b) at Ls[b * ldL + a]) by
// one warp in registers, into Qi (entry (a, b) at Qi[b * ldq + a]): lane i
// holds row i of S bordered by the identity past m, and the warp runs
// Gauss-Jordan elimination in place, pivot k's row passed by __shfl_sync (S
// is SPD: its pivots stay positive with no search). A lane keeps its row
// and one pivot row's entries in flight. (The wide K7's spd_inverse_warp,
// a factor, L^{-1} and their product, spilled here at 128 registers: 88
// bytes at MB = 16, 1.8 KB at MB = 32; probes/riccati_wide_turns.py.)
template <int MB>
__device__ __forceinline__ void spd_inverse_sweep(const float* Ls, int ldL, int m, float* Qi,
                                                  int ldq, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  float row[MB];
#pragma unroll
  for (int k = 0; k < MB; ++k)
    row[k] = (lane < m && k < m) ? Ls[k * ldL + lane] : (lane == k ? 1.0f : 0.0f);
#pragma unroll
  for (int k = 0; k < MB; ++k) {
    const float d = __frcp_rn(__shfl_sync(kAll, row[k], k));
    const float f = row[k];  // entry (lane, k)
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      if (j == k) continue;
      const float akj = __shfl_sync(kAll, row[j], k) * d;  // pivot row k, scaled
      row[j] = lane == k ? akj : fmaf(-f, akj, row[j]);
    }
    row[k] = lane == k ? d : -f * d;
  }
#pragma unroll
  for (int b = 0; b < MB; ++b)
    if (lane < m && b < m) Qi[b * ldq + lane] = row[b];
}

// At most 128 registers a thread (512 threads an SM).
template <int NB, int MB>
__global__ void __launch_bounds__(WideLayout<NB, MB>::threads, 512 / WideLayout<NB, MB>::threads)
    riccati_wide_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                        const float* __restrict__ Q, const float* __restrict__ R,
                        const float* __restrict__ QF, float* __restrict__ Ks,
                        float* __restrict__ P0, int n, int m, int T) {
  using L = WideLayout<NB, MB>;
  constexpr int nb = L::nb, mb = L::mb, m16 = L::m16, ld = L::ld, ldr = L::ldr, ldq = L::ldq;
  constexpr int ldL = L::ldL;
  constexpr int kn = NB / 8, km = MB / 8;  // k-steps over n and over m
  constexpr bool kWarpInverse = MB <= 32;
  extern __shared__ __align__(16) float wide_smem[];
  float* const P = wide_smem;          // P by rows; A'PA + Q on and above the diagonal in step 2
  float* const Mt = wide_smem + L::oM;  // entry (j, c) of [A | B] at Mt[slot(c) ld + j]
  float* const Y = wide_smem + L::oY;   // Y': entry (i, c) of PM at Y[c ld + i]
  float* const XX = Y;                  // K: entry (a, c) at XX[a ldr + c], after step 2
  float* const Qi = wide_smem + L::oQi;  // S^{-1}: (a, b) at Qi[b ldq + a]
  float* const G = wide_smem + L::oR;    // B'PA: (a, c) at G[a ldr + c]
  float* const Lq = wide_smem + L::oL;   // S, then L by columns: (i, k) at Lq[k ldL + i]
  float* const dinv = wide_smem + L::oD;
  const int tid = threadIdx.x, nt = L::threads, lane = tid % 32, warp = tid / 32;
  constexpr int nw = L::threads / 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t s = blockIdx.x;

  for (int e = tid; e < L::floats; e += nt) wide_smem[e] = 0.0f;
  __syncthreads();
  const float* Ag = As + s * n * n;
  const float* Bg = Bs + s * n * m;
  for (int e = tid; e < n * n; e += nt) {  // read along A's rows
    const int j = e / n, c = e % n;
    Mt[c * ld + j] = Ag[e];
    P[j * ld + c] = QF[e];
  }
  for (int e = tid; e < n * m; e += nt) Mt[(NB + e % m) * ld + e / m] = Bg[e];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // 1. Y = P M by (16 rows of P, 16 slots), stored as Y'
    for (int it = warp; it < nb * (nb + mb); it += nw) {
      const int p = it % nb, q = it / nb;
      float out[2][4];
      block16<true, true, true>(P + 16 * p * ld, ld, Mt + 16 * q * ld, ld, kn, lane, out);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * p + g + 8 * (e >> 1), c = 16 * q + 8 * h + 2 * t4 + (e & 1);
          Y[c * ld + i] = out[h][e];
        }
    }
    __syncthreads();  // Y' is complete; P is read no more this step

    // 2. M'Y by 16 x 16 blocks: S's (B slots x B slots, with R, into the
    // factor's storage), B'PA's (B slots x A slots) and A'PA's upper block
    // triangle (with Q, into P's place, c >= r)
    constexpr int ns = mb * mb, ng = mb * nb, items = ns + ng + nb * (nb + 1) / 2;
    auto block = [&](int it) {
      int p, q, kind;  // kind 0 S, 1 B'PA, 2 A'PA; (p, q) the row and column blocks
      if (it < ns) {
        kind = 0, p = it % mb, q = it / mb;
      } else if (it < ns + ng) {
        kind = 1, p = (it - ns) % mb, q = (it - ns) / mb;
      } else {
        kind = 2, q = 0;
        for (p = it - ns - ng; p > q; ++q) p -= q + 1;  // (p, q), p <= q, column by column
      }
      const int r0 = (kind == 2 ? 0 : NB) + 16 * p, c0 = (kind == 0 ? NB : 0) + 16 * q;
      float out[2][4];
      block16<true, true, true>(Mt + r0 * ld, ld, Y + c0 * ld, ld, kn, lane, out);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * p + g + 8 * (e >> 1), c = 16 * q + 8 * h + 2 * t4 + (e & 1);
          const float v = out[h][e];
          if (kind == 0) {
            if (r < m && c < m) Lq[c * ldL + r] = v + R[r * m + c];
          } else if (kind == 1) {
            if (r < m && c < n) G[r * ldr + c] = v;
          } else if (c < n && r <= c) {
            P[r * ld + c] = v + Q[r * n + c];
          }
        }
    };
    if (kWarpInverse && warp == 0) {
      for (int it = 0; it < ns; ++it) block(it);
      __syncwarp();
      if constexpr (kWarpInverse) spd_inverse_sweep<MB>(Lq, ldL, m, Qi, ldq, lane);
    } else {
      const int w = kWarpInverse ? warp - 1 : warp, ws = kWarpInverse ? nw - 1 : nw;
      for (int it = (kWarpInverse ? ns : 0) + w; it < items; it += ws) block(it);
    }
    __syncthreads();

    if constexpr (kWarpInverse) {
      // 3. K = S^{-1} B'PA by 16 x 16 blocks, k = b down S^{-1}'s and
      // B'PA's columns; S^{-1}'s rows past m are zero, and so are K's
      for (int it = warp; it < mb * nb; it += nw) {
        const int p = it % mb, q = it / mb;
        float out[2][4];
        block16<false, true, true>(Qi + 16 * p, ldq, G + 16 * q, ldr, km, lane, out);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            XX[(16 * p + g + 8 * (e >> 1)) * ldr + 16 * q + 8 * h + 2 * t4 + (e & 1)] = out[h][e];
      }
      __syncthreads();
    } else {
      // 3. B'PA into XX (the rows past m zero); S = L L' in place and the
      // forward substitution L Y = XX in place, right-looking: at pivot j
      // the block scales column j of L and row j of Y (then final), and
      // after a barrier a warp takes each row i > j, its lanes the trailing
      // entries (i, k), j < k <= i, and the row's right-hand sides
      for (int it = tid; it < m16 * NB; it += nt) {
        const int a = it / NB, col = it % NB;
        XX[a * ldr + col] = a >= m ? 0.0f : G[a * ldr + col];
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float inv = rsqrtf(Lq[j * ldL + j]);
        for (int i = j + 1 + tid; i < m; i += nt) Lq[j * ldL + i] *= inv;
        for (int col = tid; col < n; col += nt) XX[j * ldr + col] *= inv;
        if (tid == 0) dinv[j] = inv;
        __syncthreads();
        for (int i = j + 1 + warp; i < m; i += nw) {
          const float lij = Lq[j * ldL + i];
          for (int k = j + 1 + lane; k <= i; k += 32) Lq[k * ldL + i] -= lij * Lq[j * ldL + k];
          for (int col = lane; col < n; col += 32) XX[i * ldr + col] -= lij * XX[j * ldr + col];
        }
        __syncthreads();
      }
      // the back substitution L' X = Y in place, right-looking from the
      // last row: at row a, x_a = Y[a] / L[a][a] is final, and a warp a row
      // q < a takes Y[q] -= L[a][q] x_a; then XX = X = K
      for (int a = m - 1; a >= 0; --a) {
        const float da = dinv[a];
        for (int q = warp; q < a; q += nw) {
          const float laq = Lq[q * ldL + a];
          for (int col = lane; col < n; col += 32)
            XX[q * ldr + col] -= laq * (XX[a * ldr + col] * da);
        }
        __syncthreads();
      }
      for (int it = tid; it < m * n; it += nt) {
        const int a = it / n, col = it % n;
        XX[a * ldr + col] *= dinv[a];
      }
      __syncthreads();
    }

    // 4. K stored at its forward index; P' = Q + A'PA - (B'PA)'K by 16 x 16
    // blocks of its upper block triangle, k = a down B'PA's and K's columns,
    // written at (r, c) and (c, r) for r <= c
    float* const Kout = Ks + (s * T + (T - 1 - t)) * m * n;
    for (int a = warp; a < m; a += nw)
      for (int c = lane; c < n; c += 32) Kout[a * n + c] = XX[a * ldr + c];
    for (int it = warp; it < nb * (nb + 1) / 2; it += nw) {
      int p = it, q = 0;
      for (; p > q; ++q) p -= q + 1;
      float out[2][4];
      block16<false, true, true>(G + 16 * p, ldr, XX + 16 * q, ldr, km, lane, out);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * p + g + 8 * (e >> 1), c = 16 * q + 8 * h + 2 * t4 + (e & 1);
          if (c < n && r <= c) {
            const float v = P[r * ld + c] - out[h][e];
            P[r * ld + c] = v;
            P[c * ld + r] = v;
          }
        }
    }
    __syncthreads();  // P' is complete, and K's place is Y''s again
  }

  // P0 (QF itself when T = 0), the block's threads on consecutive addresses
  for (int e = tid; e < n * n; e += nt) P0[s * n * n + e] = P[(e / n) * ld + e % n];
}

template <int NB, int MB>
cudaError_t launch_wide(const float* As, const float* Bs, const float* Q, const float* R,
                        const float* QF, float* Ks, float* P0, int N, int n, int m, int T,
                        cudaStream_t stream) {
  using L = WideLayout<NB, MB>;
  constexpr int smem = L::floats * static_cast<int>(sizeof(float));
  static_assert(smem <= 227 * 1024, "the wide K5's block fits the shared memory a block may have");
  const cudaError_t err = cudaFuncSetAttribute(
      riccati_wide_kernel<NB, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  riccati_wide_kernel<NB, MB><<<N, L::threads, smem, stream>>>(As, Bs, Q, R, QF, Ks, P0, n, m, T);
  return cudaGetLastError();
}

// The smallest wide bucket that holds n (m).
inline int wide_bucket_n(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : 48; }
inline int wide_bucket_m(int m) { return m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : 48; }

}  // namespace riccati

// As npt_riccati_fused (riccati.cu), for n <= 48 and m <= 48 outside its
// envelope (n <= 16 and m <= 8, which this entry refuses). Returns the CUDA
// error code of the launch (0 on success).
extern "C" int npt_riccati_fused_wide(const float* As, const float* Bs, const float* Q,
                                      const float* R, const float* QF, float* Ks, float* P0,
                                      int N, int n, int m, int T, void* stream) {
  using namespace riccati;
  if (N < 1 || n < 1 || n > kWideMaxN || m < 1 || m > kWideMaxM || T < 0 || (n <= 16 && m <= 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wide_bucket_n(n) * 64 + wide_bucket_m(m)) {
#define NPT_CASE(NB, MB) \
  case NB * 64 + MB:     \
    return static_cast<int>(launch_wide<NB, MB>(As, Bs, Q, R, QF, Ks, P0, N, n, m, T, st));
    NPT_CASE(16, 16) NPT_CASE(16, 32) NPT_CASE(16, 48)
    NPT_CASE(32, 8) NPT_CASE(32, 16) NPT_CASE(32, 32) NPT_CASE(32, 48)
    NPT_CASE(48, 8) NPT_CASE(48, 16) NPT_CASE(48, 32) NPT_CASE(48, 48)
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
