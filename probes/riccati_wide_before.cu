// Fused per-scenario backward Riccati recursion (K5) past the narrow
// envelope: 16 < n <= 48 or 8 < m <= 48.
//
// Replaces, as riccati.cu does below it, the TPU kernel
// numpower_tpu/kernels/riccati.py riccati_batched_fused (_riccati_kernel),
// which takes any (n, m): the JAX package's "auto" takes it for n <= 48 on
// the TPU. The function is riccati.cu's: for each scenario s with its own
// (A, B) and the shared Q, R, QF, from P = QF, T times
//     S  = R + B'(PB)                       (lower triangle formed and read)
//     K  = S^{-1} B'(PA)                    (Cholesky, one rsqrtf per pivot)
//     P' = Q + A'(PA) - (B'PA)' K           (upper triangle formed, mirrored)
// K of stage T-1-t written at its forward index into Ks (N, T, m, n), and
// P0 = P into (N, n, n).
//
// Why the narrow design stops at 16. It gives a scenario 16 or 32 lanes,
// lane c holding column c of M = [A | B] and its products in registers, and
// factors S (m <= 8) in every lane's registers. At n = 48, m = 16 a column
// of M'PM alone is 64 floats, and S has 136 entries.
//
// Design. One block a scenario, a thread per column of M (NC = NB + MB
// columns, rounded up to whole warps). P, M' (by rows: row k is column k of
// M), G, S and S's inverse pivots live in shared memory, 47.8 KB at
// (48, 48), under the 48 KB of a plain launch. A step:
//   1. y = P M[:, c]: thread c over the rows of P, each read as 16-byte
//      broadcasts (P is symmetric), with M[j][c] from its own row of M' (the
//      rows' stride NB + 4: a 4-way bank conflict on one load in 13); y
//      stays in registers;
//   2. z = M' y, an entry at a time (rows of M' as broadcasts, two chains
//      in flight): thread c < NB forms column c of A'PA, written into P's
//      place (P is read no more this step), and of B'PA, written as column c
//      of G; thread NB + b forms column b of B'PB, written with R's into S;
//   3. the block factors S = L L' in place, right-looking, thread i owning
//      row i, two barriers a pivot, 1 / L[a][a] kept beside it;
//   4. thread c < NB forward-substitutes its column of G in place:
//      G = L^{-1} B'PA;
//   5. thread c < NB forms column c of P' = Q + A'PA - G'G (the rows of G as
//      broadcasts; (B'PA)'K = G'G) in registers, and after a barrier writes
//      it as row c of P;
//   6. thread c < NB back-substitutes its column of G in place, K = L'^{-1}
//      G, and stores it to Ks (the threads on consecutive addresses); after
//      a barrier, it writes its entries of P' above the diagonal into
//      column c, so that P' is the upper triangle mirrored.
// The vectors of the substitutions and of z, and S's factor, live in shared
// memory and the loops over them are rolled: held in registers and unrolled
// (riccati.cu's form, and S factored in one warp's registers), the 48-wide
// instances spilled and the source took ~3 minutes to compile. The
// sums of steps 1-2 run over j in riccati.cu's order; P' takes G'G where
// the plain version takes (B'PA)'K, the same product by other roundings.
// The buckets' padding is exact: A, B, Q, QF are 0 and R is the identity
// outside (n, m), which keeps the padded rows of P and K at 0 and the padded
// pivots of S at 1. The unrolled loops run to the compile-time buckets NB in
// {16, 32, 48} and MB in {8, 16, 32, 48} with no per-element guard
// (riccati.cu's note: a guard on a runtime n in an unrolled loop
// serialises the shared loads).
//
// What bounds it: at the four-quadrotor formation (n = 48, m = 16, N = 4096,
// T = 30) the fp32 operations, 7.9e10 (1.18 ms at 67 TFLOP/s), against
// 466 MB of traffic (0.14 ms). A step is ~7k FMAs a column thread, each
// 16-byte shared load feeding four. A simple form first: its time is in
// PERF.md, section 6.

#include <cuda_runtime.h>

namespace riccati {

constexpr int kWideMaxN = 48;
constexpr int kWideMaxM = 48;

// The layout of a wide bucket: threads a block, and the offsets (floats) of
// P (NB, NB), M' (NC, NB + 4), G (MB, NB), S (MB, MB) and 1 / L[a][a] (MB)
// in shared memory; every row 16-byte aligned (NB and MB are multiples of 8).
template <int NB, int MB>
struct WideLayout {
  static constexpr int NC = NB + MB;                     // columns of M = [A | B]
  static constexpr int kThreads = (NC + 31) / 32 * 32;   // a thread a column
  static constexpr int ldT = NB + 4;                     // M' row stride, 16-byte rows
  static constexpr int offT = NB * NB;
  static constexpr int offG = offT + NC * ldT;
  static constexpr int offS = offG + MB * NB;
  static constexpr int offD = offS + MB * MB;
  static constexpr int floats = offD + MB;
};

template <int W>
__device__ __forceinline__ void wide_load_row(const float* src, float (&dst)[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void wide_store_row(float* dst, const float (&src)[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
}

// One block a multiprocessor in the bound, as riccati.cu's: without it
// ptxas trades spills for occupancy.
template <int NB, int MB>
__global__ void __launch_bounds__(WideLayout<NB, MB>::kThreads, 1)
    riccati_wide_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                        const float* __restrict__ Q, const float* __restrict__ R,
                        const float* __restrict__ QF, float* __restrict__ Ks,
                        float* __restrict__ P0, int n, int m, int T) {
  using L = WideLayout<NB, MB>;
  constexpr int NC = L::NC, kThreads = L::kThreads, ldT = L::ldT;
  __shared__ __align__(16) float wide_sm[L::floats];
  float* const P = wide_sm;             // (NB, NB) P by rows; A'PA by columns during a step
  float* const MT = wide_sm + L::offT;  // (NC, ldT) row k = column k of [A | B]
  float* const G = wide_sm + L::offG;   // (MB, NB) column c: B'PA[:, c], L^{-1} of it, K[:, c]
  float* const S = wide_sm + L::offS;   // (MB, MB) column b of S as row b; then of L
  float* const dinv = wide_sm + L::offD;  // (MB) 1 / L[a][a]
  const int c = threadIdx.x;
  const size_t s = blockIdx.x;
  const bool a_col = c < NB, b_col = c >= NB && c < NC;
  const int cc = c < NC ? c : NC - 1;  // threads past the columns repeat the last, store nothing

  // Stage the zero-padded [A | B]' and P = QF' (the first step reads P by
  // rows as columns: its transpose gives QF A, as the plain version).
  const float* Ag = As + s * n * n;
  const float* Bg = Bs + s * n * m;
  for (int e = c; e < NC * ldT; e += kThreads) {
    const int k = e / ldT, r = e % ldT;  // M'[k][r] = M[r][k]
    float v = 0.0f;
    if (r < n && k < n) v = Ag[r * n + k];
    else if (r < n && k >= NB && k - NB < m) v = Bg[r * m + (k - NB)];
    MT[e] = v;
  }
  for (int e = c; e < NB * NB; e += kThreads) {
    const int r = e / NB, k = e % NB;
    P[e] = (r < n && k < n) ? QF[k * n + r] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // 1. y = P M[:, c], from the rows of P
    float y[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) y[r] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < NB; ++j) {
      float prow[NB];
      wide_load_row<NB>(P + j * NB, prow);
      const float mj = MT[cc * ldT + j];
#pragma unroll
      for (int r = 0; r < NB; ++r) y[r] = fmaf(prow[r], mj, y[r]);
    }
    __syncthreads();  // every read of P this step is done: A'PA takes its place

    // 2. z = M' y, two entries at a time: A'PA[:, c] into P's place and
    // B'PA[:, c] into G (c < NB), or B'PB[:, b] + R[:, b] into S (c = NB + b)
#pragma unroll 1
    for (int k = a_col ? 0 : NB; k < NC; k += 2) {
      float z[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < NB; q += 4) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float4 v = *reinterpret_cast<const float4*>(MT + (k + kk) * ldT + q);
          z[kk] = fmaf(v.x, y[q], z[kk]);
          z[kk] = fmaf(v.y, y[q + 1], z[kk]);
          z[kk] = fmaf(v.z, y[q + 2], z[kk]);
          z[kk] = fmaf(v.w, y[q + 3], z[kk]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int row = k + kk;  // k steps by 2 and NB is even: one side of NB a pair
        if (a_col) {
          if (row < NB) P[row * NB + c] = z[kk];
          else G[(row - NB) * NB + c] = z[kk];
        } else if (b_col) {
          const int a = row - NB, b = c - NB;
          S[b * MB + a] = z[kk] + ((a < m && b < m) ? R[a * m + b] : (a == b ? 1.0f : 0.0f));
        }
      }
    }
    __syncthreads();  // A'PA, B'PA and S are complete

    // 3. S = L L' in place, right-looking, thread i owning row i: at pivot
    // j every thread forms 1 / sqrt(S[j][j]) and row i scales its entry of
    // column j; after a barrier row i takes its trailing update by column
    // j. Each entry sees factor<n>'s operations in its order. S's lower
    // triangle is stored by columns (S[k][i] at k * MB + i): the rows'
    // threads on consecutive addresses, column j's entries broadcast.
#pragma unroll 1
    for (int j = 0; j < MB; ++j) {
      const float inv = rsqrtf(S[j * MB + j]);
      if (c > j && c < MB) S[j * MB + c] *= inv;
      if (c == j) dinv[j] = inv;
      __syncthreads();
      if (c > j && c < MB) {
        const float lij = S[j * MB + c];
#pragma unroll 4
        for (int k = j + 1; k <= c; ++k) S[k * MB + c] -= lij * S[j * MB + k];
      }
      __syncthreads();
    }

    // 4. G[:, c] = L^{-1} B'PA[:, c], in place, in the order of riccati.cu's
    if (a_col) {
#pragma unroll 1
      for (int a = 0; a < MB; ++a) {
        float v = G[a * NB + c];
#pragma unroll 4
        for (int q = 0; q < a; ++q) v -= S[q * MB + a] * G[q * NB + c];
        G[a * NB + c] = v * dinv[a];
      }
    }
    __syncthreads();

    // 5. column c of P' = Q + A'PA - G'G, over the rows of G
    float v[NB];
    if (a_col) {
#pragma unroll
      for (int r = 0; r < NB; ++r) v[r] = P[r * NB + c];
#pragma unroll 1
      for (int a = 0; a < MB; ++a) {
        float grow[NB];
        wide_load_row<NB>(G + a * NB, grow);
        const float gc = G[a * NB + c];
#pragma unroll
        for (int r = 0; r < NB; ++r) v[r] = fmaf(-grow[r], gc, v[r]);
      }
#pragma unroll
      for (int r = 0; r < NB; ++r) v[r] += (r < n && c < n) ? Q[r * n + c] : 0.0f;
    }
    __syncthreads();  // every read of A'PA and of G this step is done
    if (a_col) {
      wide_store_row<NB>(P + c * NB, v);  // column c of P' as row c
      // 6. K[:, c] = L'^{-1} G[:, c], in place, stored at its forward index
#pragma unroll 1
      for (int a = MB - 1; a >= 0; --a) {
        float w = G[a * NB + c];
#pragma unroll 4
        for (int q = a + 1; q < MB; ++q) w -= S[a * MB + q] * G[q * NB + c];
        G[a * NB + c] = w * dinv[a];
      }
      if (c < n) {
        float* Kout = Ks + (s * T + (T - 1 - t)) * m * n + c;
        for (int a = 0; a < m; ++a) Kout[static_cast<size_t>(a) * n] = G[a * NB + c];
      }
    }
    __syncthreads();
    if (a_col) {  // then its entries above the diagonal into column c
#pragma unroll
      for (int r = 0; r < NB; ++r)
        if (r < c) P[r * NB + c] = v[r];
    }
    __syncthreads();  // P' is complete before the next step reads it
  }

  // P0[i][j] = P[j][i] (QF itself when T = 0), the block's threads on
  // consecutive addresses
  for (int e = c; e < n * n; e += kThreads) P0[s * n * n + e] = P[(e % n) * NB + e / n];
}

template <int NB, int MB>
cudaError_t launch_wide(const float* As, const float* Bs, const float* Q, const float* R,
                        const float* QF, float* Ks, float* P0, int N, int n, int m, int T,
                        cudaStream_t stream) {
  using L = WideLayout<NB, MB>;
  static_assert(L::floats * sizeof(float) <= 48 * 1024,
                "the wide K5's block fits the shared memory of a plain launch");
  riccati_wide_kernel<NB, MB><<<N, L::kThreads, 0, stream>>>(As, Bs, Q, R, QF, Ks, P0, n, m, T);
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
