// Fused per-scenario backward Riccati recursion (K5).
//
// Replaces the TPU kernel numpower_tpu/kernels/riccati.py
// riccati_batched_fused (_riccati_kernel, _mm, _chol_solve_rows). For each
// scenario s with its own (A, B) and the shared Q, R, QF it runs, from
// P = QF, T times:
//     S  = R + B'(PB)                       (lower triangle formed and read)
//     K  = S^{-1} B'(PA)                    (Cholesky, one rsqrtf per pivot)
//     P' = Q + A'(PA) - (B'PA)' K           (upper triangle formed, mirrored)
// and writes K of stage T-1-t at its forward index, so Ks comes out in
// forward time, straight into the public (N, T, m, n) layout, and P0 = P
// into (N, n, n). No permute on the host.
//
// What bounds it on the H100: shared-memory accesses, not its FMAs. A step
// is a chain of small products (n = 12, m = 4: ~10k FLOP a scenario), and
// the first port fed every FMA from a shared load of its own: ~900 accesses
// per warp-step against ~600 FMAs, 184-188 us at N = 4096, T = 30, where
// the fp32 operations need 18.4 us (PERF.md, section 6; the probe
// probes/mppi_riccati.py split it: P' 47%, PA/PB 33%).
//
// Design. A group of G lanes per scenario (G = 16, two scenarios a warp,
// their shared-memory slices 16 banks apart; G = 32 where n + m > 16) and
// lane c owns column c of M = [A | B] (n + m columns), held in registers
// for the whole loop with column c of Q (or of R). A step:
//   1. y = P M[:, c]: column c of PA (c < n) or of PB, over the rows of P,
//      each read from shared memory as 16-byte broadcasts (P is symmetric);
//   2. z = M' y: column c of [A B]'P[A B], over the rows of M, the same way.
//      Lane c < n now holds A'PA[:, c] and B'PA[:, c], lane n + b holds
//      B'PB[:, b], so S, B'PA and A'PA are each formed once a scenario;
//   3. lane c writes B'PA[:, c] as a row of W; lane n + b adds R[:, b]
//      (held in registers) to its column; every lane gathers S's lower
//      triangle from those lanes by shuffles and factors it in registers
//      (m <= 8: a short chain, cheaper run in every lane than broadcast);
//   4. lane c < n solves for column c of K (and stores it to Ks);
//   5. lane c < n forms column c of P' = Q + A'PA - (B'PA)'K from z, K's
//      column and the rows of W, writes it as row c of P (16-byte stores),
//      then its entries above the diagonal into column c, so that P' is the
//      upper triangle mirrored.
// Every product sums over j in the order of the first port, so the results
// are bit for bit the same. A warp-step reads 96 16-byte rows and writes 16
// times at n = 12, m = 4 (~900 scalar accesses before); chip_smoke.py phase
// 0 logs the LDS/STS/FFMA counts of each instance's SASS. A block holds
// 128 threads (8 or 4 scenarios), 12.8 KB of shared memory at (12, 4).
// Measured (PERF.md, section 6): 184 -> 71 us at N = 4096, T = 30; the step is
// now 655 instructions a warp, 406 of them FFMA, against a bound of 18 us.
//
// The loops run to compile-time bounds NB >= n, MB >= m (one instance per
// bucket: NB in {4, 8, 12, 16}, MB in {1, 2, 4, 8}) over zero-padded
// matrices, with no per-element guard: a guard on a runtime n splits every
// unrolled loop into basic blocks of one load and one FMA, which serialises
// the shared-memory latency (measured: a first version so written took 19k
// cycles per warp-step, 0.41 ms at N = 4096, T = 30). The padding is exact:
// A, B, Q, QF are 0 and R is the identity outside (n, m), which keeps the
// padded rows of P and K at 0 and the padded pivots of S at 1.
// Envelope: n <= 16, m <= 8; past it, to n = m = 48, riccati_wide.cu.

#include <cuda_runtime.h>

// The probe (probes/mppi_riccati.py) builds this file with the NPT_STAMP
// macros filled in (the parts: 0 staging, 1 y = PM, 2 z = M'y, 3 S gathered
// and factored, 4 K, 5 P' formed and stored, 6 the warp syncs and the
// write-back); the package builds it with them empty.
#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_WAIT(v)
#define NPT_STAMP_END
#endif

namespace riccati {

constexpr int kMaxN = 16;
constexpr int kMaxM = 8;
constexpr int kThreads = 128;

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The layout of a bucket: lanes per scenario, scenarios per block, and the
// offsets (floats) in a scenario's slice of shared memory, whose size is
// 16 mod 32 so that the two scenarios of a warp sit 16 banks apart.
template <int NB, int MB>
struct Layout {
  static constexpr int NC = NB + MB;            // columns of M = [A | B]
  static constexpr int G = NC <= 16 ? 16 : 32;  // lanes per scenario
  static constexpr int kScen = kThreads / G;    // scenarios per block
  static constexpr int ldM = round4(NC), ldW = round4(MB);
  static constexpr int offM = NB * NB;          // P (NB, NB) at 0
  static constexpr int offW = offM + NB * ldM;  // M (NB, ldM), then W (NB, ldW)
  static constexpr int used = offW + NB * ldW;
  static constexpr int slice = (used + 15) / 32 * 32 + 16;
};

// Row `src` (W floats, 16-byte aligned, W % 4 == 0) of a matrix in shared
// memory into registers, as 16-byte loads.
template <int W>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[W]) {
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
__device__ __forceinline__ void store_row(float* dst, const float (&src)[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
}

// One block a multiprocessor in the bound: without it ptxas trades small
// spills for occupancy (ilqr_backward.cu); (12, 4) fits 128 registers, four
// blocks a multiprocessor, one wave at N = 4096.
template <int NB, int MB>
__global__ void __launch_bounds__(kThreads, 1)
    riccati_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                   const float* __restrict__ Q, const float* __restrict__ R,
                   const float* __restrict__ QF, float* __restrict__ Ks,
                   float* __restrict__ P0, int N, int n, int m, int T) {
  using L = Layout<NB, MB>;
  constexpr int NC = L::NC, G = L::G, ldM = L::ldM, ldW = L::ldW;
  __shared__ __align__(16) float scen[L::kScen * L::slice];
  NPT_STAMP_BEGIN;

  const int g = threadIdx.x / G, c = threadIdx.x % G;
  const int s_raw = blockIdx.x * L::kScen + g;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;  // a ragged tail recomputes a real scenario, stores nothing
  float* const P = scen + g * L::slice;  // (NB, NB), symmetric after the first step
  float* const M = P + L::offM;          // (NB, ldM) [A | B]
  float* const W = P + L::offW;          // (NB, ldW) row r = (B'PA)[:, r]

  // Stage the zero-padded [A | B] and P = QF' (the first step reads P by
  // rows as columns: its transpose gives QF A, as the plain version).
  const float* Ag = As + static_cast<size_t>(s) * n * n;
  const float* Bg = Bs + static_cast<size_t>(s) * n * m;
  for (int e = c; e < NB * ldM; e += G) {
    const int r = e / ldM, k = e % ldM;
    float v = 0.0f;
    if (r < n && k < n) v = Ag[r * n + k];
    else if (r < n && k >= NB && k - NB < m) v = Bg[r * m + (k - NB)];
    M[e] = v;
  }
  for (int e = c; e < NB * NB; e += G) {
    const int r = e / NB, k = e % NB;
    P[e] = (r < n && k < n) ? QF[k * n + r] : 0.0f;
  }
  for (int e = c; e < NB * ldW; e += G) W[e] = 0.0f;
  // loop invariants in registers: column c of Q (lanes c < NB) or column
  // c - NB of R (the lanes that hold S's columns; the identity past m)
  constexpr int NQ = NB > MB ? NB : MB;
  float qc[NQ];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    const int b = c - NB;
    qc[r] = c < NB ? ((c < n && r < n) ? Q[r * n + c] : 0.0f)
                   : (r >= MB ? 0.0f : (r < m && b < m) ? R[r * m + b] : (r == b ? 1.0f : 0.0f));
  }
  __syncwarp();  // the scenario's group lies inside one warp
  float mc[NB];  // column c of M
#pragma unroll
  for (int j = 0; j < NB; ++j) mc[j] = c < NC ? M[j * ldM + c] : 0.0f;
  NPT_WAIT(mc[0] + qc[0]);
  NPT_STAMP(0);

  for (int t = 0; t < T; ++t) {
    // 1. y = P M[:, c], from the rows of P
    float y[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) y[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float prow[NB];
      load_row<NB>(P + j * NB, prow);
#pragma unroll
      for (int r = 0; r < NB; ++r) y[r] = fmaf(prow[r], mc[j], y[r]);
    }
    NPT_WAIT(y[NB - 1]);
    NPT_STAMP(1);

    // 2. z = M' y, from the rows of M
    float z[NC];
#pragma unroll
    for (int r = 0; r < NC; ++r) z[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float mrow[ldM];
      load_row<ldM>(M + j * ldM, mrow);
#pragma unroll
      for (int r = 0; r < NC; ++r) z[r] = fmaf(mrow[r], y[j], z[r]);
    }
    NPT_WAIT(z[NC - 1]);
    NPT_STAMP(2);

    // 3. W row c = (B'PA)[:, c]; S = R + B'PB gathered and factored
    if (c < NB) {
      float wr[ldW];
#pragma unroll
      for (int a = 0; a < ldW; ++a) wr[a] = a < MB ? z[NB + a] : 0.0f;
      store_row<ldW>(W + c * ldW, wr);
    }
    float Lf[MB][MB], dinv[MB], sc[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) sc[a] = z[NB + a] + qc[a];  // lane NB + b: S[:, b]
#pragma unroll
    for (int a = 0; a < MB; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b) Lf[a][b] = __shfl_sync(0xffffffffu, sc[a], NB + b, G);
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      float acc = Lf[k][k];
#pragma unroll
      for (int q = 0; q < k; ++q) acc -= Lf[k][q] * Lf[k][q];
      dinv[k] = rsqrtf(acc);
      Lf[k][k] = acc * dinv[k];
#pragma unroll
      for (int a = k + 1; a < MB; ++a) {
        float v = Lf[a][k];
#pragma unroll
        for (int q = 0; q < k; ++q) v -= Lf[a][q] * Lf[k][q];
        Lf[a][k] = v * dinv[k];
      }
    }
    NPT_WAIT(Lf[MB - 1][MB - 1]);
    NPT_STAMP(3);

    // 4. column c of K = S^{-1} (B'PA)[:, c]
    float kc[MB];
    if (c < NB) {
#pragma unroll
      for (int a = 0; a < MB; ++a) {  // forward: L y = B'PA[:, c]
        float v = z[NB + a];
#pragma unroll
        for (int q = 0; q < a; ++q) v -= Lf[a][q] * kc[q];
        kc[a] = v * dinv[a];
      }
#pragma unroll
      for (int a = MB - 1; a >= 0; --a) {  // backward: L' k = y
        float v = kc[a];
#pragma unroll
        for (int q = a + 1; q < MB; ++q) v -= Lf[q][a] * kc[q];
        kc[a] = v * dinv[a];
      }
      if (live && c < n) {
        float* Kout = Ks + (static_cast<size_t>(s) * T + (T - 1 - t)) * m * n + c;
#pragma unroll
        for (int a = 0; a < MB; ++a)
          if (a < m) Kout[static_cast<size_t>(a) * n] = kc[a];
      }
    }
    NPT_STAMP(4);
    __syncwarp();  // W is complete, and every read of P this step is done
    NPT_STAMP(6);

    // 5. column c of P' = Q + A'PA - (B'PA)'K, stored as row c, then its
    // entries above the diagonal into column c
    float v[NB];
    if (c < NB) {
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        float wr[ldW];
        load_row<ldW>(W + r * ldW, wr);
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < MB; ++a) acc2 = fmaf(wr[a], kc[a], acc2);
        v[r] = z[r] - acc2 + qc[r];
      }
      store_row<NB>(P + c * NB, v);
    }
    NPT_STAMP(5);
    __syncwarp();
    NPT_STAMP(6);
    if (c < NB) {
#pragma unroll
      for (int r = 0; r < NB; ++r)
        if (r < c) P[r * NB + c] = v[r];
    }
    NPT_STAMP(5);
    __syncwarp();  // P' is complete before the next step reads it
    NPT_STAMP(6);
  }

  if (live && c < n) {  // row c of P0 from column c of P (QF itself when T = 0)
    float* out = P0 + static_cast<size_t>(s) * n * n + c * n;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) out[j] = P[j * NB + c];
  }
  NPT_STAMP(6);
  NPT_STAMP_END;
}

template <int NB, int MB>
cudaError_t launch(const float* As, const float* Bs, const float* Q, const float* R,
                   const float* QF, float* Ks, float* P0, int N, int n, int m, int T,
                   cudaStream_t stream) {
  constexpr int kScen = Layout<NB, MB>::kScen;
  riccati_kernel<NB, MB><<<(N + kScen - 1) / kScen, kThreads, 0, stream>>>(
      As, Bs, Q, R, QF, Ks, P0, N, n, m, T);
  return cudaGetLastError();
}

// The smallest bucket that holds n (m).
inline int bucket_n(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : 16; }
inline int bucket_m(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

}  // namespace riccati

// Ks (N, T, m, n) and P0 (N, n, n) from As (N, n, n), Bs (N, n, m) and the
// shared Q (n, n), R (m, m), QF (n, n), all fp32, row-major contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int npt_riccati_fused(const float* As, const float* Bs, const float* Q,
                                 const float* R, const float* QF, float* Ks, float* P0,
                                 int N, int n, int m, int T, void* stream) {
  using namespace riccati;
  if (N < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bucket_n(n) * 16 + bucket_m(m)) {
#define NPT_CASE(NB, MB) \
  case NB * 16 + MB:     \
    return static_cast<int>(launch<NB, MB>(As, Bs, Q, R, QF, Ks, P0, N, n, m, T, st));
#define NPT_CASES_M(NB) NPT_CASE(NB, 1) NPT_CASE(NB, 2) NPT_CASE(NB, 4) NPT_CASE(NB, 8)
    NPT_CASES_M(4) NPT_CASES_M(8) NPT_CASES_M(12) NPT_CASES_M(16)
#undef NPT_CASES_M
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
