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
// Design. A scenario's working set (A, B, P, PA, PB, K, S: ~600 floats at
// n = 12, m = 4) is far over a thread's 255 registers, and one scenario per
// thread would give 128 warps for 132 SMs at N = 4096. So each scenario gets
// a group of kGroup = 16 lanes (half a warp; n <= 16) and lane i owns row i:
// it keeps row i of P in registers for the whole loop and computes row i of
// PA, PB and P' and column i of K. What a row needs from other rows goes
// through the scenario's slice of shared memory (A, B, PA, PB, K', P'); the
// group is inside one warp, so __syncwarp orders it. The m x m Cholesky of S
// runs redundantly in every lane, in registers. Matrices with a lane-indexed
// row (A, PA, P', Q) have an odd row stride (kLd = 17) and a lane-indexed
// column is contiguous, so the 16 lanes hit 16 distinct banks; the two groups
// of a warp sit 16 banks apart. Q and R are loaded once per block and the
// whole T loop runs in the kernel. A block holds kScen = 8 scenarios
// (128 threads, 41 KB of static shared memory): 512 blocks at N = 4096, four
// resident per SM, so one wave of 16 warps per SM.
//
// The loops run to compile-time bounds NB >= n, MB >= m (one instance per
// bucket: NB in {4, 8, 12, 16}, MB in {1, 2, 4, 8}) over zero-padded
// matrices, with no per-element guard: a guard on a runtime n splits every
// unrolled loop into basic blocks of one load and one FMA, which serialises
// the shared-memory latency (measured: a first version so written took 19k
// cycles per warp-step, 0.41 ms at N = 4096, T = 30). The padding is exact:
// A, B, Q, QF are 0 and R is the identity outside (n, m), which keeps the
// padded rows of P and K at 0 and the padded pivots of S at 1.
//
// What bounds it. ~10k FLOP per scenario-step at n = 12, m = 4, each FMA fed
// by a shared-memory load, in chains of dependent steps: shared-memory
// latency and issue, not device memory (As, Bs in once, Ks and P0 out once).
// Envelope: n <= 16, m <= 8.

#include <cuda_runtime.h>

namespace riccati {

constexpr int kMaxN = 16;
constexpr int kMaxM = 8;
constexpr int kGroup = 16;  // lanes per scenario (>= kMaxN)
constexpr int kScen = 8;    // scenarios per block
constexpr int kThreads = kGroup * kScen;
constexpr int kLd = 17;     // row stride of the n x n matrices in shared memory
constexpr int kLdm = 9;     // row stride of the n x m matrices

// Offsets in a scenario's slice of shared memory.
constexpr int kOffA = 0;
constexpr int kOffPA = kOffA + kMaxN * kLd;
constexpr int kOffPn = kOffPA + kMaxN * kLd;
constexpr int kOffB = kOffPn + kMaxN * kLd;
constexpr int kOffPB = kOffB + kMaxN * kLdm;
constexpr int kOffKt = kOffPB + kMaxN * kLdm;
// 1248 floats, padded to 16 mod 32 so the two groups of a warp use disjoint banks
constexpr int kScenFloats = kOffKt + kMaxN * kLdm + 16;
static_assert(kScenFloats % 32 == 16, "scenario slices must sit 16 banks apart");

template <int NB, int MB>
__global__ void __launch_bounds__(kThreads)
    riccati_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                   const float* __restrict__ Q, const float* __restrict__ R,
                   const float* __restrict__ QF, float* __restrict__ Ks,
                   float* __restrict__ P0, int N, int n, int m, int T) {
  __shared__ float q_s[kMaxN * kLd];
  __shared__ float r_s[kMaxM * kMaxM];
  __shared__ float scen[kScen * kScenFloats];

  const int g = threadIdx.x / kGroup, i = threadIdx.x % kGroup;
  const int s_raw = blockIdx.x * kScen + g;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;  // a ragged tail recomputes a real scenario, stores nothing
  float* const A = scen + g * kScenFloats + kOffA;    // (NB, NB), ld kLd
  float* const PA = scen + g * kScenFloats + kOffPA;  // (NB, NB), ld kLd
  float* const Pn = scen + g * kScenFloats + kOffPn;  // (NB, NB), ld kLd
  float* const B = scen + g * kScenFloats + kOffB;    // (NB, MB), ld kLdm
  float* const PB = scen + g * kScenFloats + kOffPB;  // (NB, MB), ld kLdm
  float* const Kt = scen + g * kScenFloats + kOffKt;  // K' (NB, MB), ld kLdm

  // Stage the zero-padded matrices (R padded with the identity).
  for (int e = threadIdx.x; e < NB * NB; e += kThreads) {
    const int r = e / NB, c = e % NB;
    q_s[r * kLd + c] = (r < n && c < n) ? Q[r * n + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < MB * MB; e += kThreads) {
    const int r = e / MB, c = e % MB;
    r_s[r * MB + c] = (r < m && c < m) ? R[r * m + c] : (r == c ? 1.0f : 0.0f);
  }
  const float* Ag = As + static_cast<size_t>(s) * n * n;
  const float* Bg = Bs + static_cast<size_t>(s) * n * m;
  for (int e = i; e < NB * NB; e += kGroup) {
    const int r = e / NB, c = e % NB;
    A[r * kLd + c] = (r < n && c < n) ? Ag[r * n + c] : 0.0f;
  }
  for (int e = i; e < NB * MB; e += kGroup) {
    const int r = e / MB, c = e % MB;
    B[r * kLdm + c] = (r < n && c < m) ? Bg[r * m + c] : 0.0f;
  }
  __syncthreads();

  const bool row = i < NB;  // lanes past NB hold no row (NB < kGroup)
  float p[NB];              // row i of P
#pragma unroll
  for (int j = 0; j < NB; ++j) p[j] = (i < n && j < n) ? QF[i * n + j] : 0.0f;

  for (int t = 0; t < T; ++t) {
    // Row i of PA = P A and of PB = P B.
    if (row) {
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(p[j], A[j * kLd + k], acc);
        PA[i * kLd + k] = acc;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(p[j], B[j * kLdm + a], acc);
        PB[i * kLdm + a] = acc;
      }
    }
    __syncwarp();

    // S = R + B'(PB), lower triangle, and its Cholesky factor, in every lane.
    float L[MB][MB], dinv[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(B[j * kLdm + a], PB[j * kLdm + b], acc);
        L[a][b] = acc + r_s[a * MB + b];
      }
    }
#pragma unroll
    for (int c = 0; c < MB; ++c) {
      float acc = L[c][c];
#pragma unroll
      for (int k = 0; k < c; ++k) acc -= L[c][k] * L[c][k];
      dinv[c] = rsqrtf(acc);
      L[c][c] = acc * dinv[c];
#pragma unroll
      for (int a = c + 1; a < MB; ++a) {
        float v = L[a][c];
#pragma unroll
        for (int k = 0; k < c; ++k) v -= L[a][k] * L[c][k];
        L[a][c] = v * dinv[c];
      }
    }

    // Column i of K = S^{-1} (B'PA)[:, i], with (B'PA)[:, i] = B' PA[:, i].
    float btpa[MB];
    if (row) {
      float y[MB];
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(B[j * kLdm + a], PA[j * kLd + i], acc);
        btpa[a] = acc;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {  // forward: L y = btpa
        float v = btpa[a];
#pragma unroll
        for (int k = 0; k < a; ++k) v -= L[a][k] * y[k];
        y[a] = v * dinv[a];
      }
#pragma unroll
      for (int a = MB - 1; a >= 0; --a) {  // backward: L' k = y
        float v = y[a];
#pragma unroll
        for (int k = a + 1; k < MB; ++k) v -= L[k][a] * y[k];
        y[a] = v * dinv[a];
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) Kt[i * kLdm + a] = y[a];
      if (live && i < n) {
        float* Kout = Ks + (static_cast<size_t>(s) * T + (T - 1 - t)) * m * n + i;
#pragma unroll
        for (int a = 0; a < MB; ++a)
          if (a < m) Kout[static_cast<size_t>(a) * n] = y[a];
      }
    }
    __syncwarp();

    // Row i of P' on and above the diagonal, mirrored below it.
    if (row) {
      for (int k = i; k < NB; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(A[j * kLd + i], PA[j * kLd + k], acc);
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < MB; ++a) acc2 = fmaf(btpa[a], Kt[k * kLdm + a], acc2);
        const float v = acc - acc2 + q_s[i * kLd + k];
        Pn[i * kLd + k] = v;
        Pn[k * kLd + i] = v;
      }
    }
    __syncwarp();
    if (row) {
#pragma unroll
      for (int j = 0; j < NB; ++j) p[j] = Pn[i * kLd + j];
    }
    __syncwarp();  // every read of PA, Kt and Pn is done before the next step writes them
  }

  if (live && i < n) {
    float* out = P0 + static_cast<size_t>(s) * n * n + i * n;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) out[j] = p[j];
  }
}

template <int NB, int MB>
cudaError_t launch(const float* As, const float* Bs, const float* Q, const float* R,
                   const float* QF, float* Ks, float* P0, int N, int n, int m, int T,
                   cudaStream_t stream) {
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
