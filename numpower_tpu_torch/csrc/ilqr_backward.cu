// Fused batched iLQR backward pass (K7): the LTV + affine Riccati recursion
// with Levenberg regularization, over the whole horizon in one launch.
//
// Replaces the TPU kernel numpower_tpu/kernels/ilqr_backward.py
// ilqr_backward_fused (_ilqr_bwd_kernel, _chol_solve_rows). For each scenario
// s, from Vx = lx_T, Vxx = lxx_T, for stages T-1 .. 0:
//     Qx  = lx + A'Vx          Qu  = lu + B'Vx
//     W   = Vxx A              W2  = Vxx B
//     Qxx = lxx + A'W          Quu = luu_reg + diag(luu_diag) + B'W2     Qux = B'W
//     k   = -Quu^{-1} Qu       K   = -Quu^{-1} Qux     (Cholesky of Quu's lower triangle)
//     Vx' = Qx + Qux'k         Vxx' = Qxx + Qux'K      (upper triangle formed, mirrored)
// with A, B, lx, lu, luu_diag the stage's own (per scenario and per stage)
// and lxx, luu_reg = luu + reg I shared. k and K of each stage are written
// at its forward index, straight into the public (N, T, m) and (N, T, m, n)
// layouts.
//
// Design: K5 (riccati.cu) made time-varying and affine. A group of G lanes
// owns a scenario and lane i owns row i: it keeps row i of Vxx in registers
// for the whole loop and computes row i of W, W2 and Vxx', column i of Qux
// and K, and Vx'[i]. What a row needs from other rows goes through the
// scenario's slice of shared memory; the group lies inside one warp, so
// __syncwarp orders it. The m x m Cholesky of Quu, Qu and k run redundantly
// in every lane, in registers. The loops run to compile-time buckets
// NB >= n (4, 8, 12, 16) and MB >= m (1, 2, 4, 8) over zero-padded matrices,
// with no guard per element (riccati.cu says why): A, B, lx, lu, luu_diag,
// lxx, lxx_T are 0 and luu_reg the identity outside (n, m), which keeps the
// padded rows of Vx, Vxx, k and K at 0 and the padded pivots of Quu at 1.
//
// Streaming. Each stage's A_t, B_t, lx_t, lu_t and luu_diag_t are copied
// from device memory with cp.async into one of two stage buffers while the
// group computes the stage before from the other, so the load latency hides
// behind a step's arithmetic; the whole horizon never sits on chip.
//
// Group width. G = 4 lanes for n <= 4 (the cartpole and pendulum of the iLQR
// configurations), 8 for n <= 8 and 16 above: each lane computes one row, so
// a narrower group leaves no lane idle at small n, and the same scenarios
// take a quarter of the warps of 16-lane groups. At config #3b's N = 256 the
// kernel is a chain of T dependent steps per scenario either way (latency,
// not throughput); at N = 4096 the narrow group keeps ~4 warps per SM where
// 16 lanes would give 16 and make it bound by instruction issue, as K5 is.
//
// What bounds it: the latency of the per-step chain of shared-memory loads
// and FMAs (~n^3 + n^2 m FLOP per step spread over n lanes), not device
// memory (each stage's n^2 + nm + n + 2m floats are read once, k and K
// written once). On the H100 a step of the (4, 1) bucket takes ~2.6 us,
// the same from N = 32 to 4096. Envelope: n <= 16, m <= 8.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace ilqr_bwd {

constexpr int kMaxN = 16;
constexpr int kMaxM = 8;
constexpr int kThreads = 128;

template <int NB, int MB>
struct Layout {
  static constexpr int G = NB <= 4 ? 4 : (NB <= 8 ? 8 : 16);  // lanes per scenario
  static constexpr int kScen = kThreads / G;                  // scenarios per block
  static constexpr int ldn = NB + 1;  // odd row strides: lane-indexed rows hit distinct banks
  static constexpr int ldm = MB + 1;
  // One stage buffer (two per scenario).
  static constexpr int oA = 0;
  static constexpr int oB = oA + NB * ldn;
  static constexpr int oLx = oB + NB * ldm;
  static constexpr int oLu = oLx + NB;
  static constexpr int oLd = oLu + MB;
  static constexpr int kStage = oLd + MB;
  // Working matrices after the two stage buffers.
  static constexpr int oW = 2 * kStage;       // W = Vxx A       (NB, NB) ld ldn
  static constexpr int oW2 = oW + NB * ldn;   // W2 = Vxx B      (NB, MB) ld ldm
  static constexpr int oKt = oW2 + NB * ldm;  // K'              (NB, MB) ld ldm
  static constexpr int oPn = oKt + NB * ldm;  // Vxx'            (NB, NB) ld ldn
  static constexpr int oVx = oPn + NB * ldn;  // Vx              (NB)
  static constexpr int kScenFloats = oVx + NB;
  // Block-wide: lxx (NB, NB) ld ldn and luu_reg (MB, MB), then the scenarios.
  static constexpr int kShared = NB * ldn + MB * MB;
  static constexpr size_t smem_bytes() {
    return sizeof(float) * static_cast<size_t>(kShared + kScen * kScenFloats);
  }
};

// Copy stage `stage` of scenario s into the stage buffer `buf`, real entries
// only (the padding was zeroed once), lane i of G taking every G-th entry of
// the padded (NB, NB) and (NB, MB) blocks: the loops unroll and their
// indices divide by compile-time constants.
template <int NB, int MB>
__device__ __forceinline__ void copy_stage(float* buf, const float* __restrict__ As,
                                           const float* __restrict__ Bs,
                                           const float* __restrict__ lxs,
                                           const float* __restrict__ lus,
                                           const float* __restrict__ luud, int s, int stage,
                                           int T, int n, int m, int i) {
  using L = Layout<NB, MB>;
  const size_t st = static_cast<size_t>(s) * T + stage;
  const float* a = As + st * n * n;
#pragma unroll
  for (int q = 0; q < (NB * NB + L::G - 1) / L::G; ++q) {
    const int e = q * L::G + i, r = e / NB, c = e % NB;
    if (e < NB * NB && r < n && c < n)
      __pipeline_memcpy_async(buf + L::oA + r * L::ldn + c, a + r * n + c, sizeof(float));
  }
  const float* b = Bs + st * n * m;
#pragma unroll
  for (int q = 0; q < (NB * MB + L::G - 1) / L::G; ++q) {
    const int e = q * L::G + i, r = e / MB, c = e % MB;
    if (e < NB * MB && r < n && c < m)
      __pipeline_memcpy_async(buf + L::oB + r * L::ldm + c, b + r * m + c, sizeof(float));
  }
  for (int e = i; e < n; e += L::G)
    __pipeline_memcpy_async(buf + L::oLx + e, lxs + st * n + e, sizeof(float));
  for (int e = i; e < m; e += L::G) {
    __pipeline_memcpy_async(buf + L::oLu + e, lus + st * m + e, sizeof(float));
    if (luud != nullptr)
      __pipeline_memcpy_async(buf + L::oLd + e, luud + st * m + e, sizeof(float));
  }
}

template <int NB, int MB>
__global__ void __launch_bounds__(kThreads)
    ilqr_backward_kernel(const float* __restrict__ As, const float* __restrict__ Bs,
                         const float* __restrict__ lxs, const float* __restrict__ lus,
                         const float* __restrict__ luud, const float* __restrict__ lxx,
                         const float* __restrict__ luu_reg, const float* __restrict__ lxT,
                         const float* __restrict__ lxxT, float* __restrict__ ks,
                         float* __restrict__ Ks, int N, int n, int m, int T) {
  using L = Layout<NB, MB>;
  constexpr int G = L::G, ldn = L::ldn, ldm = L::ldm;
  extern __shared__ __align__(16) float smem[];
  float* const lxx_s = smem;
  float* const luu_s = lxx_s + NB * ldn;
  const int g = threadIdx.x / G, i = threadIdx.x % G;
  const int s_raw = blockIdx.x * L::kScen + g;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;  // a ragged tail recomputes a real scenario, stores nothing
  float* const base = smem + L::kShared + g * L::kScenFloats;
  float* const W = base + L::oW;
  float* const W2 = base + L::oW2;
  float* const Kt = base + L::oKt;
  float* const Pn = base + L::oPn;
  float* const Vx = base + L::oVx;

  for (int e = threadIdx.x; e < NB * NB; e += kThreads) {
    const int r = e / NB, c = e % NB;
    lxx_s[r * ldn + c] = (r < n && c < n) ? lxx[r * n + c] : 0.0f;
  }
  for (int e = threadIdx.x; e < MB * MB; e += kThreads) {
    const int r = e / MB, c = e % MB;
    luu_s[e] = (r < m && c < m) ? luu_reg[r * m + c] : (r == c ? 1.0f : 0.0f);
  }
  for (int e = i; e < 2 * L::kStage; e += G) base[e] = 0.0f;
  for (int e = i; e < NB; e += G) Vx[e] = e < n ? lxT[static_cast<size_t>(s) * n + e] : 0.0f;
  const bool row = i < NB;  // lanes past NB hold no row (NB = 12 in 16-lane groups)
  float v[NB];              // row i of Vxx
#pragma unroll
  for (int j = 0; j < NB; ++j) v[j] = (i < n && j < n) ? lxxT[i * n + j] : 0.0f;
  __syncthreads();  // the zero padding is in place before the copies land

  if (T > 0) copy_stage<NB, MB>(base, As, Bs, lxs, lus, luud, s, T - 1, T, n, m, i);
  __pipeline_commit();

  for (int t = 0; t < T; ++t) {
    const int stage = T - 1 - t;
    __pipeline_wait_prior(0);
    __syncwarp();  // stage `stage` is in buffer t & 1, visible to the whole group
    if (t + 1 < T)
      copy_stage<NB, MB>(base + ((t + 1) & 1) * L::kStage, As, Bs, lxs, lus, luud, s,
                          stage - 1, T, n, m, i);
    __pipeline_commit();
    const float* const A = base + (t & 1) * L::kStage + L::oA;
    const float* const B = base + (t & 1) * L::kStage + L::oB;
    const float* const lx = base + (t & 1) * L::kStage + L::oLx;
    const float* const lu = base + (t & 1) * L::kStage + L::oLu;
    const float* const ld = base + (t & 1) * L::kStage + L::oLd;

    // Row i of W = Vxx A and of W2 = Vxx B.
    if (row) {
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(v[j], A[j * ldn + k], acc);
        W[i * ldn + k] = acc;
      }
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) acc = fmaf(v[j], B[j * ldm + a], acc);
        W2[i * ldm + a] = acc;
      }
    }
    __syncwarp();

    // Qu, the lower triangle of Quu and its Cholesky factor, and k, in every lane.
    float qu[MB], Lf[MB][MB], dinv[MB], kk[MB];
#pragma unroll
    for (int a = 0; a < MB; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) acc = fmaf(B[j * ldm + a], Vx[j], acc);
      qu[a] = lu[a] + acc;
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) q = fmaf(B[j * ldm + a], W2[j * ldm + b], q);
        q += luu_s[a * MB + b];
        if (a == b) q += ld[a];
        Lf[a][b] = q;
      }
    }
#pragma unroll
    for (int c = 0; c < MB; ++c) {
      float acc = Lf[c][c];
#pragma unroll
      for (int k = 0; k < c; ++k) acc -= Lf[c][k] * Lf[c][k];
      dinv[c] = rsqrtf(acc);
      Lf[c][c] = acc * dinv[c];
#pragma unroll
      for (int a = c + 1; a < MB; ++a) {
        float x = Lf[a][c];
#pragma unroll
        for (int k = 0; k < c; ++k) x -= Lf[a][k] * Lf[c][k];
        Lf[a][c] = x * dinv[c];
      }
    }
    // Solves Quu y = rhs in place by forward and backward substitution.
    auto chol_solve = [&](float y[MB]) {
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float x = y[a];
#pragma unroll
        for (int k = 0; k < a; ++k) x -= Lf[a][k] * y[k];
        y[a] = x * dinv[a];
      }
#pragma unroll
      for (int a = MB - 1; a >= 0; --a) {
        float x = y[a];
#pragma unroll
        for (int k = a + 1; k < MB; ++k) x -= Lf[k][a] * y[k];
        y[a] = x * dinv[a];
      }
    };
#pragma unroll
    for (int a = 0; a < MB; ++a) kk[a] = qu[a];
    chol_solve(kk);
#pragma unroll
    for (int a = 0; a < MB; ++a) kk[a] = -kk[a];

    // Lane i: column i of Qux = B'W, Qx[i], and column i of K.
    float qux[MB], qx = 0.0f;
    if (row) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) acc = fmaf(A[j * ldn + i], Vx[j], acc);
      qx = lx[i] + acc;
      float y[MB];
#pragma unroll
      for (int a = 0; a < MB; ++a) {
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) q = fmaf(B[j * ldm + a], W[j * ldn + i], q);
        qux[a] = q;
        y[a] = q;
      }
      chol_solve(y);
#pragma unroll
      for (int a = 0; a < MB; ++a) Kt[i * ldm + a] = -y[a];
      if (live && i < n) {
        float* Kout = Ks + (static_cast<size_t>(s) * T + stage) * m * n + i;
#pragma unroll
        for (int a = 0; a < MB; ++a)
          if (a < m) Kout[static_cast<size_t>(a) * n] = -y[a];
      }
    }
    if (live && i == 0) {
      float* kout = ks + (static_cast<size_t>(s) * T + stage) * m;
#pragma unroll
      for (int a = 0; a < MB; ++a)
        if (a < m) kout[a] = kk[a];
    }
    __syncwarp();  // K' is complete and every read of Vx is done

    // Vx'[i] = Qx[i] + Qux[:, i]'k; row i of Vxx' = Qxx + Qux'K on and above
    // the diagonal, mirrored below it.
    if (row) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < MB; ++a) acc = fmaf(qux[a], kk[a], acc);
      Vx[i] = qx + acc;
      for (int k = i; k < NB; ++k) {
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < NB; ++j) q = fmaf(A[j * ldn + i], W[j * ldn + k], q);
        q += lxx_s[i * ldn + k];
        float r = 0.0f;
#pragma unroll
        for (int a = 0; a < MB; ++a) r = fmaf(qux[a], Kt[k * ldm + a], r);
        const float val = q + r;
        Pn[i * ldn + k] = val;
        Pn[k * ldn + i] = val;
      }
    }
    __syncwarp();
    if (row) {
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = Pn[i * ldn + j];
    }
    __syncwarp();  // every read of W, W2, Kt and Pn is done before the next step writes them
  }
}

template <int NB, int MB>
cudaError_t launch(const float* As, const float* Bs, const float* lxs, const float* lus,
                   const float* luud, const float* lxx, const float* luu_reg, const float* lxT,
                   const float* lxxT, float* ks, float* Ks, int N, int n, int m, int T,
                   cudaStream_t stream) {
  using L = Layout<NB, MB>;
  const size_t smem = L::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(ilqr_backward_kernel<NB, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ilqr_backward_kernel<NB, MB><<<(N + L::kScen - 1) / L::kScen, kThreads, smem, stream>>>(
      As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, T);
  return cudaGetLastError();
}

inline int bucket_n(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 12 ? 12 : 16; }
inline int bucket_m(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

}  // namespace ilqr_bwd

// ks (N, T, m) and Ks (N, T, m, n) from As (N, T, n, n), Bs (N, T, n, m),
// lxs (N, T, n), lus (N, T, m), luud (N, T, m) or null, the shared lxx (n, n)
// and luu_reg = luu + reg I (m, m), lxT (N, n) and lxxT (n, n), all fp32,
// row-major contiguous. Returns the CUDA error code of the launch.
extern "C" int npt_ilqr_backward(const float* As, const float* Bs, const float* lxs,
                                 const float* lus, const float* luud, const float* lxx,
                                 const float* luu_reg, const float* lxT, const float* lxxT,
                                 float* ks, float* Ks, int N, int n, int m, int T,
                                 void* stream) {
  using namespace ilqr_bwd;
  if (N < 1 || n < 1 || n > kMaxN || m < 1 || m > kMaxM || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bucket_n(n) * 16 + bucket_m(m)) {
#define NPT_CASE(NB, MB)                                                                       \
  case NB * 16 + MB:                                                                           \
    return static_cast<int>(launch<NB, MB>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, \
                                           Ks, N, n, m, T, st));
#define NPT_CASES_M(NB) NPT_CASE(NB, 1) NPT_CASE(NB, 2) NPT_CASE(NB, 4) NPT_CASE(NB, 8)
    NPT_CASES_M(4) NPT_CASES_M(8) NPT_CASES_M(12) NPT_CASES_M(16)
#undef NPT_CASES_M
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
