// The iLQR kernels K7 and K8 as they were before their redesign for the
// H100 (the first port of numpower_tpu_torch/csrc/ilqr_backward.cu and
// ilqr_forward.cu: lanes per row, one stage staged ahead, chunked
// write-back), unchanged but for the cycle stamps of probes/stamps.cuh
// at the end of each part of a step.
// probes/ilqr_chain.py builds this file into its own library and times its
// parts beside those of the current kernels. Parts:
//   K7: 0 the wait for the stage and the next stage's issue, 1 W and W2,
//       2 Qu, Quu, its Cholesky factor and k, 3 Qux and K (with their
//       stores), 4 Vx', Vxx' and the exchange of its rows, 5 the prologue;
//   K8: 0 a chunk's staging (issue, wait, barrier), 1 the feedback, 2 the
//       stage cost, 3 the plant, 4 the outputs (shared stores, the chunk's
//       write-back), 5 the prologue and the terminal cost.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "stamps.cuh"
#include "../numpower_tpu_torch/csrc/plants.cuh"

namespace ilqr_bwd {

constexpr int kMaxN = 16;
constexpr int kMaxM = 8;
constexpr int kThreads = 128;

template <int NB, int MB>
struct Layout {
  static constexpr int G = NB <= 4 ? 4 : (NB <= 8 ? 8 : 16);
  static constexpr int kScen = kThreads / G;
  static constexpr int ldn = NB + 1;
  static constexpr int ldm = MB + 1;
  static constexpr int oA = 0;
  static constexpr int oB = oA + NB * ldn;
  static constexpr int oLx = oB + NB * ldm;
  static constexpr int oLu = oLx + NB;
  static constexpr int oLd = oLu + MB;
  static constexpr int kStage = oLd + MB;
  static constexpr int oW = 2 * kStage;
  static constexpr int oW2 = oW + NB * ldn;
  static constexpr int oKt = oW2 + NB * ldm;
  static constexpr int oPn = oKt + NB * ldm;
  static constexpr int oVx = oPn + NB * ldn;
  static constexpr int kScenFloats = oVx + NB;
  static constexpr int kShared = NB * ldn + MB * MB;
  static constexpr size_t smem_bytes() {
    return sizeof(float) * static_cast<size_t>(kShared + kScen * kScenFloats);
  }
};

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
  NPT_STAMP_BEGIN;
  using L = Layout<NB, MB>;
  constexpr int G = L::G, ldn = L::ldn, ldm = L::ldm;
  extern __shared__ __align__(16) float smem[];
  float* const lxx_s = smem;
  float* const luu_s = lxx_s + NB * ldn;
  const int g = threadIdx.x / G, i = threadIdx.x % G;
  const int s_raw = blockIdx.x * L::kScen + g;
  const bool live = s_raw < N;
  const int s = live ? s_raw : N - 1;
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
  const bool row = i < NB;
  float v[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) v[j] = (i < n && j < n) ? lxxT[i * n + j] : 0.0f;
  __syncthreads();

  if (T > 0) copy_stage<NB, MB>(base, As, Bs, lxs, lus, luud, s, T - 1, T, n, m, i);
  __pipeline_commit();
  NPT_STAMP(5);

  for (int t = 0; t < T; ++t) {
    const int stage = T - 1 - t;
    __pipeline_wait_prior(0);
    __syncwarp();
    if (t + 1 < T)
      copy_stage<NB, MB>(base + ((t + 1) & 1) * L::kStage, As, Bs, lxs, lus, luud, s,
                          stage - 1, T, n, m, i);
    __pipeline_commit();
    NPT_STAMP(0);
    const float* const A = base + (t & 1) * L::kStage + L::oA;
    const float* const B = base + (t & 1) * L::kStage + L::oB;
    const float* const lx = base + (t & 1) * L::kStage + L::oLx;
    const float* const lu = base + (t & 1) * L::kStage + L::oLu;
    const float* const ld = base + (t & 1) * L::kStage + L::oLd;

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
    NPT_STAMP(1);

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
    NPT_STAMP(2);

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
    __syncwarp();
    NPT_STAMP(3);

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
    __syncwarp();
    NPT_STAMP(4);
  }
  NPT_STAMP_END;
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

}  // namespace ilqr_bwd

// The probe runs the buckets (4, 1) (the cartpole; the grid has (N + 31) / 32
// blocks of 128 threads), (12, 4) and (16, 8) only. Returns the launch's CUDA
// error code.
extern "C" int npt_ilqr_backward(const float* As, const float* Bs, const float* lxs,
                                 const float* lus, const float* luud, const float* lxx,
                                 const float* luu_reg, const float* lxT, const float* lxxT,
                                 float* ks, float* Ks, int N, int n, int m, int T,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 4 && m == 1)
    return static_cast<int>(ilqr_bwd::launch<4, 1>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT,
                                                   lxxT, ks, Ks, N, n, m, T, st));
  if (n > 8 && n <= 12 && m > 2 && m <= 4)
    return static_cast<int>(ilqr_bwd::launch<12, 4>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT,
                                                    lxxT, ks, Ks, N, n, m, T, st));
  if (n > 12 && n <= 16 && m > 4 && m <= 8)
    return static_cast<int>(ilqr_bwd::launch<16, 8>(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT,
                                                    lxxT, ks, Ks, N, n, m, T, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace ilqr_fwd {

constexpr int kScen = 32;
constexpr int kMaxAlphas = 32;
constexpr int kMaxTc = 16;
constexpr size_t kSmemBudget = 96 * 1024;

struct PlantParams {
  float v[plants::kMaxParams];
};

struct Shape {
  int Tc;
  int in_ld;
  int out_ld;
};

inline int head_floats(int n, int m, int A) { return 2 * n * n + m * m + n + A + plants::kMaxParams; }
inline size_t smem_bytes(int n, int m, int A, const Shape& sh) {
  return sizeof(float) * (static_cast<size_t>(head_floats(n, m, A)) + kScen * sh.in_ld +
                          static_cast<size_t>(A) * kScen * sh.out_ld);
}
inline Shape shape_for(int n, int m, int A, int T) {
  Shape sh{};
  for (int Tc = kMaxTc; Tc >= 1; --Tc) {
    sh.Tc = Tc;
    sh.in_ld = (Tc * (n + 2 * m + m * n)) | 1;
    sh.out_ld = (Tc * (n + m)) | 1;
    if (Tc <= (T > 0 ? T : 1) && smem_bytes(n, m, A, sh) <= kSmemBudget) break;
  }
  return sh;
}

template <int P>
__global__ void __launch_bounds__(kMaxAlphas * kScen)
    ilqr_forward_kernel(PlantParams params, const float* __restrict__ Q,
                        const float* __restrict__ R, const float* __restrict__ QF,
                        const float* __restrict__ goal, const float* __restrict__ alphas,
                        const float* __restrict__ x0s, const float* __restrict__ xs_nom,
                        const float* __restrict__ us_nom, const float* __restrict__ ks,
                        const float* __restrict__ Ks, float* __restrict__ us,
                        float* __restrict__ xs, float* __restrict__ costs, int N, int T, int A,
                        int xs_rows, Shape sh) {
  NPT_STAMP_BEGIN;
  using F = plants::Plant<P>;
  constexpr int n = F::n, m = F::m;
  extern __shared__ __align__(16) float smem[];
  float* const wQ = smem;
  float* const wQF = wQ + n * n;
  float* const wR = wQF + n * n;
  float* const goal_s = wR + m * m;
  float* const alpha_s = goal_s + n;
  float* const par_s = alpha_s + A;
  float* const in_s = par_s + plants::kMaxParams;
  float* const out_s = in_s + kScen * sh.in_ld;
  const int Tc = sh.Tc;
  const int o_u = Tc * n, o_k = Tc * (n + m), o_K = Tc * (n + 2 * m);

  const int lane = threadIdx.x % kScen, a = threadIdx.x / kScen;
  const int s0 = blockIdx.x * kScen;
  const int s = s0 + lane;
  const bool live = s < N;

  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e % n;
    wQ[e] = c < r ? 0.0f : (c == r ? Q[e] : Q[e] * 2.0f);
    wQF[e] = c < r ? 0.0f : (c == r ? QF[e] : QF[e] * 2.0f);
  }
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int r = e / m, c = e % m;
    wR[e] = c < r ? 0.0f : (c == r ? R[e] : R[e] * 2.0f);
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) goal_s[e] = goal[e];
  for (int e = threadIdx.x; e < A; e += blockDim.x) alpha_s[e] = alphas[e];
  for (int e = threadIdx.x; e < plants::kMaxParams; e += blockDim.x) par_s[e] = params.v[e];

  float x[n];
  const size_t out_row = static_cast<size_t>(a) * N + s;
#pragma unroll
  for (int j = 0; j < n; ++j) x[j] = live ? x0s[static_cast<size_t>(s) * n + j] : 0.0f;
  if (live) {
#pragma unroll
    for (int j = 0; j < n; ++j) xs[out_row * (T + 1) * n + j] = x[j];
  }
  float cost = 0.0f;
  NPT_STAMP(5);

  for (int t0 = 0; t0 < T; t0 += Tc) {
    const int steps = min(Tc, T - t0);
    __syncthreads();
    {
      const int per = steps * (n + 2 * m + m * n);
      const int live_scen = min(kScen, N - s0);
      for (int idx = threadIdx.x; idx < live_scen * per; idx += blockDim.x) {
        const int sc = idx / per;
        int e = idx - sc * per;
        const size_t ss = static_cast<size_t>(s0 + sc);
        float* dst = in_s + sc * sh.in_ld;
        const float* src;
        if (e < steps * n) {
          src = xs_nom + (ss * xs_rows + t0) * n + e;
        } else if ((e -= steps * n) < steps * m) {
          src = us_nom + (ss * T + t0) * m + e;
          dst += o_u;
        } else if ((e -= steps * m) < steps * m) {
          src = ks + (ss * T + t0) * m + e;
          dst += o_k;
        } else {
          e -= steps * m;
          src = Ks + (ss * T + t0) * m * n + e;
          dst += o_K;
        }
        __pipeline_memcpy_async(dst + e, src, sizeof(float));
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    NPT_STAMP(0);

    const float alpha = alpha_s[a];
    const float* const my_in = in_s + lane * sh.in_ld;
    float* const my_out = out_s + (a * kScen + lane) * sh.out_ld;
    for (int tt = 0; tt < steps; ++tt) {
      const float* xn = my_in + tt * n;
      const float* un = my_in + o_u + tt * m;
      const float* kk = my_in + o_k + tt * m;
      const float* KK = my_in + o_K + tt * m * n;
      float dx[n], u[m], xnext[n];
#pragma unroll
      for (int j = 0; j < n; ++j) dx[j] = x[j] - xn[j];
#pragma unroll
      for (int b = 0; b < m; ++b) {
        float acc = un[b] + alpha * kk[b];
#pragma unroll
        for (int j = 0; j < n; ++j) acc = acc + KK[b * n + j] * dx[j];
        u[b] = acc;
      }
      NPT_STAMP(1);
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float di = x[i] - goal_s[i];
#pragma unroll
        for (int j = i; j < n; ++j) cost = cost + wQ[i * n + j] * di * (x[j] - goal_s[j]);
      }
#pragma unroll
      for (int i = 0; i < m; ++i)
#pragma unroll
        for (int j = i; j < m; ++j) cost = cost + wR[i * m + j] * u[i] * u[j];
      NPT_STAMP(2);
      F::step(x, u, par_s, xnext);
#pragma unroll
      for (int j = 0; j < n; ++j) x[j] = xnext[j];
      NPT_STAMP(3);
#pragma unroll
      for (int b = 0; b < m; ++b) my_out[tt * m + b] = u[b];
#pragma unroll
      for (int j = 0; j < n; ++j) my_out[steps * m + tt * n + j] = x[j];
      NPT_STAMP(4);
    }
    __syncthreads();

    {
      const int per = steps * (m + n);
      for (int idx = threadIdx.x; idx < A * kScen * per; idx += blockDim.x) {
        const int r = idx / per, e = idx - r * per;
        const int rs = s0 + r % kScen;
        if (rs >= N) continue;
        const size_t row = static_cast<size_t>(r / kScen) * N + rs;
        const float v = out_s[r * sh.out_ld + e];
        if (e < steps * m)
          us[(row * T + t0) * m + e] = v;
        else
          xs[(row * (T + 1) + 1 + t0) * n + (e - steps * m)] = v;
      }
    }
    NPT_STAMP(4);
  }

#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float di = x[i] - goal_s[i];
#pragma unroll
    for (int j = i; j < n; ++j) cost = cost + wQF[i * n + j] * di * (x[j] - goal_s[j]);
  }
  if (live) costs[out_row] = cost;
  NPT_STAMP(5);
  NPT_STAMP_END;
}

template <int P>
int launch(const PlantParams& params, const float* Q, const float* R, const float* QF,
           const float* goal, const float* alphas, const float* x0s, const float* xs_nom,
           const float* us_nom, const float* ks, const float* Ks, float* us, float* xs,
           float* costs, int N, int T, int A, int xs_rows, cudaStream_t stream) {
  constexpr int n = plants::Plant<P>::n, m = plants::Plant<P>::m;
  const Shape sh = shape_for(n, m, A, T);
  const size_t smem = smem_bytes(n, m, A, sh);
  cudaError_t err = cudaFuncSetAttribute(ilqr_forward_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ilqr_forward_kernel<P><<<(N + kScen - 1) / kScen, A * kScen, smem, stream>>>(
      params, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks, us, xs, costs, N, T, A,
      xs_rows, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ilqr_fwd

// The cartpole (plant 0) and the pendulum (plant 1) only. The grid has
// (N + 31) / 32 blocks of 32 A threads.
extern "C" int npt_ilqr_forward(int plant, float p0, float p1, float p2, float p3, float p4,
                                float p5, float p6, float p7, const float* Q, const float* R,
                                const float* QF, const float* goal, const float* alphas,
                                const float* x0s, const float* xs_nom, const float* us_nom,
                                const float* ks, const float* Ks, float* us, float* xs,
                                float* costs, int N, int T, int A, int xs_rows, void* stream) {
  using namespace ilqr_fwd;
  if (N < 1 || T < 0 || A < 1 || A > kMaxAlphas || xs_rows < T)
    return static_cast<int>(cudaErrorInvalidValue);
  const PlantParams params{{p0, p1, p2, p3, p4, p5, p6, p7}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plant == 0)
    return launch<0>(params, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks, us, xs, costs,
                     N, T, A, xs_rows, st);
  if (plant == 1)
    return launch<1>(params, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks, us, xs, costs,
                     N, T, A, xs_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
