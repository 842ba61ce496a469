// Fused whole-solve batched MPPI past the narrow K13's envelope: K13 for
// K > 1024 samples or T*m > 1024 nominal entries (csrc/mppi.cu takes
// K <= 1024 and T*m <= 1024 and stays as it is there).
//
// Replaces the TPU kernel numpower_tpu/kernels/mppi.py mppi_pallas
// (_mppi_kernel) at the sizes the narrow K13 does not take, in its order of
// operations, as csrc/mppi.cu does. Per round, for sample k:
//     u_t = clip(u_nom_t + eps_t,k)                       (the candidate)
//     S_k = sum_t c(x_t, u_t) + c_T(x_T) + lam sum_t sum_a (u - u_nom) (sig_a^-2 u_nom)
//     x_{t+1} = f(x_t, u_t)
//     w_k = exp(-(S_k - min S) / lam) / sum,   ess = 1 / sum w^2
//     u_nom <- clip(u_nom + sum_k w_k (u_k - u_nom))
// with the quadratic stage and terminal costs summed as csrc/mppi.cu sums
// them. Every product and sum is one IEEE operation (plants.cuh), none
// contracted into an FMA, and every reduction runs in a fixed order (a
// thread's samples in sample order, then a shuffle tree, then the warps in
// warp order), so two runs give the same bits.
//
// What bounds it on the H100: the perturbations eps, iters*T*m*N*K floats,
// are read twice a round (by the rollout and by the update: a round's
// slice, T*m*N*K floats, is 168 MB at N = 256, K = 4096, T = 40, far past
// the 50 MB L2), 2.7 GB over 8 rounds, ~0.8 ms of HBM time; against that the
// rollout's fp32 instructions, ~99 a step for the pendulum (its accurate
// sinf alone is ~22 of them, csrc/mppi.cu's note), 256 * 4096 * 40 * 8 steps
// a call, ~1.1 ms of the card's issue rate. So the kernel is bound by the
// rollout's instructions and the second read of eps about equally; the
// bound the chip_smoke.py line states counts eps once.
//
// Design. One block per scenario walks its K samples in tiles of
// threads * SPT samples (SPT = 1 up to K = 256, 2 up to 512, else 4), in
// sample order:
//  - A thread rolls out its SPT samples of the tile from x0, their state,
//    candidate and S in registers, reading each step's eps straight from
//    device memory (a row is K contiguous floats, so a warp's lanes read
//    128 contiguous bytes), one step ahead of the step it computes. Each S
//    goes into the block's row of K floats: in shared memory where 4 K
//    bytes fit kRowBudget (K <= 16384), else the scenario's row of an
//    (N, K) scratch in device memory that the wrapper allocates.
//  - The softmax's min, sum and sum of squares reduce over that row (a
//    block reduction each, one barrier each); the weights replace S in it.
//  - The update is one product per scenario: a warp owns entries of the
//    nominal, four at a time, its lanes run over the K samples (w from the
//    row, eps read again from device memory, coalesced), one shuffle tree
//    per entry.
//  - The nominal (T*m floats) stays in shared memory: T*m <= kMaxTM (32768,
//    128 KB), so that it and a row of kRowBudget fit the 227 KB a block may
//    have. The JAX kernel's own envelope is its eps block (iters*T*m, 8, K)
//    in VMEM (numpower_tpu/kernels/mppi.py:151): 32 KiB a nominal entry at
//    K = 128 and 8 rounds, so even all 128 MiB of a TPU v5e's VMEM would
//    hold T*m <= 4096 there; the port's limit reaches 8 times past that, at
//    any K and any number of rounds.
//  - Q, R, QF, goal, sigma^-2 and the plant parameters come by value in the
//    kernel's parameters, as in csrc/mppi.cu.
// One block a scenario leaves most of the card idle at small N (16 blocks
// at N = 16); a cluster of blocks a scenario is later work.
// The host chooses the plan (threads, SPT, the row in shared memory;
// kernels/mppi.py wide_plan) and this file checks it.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "plants.cuh"

namespace mppi_wide {

constexpr int kMaxThreads = 256;           // kernels/mppi.py WIDE_THREADS
constexpr int kMaxTM = 32768;              // kernels/mppi.py WIDE_MAX_TM
constexpr size_t kRowBudget = 64 * 1024;   // kernels/mppi.py WIDE_ROW_BUDGET
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kRed = 3 * 32;               // the three reductions' warp partials

// The cost and the plant, by value (the kernel's parameter space).
template <int n, int m>
struct Consts {
  float par[plants::kMaxParams];
  float Q[n * n], R[m * m], QF[n * n], goal[n], isig[m];
};

struct Args {
  const float *x0s, *eps, *us0;
  float *us, *ess, *scratch;
  int N, K, T, iters;
  float lam, inv_lam;
  int clip;
  float lo, hi;
  int row_smem;  // the row of S (then w) in shared memory; else in scratch (N, K)
};

struct Sum {
  __device__ float operator()(float a, float b) const { return plants::add(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

__device__ __forceinline__ float clipu(float u, const Args& a) {
  return a.clip ? fminf(fmaxf(u, a.lo), a.hi) : u;
}

// The value of v reduced over the block, the same on every thread: a
// shuffle tree per warp, the warps' results combined in warp order. `red`
// (32 floats) belongs to this reduction alone, so one barrier does.
template <class Op>
__device__ float block_reduce(float v, float* red, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = op(r, red[w]);
  return r;
}

// Floats of shared memory: the nominal (padded to 4), the reductions'
// partials and, where it fits, the row of K floats.
inline size_t smem_floats(int TM, int K, int row_smem) {
  return static_cast<size_t>((TM + 3) / 4 * 4) + kRed + (row_smem ? static_cast<size_t>(K) : 0);
}

template <int P, int SPT>
__global__ void __launch_bounds__(kMaxThreads, 2)
    mppi_wide_kernel(const Consts<plants::Plant<P>::n, plants::Plant<P>::m> cs, const Args a) {
  using F = plants::Plant<P>;
  using plants::add;
  using plants::mul;
  using plants::sub;
  constexpr int n = F::n, m = F::m;
  constexpr int kE = 4;  // entries of the nominal a warp sums at once
  extern __shared__ __align__(16) float smem[];
  const int TM = a.T * m, nt = blockDim.x, nw = nt >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s = blockIdx.x;
  float* const u_nom = smem;                       // (T*m)
  float* const red = u_nom + (TM + 3) / 4 * 4;     // (3, 32)
  float* const row = a.row_smem ? red + kRed : a.scratch + static_cast<size_t>(s) * a.K;

  for (int e = tid; e < TM; e += nt) u_nom[e] = a.us0[e];
  float par[plants::kMaxParams], x0[n];
#pragma unroll
  for (int i = 0; i < plants::kMaxParams; ++i) par[i] = cs.par[i];
#pragma unroll
  for (int j = 0; j < n; ++j) x0[j] = a.x0s[static_cast<size_t>(s) * n + j];
  __syncthreads();  // the nominal is in place

  const size_t NK = static_cast<size_t>(a.N) * a.K;
  const int tile = SPT * nt, ntiles = (a.K + tile - 1) / tile;
  for (int it = 0; it < a.iters; ++it) {
    // row r = (it T + t) m + b of eps, this scenario's K floats at + r NK
    const float* const eps_it = a.eps + static_cast<size_t>(it) * TM * NK +
                                static_cast<size_t>(s) * a.K;

    // -- rollout of every candidate, a tile at a time: stage costs, terminal
    // cost, coupling; S into the row --
    for (int tl = 0; tl < ntiles; ++tl) {
      const int k0 = tl * tile + tid;  // this thread's samples: k0 + j * nt
      bool live[SPT];
      float x[SPT][n], S[SPT], couple[SPT], ev[SPT][m];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        live[j] = k0 + j * nt < a.K;
#pragma unroll
        for (int i = 0; i < n; ++i) x[j][i] = x0[i];
        S[j] = 0.0f;
        couple[j] = 0.0f;
      }
      const float* ep = eps_it + k0;  // step t's rows at ep + b NK
#pragma unroll
      for (int b = 0; b < m; ++b)
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          ev[j][b] = live[j] ? __ldg(ep + b * NK + j * nt) : 0.0f;
      for (int t = 0; t < a.T; ++t) {
        // the next step's perturbations, in flight during this step
        const float* const nep = ep + m * NK;
        const bool more = t + 1 < a.T;
        float nx[SPT][m];
#pragma unroll
        for (int b = 0; b < m; ++b)
#pragma unroll
          for (int j = 0; j < SPT; ++j)
            nx[j][b] = more && live[j] ? __ldg(nep + b * NK + j * nt) : 0.0f;
        float un[m], cw[m];
#pragma unroll
        for (int b = 0; b < m; ++b) {
          un[b] = u_nom[t * m + b];
          cw[b] = mul(cs.isig[b], un[b]);
        }
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          float u[m], dx[n], xn[n];
#pragma unroll
          for (int b = 0; b < m; ++b) u[b] = clipu(add(un[b], ev[j][b]), a);
#pragma unroll
          for (int i = 0; i < n; ++i) dx[i] = sub(x[j][i], cs.goal[i]);
          float cst = 0.0f;
#pragma unroll
          for (int i = 0; i < n; ++i)
#pragma unroll
            for (int k = 0; k < n; ++k) cst = add(cst, mul(mul(cs.Q[i * n + k], dx[i]), dx[k]));
#pragma unroll
          for (int i = 0; i < m; ++i)
#pragma unroll
            for (int k = 0; k < m; ++k) cst = add(cst, mul(mul(cs.R[i * m + k], u[i]), u[k]));
          S[j] = add(S[j], cst);
#pragma unroll
          for (int b = 0; b < m; ++b) couple[j] = add(couple[j], mul(sub(u[b], un[b]), cw[b]));
          F::step(x[j], u, par, xn);
#pragma unroll
          for (int i = 0; i < n; ++i) x[j][i] = xn[i];
        }
#pragma unroll
        for (int j = 0; j < SPT; ++j)
#pragma unroll
          for (int b = 0; b < m; ++b) ev[j][b] = nx[j][b];
        ep = nep;
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        float cst = 0.0f;
#pragma unroll
        for (int i = 0; i < n; ++i)
#pragma unroll
          for (int k = 0; k < n; ++k)
            cst = add(cst, mul(mul(cs.QF[i * n + k], sub(x[j][i], cs.goal[i])),
                               sub(x[j][k], cs.goal[k])));
        S[j] = add(add(S[j], cst), mul(a.lam, couple[j]));
        if (live[j]) row[k0 + j * nt] = S[j];
      }
    }
    __syncthreads();  // the row holds every sample's S

    // -- softmax weights over the samples, and the ESS: a thread's samples
    // tid, tid + nt, ... in order, then the block --
    float Sl = CUDART_INF_F;
    for (int k = tid; k < a.K; k += nt) Sl = fminf(Sl, row[k]);
    const float Smin = block_reduce(Sl, red, Min());
    float ws = 0.0f;
    for (int k = tid; k < a.K; k += nt) {
      const float w = expf(mul(-sub(row[k], Smin), a.inv_lam));
      row[k] = w;
      ws = add(ws, w);
    }
    const float tot = block_reduce(ws, red + 32, Sum());
    float sq = 0.0f;
    for (int k = tid; k < a.K; k += nt) {
      const float w = plants::dvd(row[k], tot);
      row[k] = w;
      sq = add(sq, mul(w, w));
    }
    const float ss = block_reduce(sq, red + 64, Sum());  // its barrier also publishes the row
    if (tid == 0) a.ess[static_cast<size_t>(s) * a.iters + it] = plants::dvd(1.0f, ss);

    // -- the update: sum_k w_k (cand_k - u_nom), a warp an entry, kE entries
    // a pass (eb, eb + nw, ...; eb again past T*m), lane i over samples
    // i, i + 32, ... in order --
    for (int eb = warp; eb < TM; eb += kE * nw) {
      int ee[kE];
      const float* rp[kE];
      float un[kE], v[kE];
#pragma unroll
      for (int q = 0; q < kE; ++q) {
        ee[q] = eb + q * nw < TM ? eb + q * nw : eb;
        rp[q] = eps_it + static_cast<size_t>(ee[q]) * NK;
        un[q] = u_nom[ee[q]];
        v[q] = 0.0f;
      }
#pragma unroll 4
      for (int k = lane; k < a.K; k += 32) {
        const float wk = row[k];
#pragma unroll
        for (int q = 0; q < kE; ++q)
          v[q] = add(v[q], mul(wk, sub(clipu(add(un[q], __ldg(rp[q] + k)), a), un[q])));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < kE; ++q) v[q] = add(v[q], __shfl_xor_sync(0xffffffffu, v[q], o));
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kE; ++q)
          if (q == 0 || ee[q] != eb) u_nom[ee[q]] = clipu(add(un[q], v[q]), a);
      }
    }
    __syncthreads();  // the new nominal is in place; the row is free for the next round
  }
  for (int r = tid; r < TM; r += nt) a.us[static_cast<size_t>(s) * TM + r] = u_nom[r];
}

// One bit per device for each instance (plant, SPT 1/2/4) that has been
// allowed the largest dynamic shared memory (internal linkage, as in
// csrc/mppi.cu).
namespace {
unsigned smem_allowed[plants::kNumPlants][3];
}  // namespace

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 32 || (done >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax));
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

template <int P, int SPT>
int launch(const float* consts, const float* params, const Args& a, int threads,
           cudaStream_t stream) {
  constexpr int n = plants::Plant<P>::n, m = plants::Plant<P>::m;
  Consts<n, m> cs;
  for (int i = 0; i < plants::kMaxParams; ++i) cs.par[i] = params[i];
  const float* c = consts;
  for (int i = 0; i < n * n; ++i) cs.Q[i] = *c++;
  for (int i = 0; i < m * m; ++i) cs.R[i] = *c++;
  for (int i = 0; i < n * n; ++i) cs.QF[i] = *c++;
  for (int i = 0; i < n; ++i) cs.goal[i] = *c++;
  for (int i = 0; i < m; ++i) cs.isig[i] = *c++;
  if (static_cast<long long>(a.T) * m > kMaxTM) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(a.T * m, a.K, a.row_smem);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(mppi_wide_kernel<P, SPT>, smem_allowed[P][SPT / 2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_wide_kernel<P, SPT><<<a.N, threads, smem, stream>>>(cs, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mppi_wide

// us (N, T, m) and ess (N, iters), as npt_mppi (csrc/mppi.cu) computes them,
// for any K >= 1 and T*m <= 32768, with the same arguments but the plan:
// scratch, (N, K) fp32 on the device, holds each scenario's row of S and w
// where row_smem == 0 (it may be null otherwise); `threads` a block (a
// multiple of 32, <= 256), each carrying `spt` (1, 2 or 4) samples of a
// tile; row_smem != 0 keeps the row in shared memory, for 4 K <= 64 KB
// (kernels/mppi.py wide_plan). eps may start at any float: it is read a
// float a lane. Returns the CUDA error code of the launch.
extern "C" int npt_mppi_wide(int plant, float p0, float p1, float p2, float p3, float p4,
                             float p5, float p6, float p7, const float* consts, const float* x0s,
                             const float* eps, const float* us0, float* us, float* ess,
                             float* scratch, int N, int K, int T, int iters, float lam,
                             float inv_lam, int clip, float lo, float hi, int threads, int spt,
                             int row_smem, void* stream) {
  using namespace mppi_wide;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (N < 1 || K < 1 || T < 1 || iters < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || consts == nullptr ||
      (row_smem ? static_cast<size_t>(K) * sizeof(float) > kRowBudget : scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float params[plants::kMaxParams] = {p0, p1, p2, p3, p4, p5, p6, p7};
  const Args a{x0s, eps, us0, us, ess, scratch, N, K, T, iters, lam, inv_lam, clip, lo, hi,
               row_smem ? 1 : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plant * 8 + spt) {
#define NPT_CASE(P, SPT) \
  case P * 8 + SPT:      \
    return launch<P, SPT>(consts, params, a, threads, st);
#define NPT_CASES(P) NPT_CASE(P, 1) NPT_CASE(P, 2) NPT_CASE(P, 4)
    NPT_CASES(0) NPT_CASES(1) NPT_CASES(2) NPT_CASES(3)
#undef NPT_CASES
#undef NPT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
