// Fused whole-solve batched MPPI (K13): one launch runs every importance-
// sampling round of every scenario: the T-step rollout of all K samples
// through the plant, the quadratic stage costs, the softmax weights and the
// effective sample size, and the nominal update.
//
// Replaces the TPU kernel numpower_tpu/kernels/mppi.py mppi_pallas
// (_mppi_kernel), in its order of operations. Per round, for sample k:
//     u_t = clip(u_nom_t + eps_t,k)                       (the candidate)
//     S_k = sum_t c(x_t, u_t) + c_T(x_T) + lam sum_t sum_a (u - u_nom) (sig_a^-2 u_nom)
//     x_{t+1} = f(x_t, u_t)
//     w_k = exp(-(S_k - min S) / lam) / sum,   ess = 1 / sum w^2
//     u_nom <- clip(u_nom + sum_k w_k (u_k - u_nom))
// with c(x, u) = sum_ij Q_ij dx_i dx_j + sum_ab R_ab u_a u_b (dx = x - goal)
// and c_T the same with QF, each sum over i, then j, in row-major order, as
// the JAX cost's rows form sums them (its skipped zero entries add exact
// zeros here). Every product and sum is one IEEE operation (plants.cuh), so
// none is contracted into an FMA, as the eager plain version runs them.
// It writes us (N, T, m) and ess (N, iters).
//
// What bounds it on the H100: at the bench's shape (N = 256, K = 256,
// T = 40, 8 rounds) reading eps once is 84 MB, 25 us of HBM time, against
// ~12 us of fp32 operations. The first port took 144 us; its split
// (probes/mppi_riccati.py, PERF.md section 6) was the rollout 42%, the update
// 34% (one shuffle tree per nominal entry in every warp), the staging 17%
// (eps staged by 4-byte copies, twice a round) and the softmax 7%. This
// design takes ~120 us and is bound by the instructions of the rollout's
// step (~99 for the pendulum; its accurate sinf alone is 22% of the kernel,
// the update 11%: probes/mppi_ablation.py), not by eps, whose chunks land
// before the rollout needs them.
//
// Design. One block per scenario; a thread carries SPT samples (1 up to
// K = 256, 2 up to 512, 4 up to 1024), its state, candidate and S in
// registers, so the launch is bound by the threads it uses (<= 256).
//  - Q, R, QF, goal, sigma^-2 and the plant parameters come by value in the
//    kernel's parameters: the cost terms read constant-bank operands, and
//    the step reads the nominal's entries once from shared memory.
//  - eps[r, s, :] is K contiguous floats. Each warp stages its own samples'
//    runs of 32 floats of a chunk of Tc steps (Tc * m rows) into a ring of
//    chunk slots, as 16-byte cp.async pieces where the rows are 16-byte
//    aligned (else a float a lane), and waits for its own copies only: the
//    rollout crosses no block barrier. Loads run two chunks ahead of the
//    rollout. Where a round's slice fits (nch + 1 slots <= 50 KB: 48 KB at
//    the bench's shape, so 4 blocks share an SM at N = 4096), the round
//    stays resident: the update reads it again from shared memory, the next
//    round's first chunk is in flight during the softmax and the update,
//    its second from the end of the update. Otherwise four slots stream the
//    chunks, once for the rollout and once for the update (a block barrier
//    a chunk there: the update reads every warp's runs).
//  - The update is one product per scenario: a warp owns entries of the
//    nominal, four at a time, its lanes run over the samples with w from
//    shared memory (predicated, so the loads issue together), one shuffle
//    tree per entry per block.
//  - Each of the softmax's three block reductions takes one barrier.
// The host chooses the plan (threads, SPT, Tc, resident; kernels/mppi.py
// chunk_plan) and this file checks it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "plants.cuh"

// The probe (probes/mppi_riccati.py) builds this file with the NPT_STAMP
// macros filled in (the parts: 0 staging, 1 rollout, 2-4 the softmax's min,
// sum and ESS reductions, 5 the update, 6 the write-back); the package
// builds it with them empty.
#ifndef NPT_STAMP
#define NPT_STAMP_BEGIN
#define NPT_STAMP(part)
#define NPT_WAIT(v)
#define NPT_STAMP_END
#endif

namespace mppi {

constexpr int kMaxK = 1024;                          // kernels/mppi.py MAX_K
constexpr int kMaxTM = 1024;                         // kernels/mppi.py MAX_TM
constexpr int kMaxThreads = 256;                     // kernels/mppi.py MAX_THREADS
constexpr int kMaxTc = 8;                            // kernels/mppi.py MAX_TC
constexpr size_t kResidentBudget = 50 * 1024;        // kernels/mppi.py RESIDENT_BUDGET
constexpr size_t kStreamBudget = 48 * 1024;          // kernels/mppi.py STREAM_BUDGET
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kRed = 3 * 32;                         // the three reductions' warp partials

// The cost and the plant, by value (the kernel's parameter space).
template <int n, int m>
struct Consts {
  float par[plants::kMaxParams];
  float Q[n * n], R[m * m], QF[n * n], goal[n], isig[m];
};

struct Args {
  const float *x0s, *eps, *us0;
  float *us, *ess;
  int N, K, T, iters;
  float lam, inv_lam;
  int clip;
  float lo, hi;
  int Tc, nch, slots, resident;  // steps a chunk, chunks a round, ring slots, one load a round
  int vec, rowf;  // rows 16-byte aligned (16-byte copies); floats of a staged row (SPT * threads)
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

// Floats of shared memory before the eps ring.
inline int head_floats(int TM, int samples) { return (TM + 3) / 4 * 4 + samples + kRed; }

// Bound for 4 / SPT blocks of kMaxThreads a multiprocessor: 64 registers a
// thread for one sample (4 blocks at N = 4096, as the ring's 49 KB allow),
// more for a thread that carries several; a bound that names no block count
// lets ptxas trade spills for occupancy (ilqr_backward.cu).
template <int P, int SPT>
__global__ void __launch_bounds__(kMaxThreads, 4 / SPT)
    mppi_kernel(const Consts<plants::Plant<P>::n, plants::Plant<P>::m> cs, const Args a) {
  using F = plants::Plant<P>;
  using plants::add;
  using plants::mul;
  using plants::sub;
  constexpr int n = F::n, m = F::m;
  constexpr int kIters = SPT * kMaxThreads / 32;  // runs of 32 samples a lane may cover
  constexpr int kE = 4;                            // entries of the nominal a warp sums at once
  extern __shared__ __align__(16) float smem[];
  NPT_STAMP_BEGIN;
  const int TM = a.T * m, nt = blockDim.x, nw = nt >> 5;
  float* const u_nom = smem;                           // (T*m)
  float* const wsm = u_nom + (TM + 3) / 4 * 4;         // (SPT*nt) the weights, by sample
  float* const red = wsm + SPT * nt;                   // (3, 32)
  float* const ring = red + kRed;                      // (slots, Tc*m, rowf) eps chunks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s = blockIdx.x;
  const int crows = a.Tc * m;                          // rows of a chunk slot

  for (int e = tid; e < TM; e += nt) u_nom[e] = a.us0[e];
  float par[plants::kMaxParams], x0[n];
#pragma unroll
  for (int i = 0; i < plants::kMaxParams; ++i) par[i] = cs.par[i];
#pragma unroll
  for (int j = 0; j < n; ++j) x0[j] = a.x0s[static_cast<size_t>(s) * n + j];
  bool live[SPT];  // this thread's samples: tid + j * nt, sample k at float k of a staged row
#pragma unroll
  for (int j = 0; j < SPT; ++j) live[j] = tid + j * nt < a.K;

  const size_t NK = static_cast<size_t>(a.N) * a.K;
  const float* const eps_s = a.eps + static_cast<size_t>(s) * a.K;  // row r at + r * NK
  // Stage this warp's runs of samples (j * nt + 32 warp + [0, 32)) of chunk
  // c of round it into ring slot `slot`, as one commit group: 16-byte pieces
  // where the rows are 16-byte aligned (a.vec), else a float a lane. A warp
  // waits for its own copies only, so the rollout needs no block barrier.
  auto issue = [&](int it, int c, int slot) {
    if (it < a.iters && c < a.nch) {
      const int t0 = c * a.Tc, rows = min(a.Tc, a.T - t0) * m;
      float* const buf = ring + static_cast<size_t>(slot) * crows * a.rowf;
      const float* const src = eps_s + (static_cast<size_t>(it) * a.T + t0) * m * NK;
      if (a.vec) {
        for (int e = lane; e < rows * SPT * 8; e += 32) {
          const int q = e / (SPT * 8), j = (e / 8) % SPT;
          const int k = j * nt + warp * 32 + 4 * (e % 8);
          if (k < a.K) __pipeline_memcpy_async(buf + q * a.rowf + k, src + q * NK + k, 16);
        }
      } else {
        for (int q = 0; q < rows; ++q)
#pragma unroll
          for (int j = 0; j < SPT; ++j)
            if (live[j])
              __pipeline_memcpy_async(buf + q * a.rowf + tid + j * nt, src + q * NK + tid + j * nt,
                                      4);
      }
    }
    __pipeline_commit();
  };
  // The ring: resident, load L = it * nch + c (one a chunk and round, nch + 1
  // slots); streaming, L = it * 2 nch + phase * nch + c (phase 1: the
  // update's, 4 slots). Loads run two chunks ahead of the rollout, except
  // that a resident round's slots hold the round until its update is done,
  // so the next round's chunk 0 comes before the softmax and chunk 1 after
  // the update.
  auto slot_of = [&](int L) { return L % a.slots; };
  auto issue_load = [&](int L) {
    const int per = a.resident ? a.nch : 2 * a.nch;
    issue(L / per, (L % per) % a.nch, slot_of(L));
  };
  issue_load(0);
  if (a.resident) issue(0, 1, slot_of(1));
  else issue_load(1);
  NPT_STAMP(0);

  for (int it = 0; it < a.iters; ++it) {
    // -- rollout of every candidate: stage costs, terminal cost, coupling --
    float x[SPT][n], S[SPT], couple[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
#pragma unroll
      for (int i = 0; i < n; ++i) x[j][i] = x0[i];
      S[j] = 0.0f;
      couple[j] = 0.0f;
    }
    const int L0 = a.resident ? it * a.nch : it * 2 * a.nch;
    for (int c = 0; c < a.nch; ++c) {
      // two loads ahead: this round's chunk c + 2 (an empty group past the
      // round when resident; the update's first chunks when streaming)
      if (a.resident) issue(it, c + 2, slot_of(L0 + c + 2));
      else issue_load(L0 + c + 2);
      __pipeline_wait_prior(2);
      __syncwarp();  // this warp's runs of chunk c have landed
      NPT_STAMP(0);
      const int t0 = c * a.Tc, steps = min(a.Tc, a.T - t0);
      const float* ep = ring + static_cast<size_t>(slot_of(L0 + c)) * crows * a.rowf + tid;
      const float* up = u_nom + t0 * m;
      for (int tt = 0; tt < steps; ++tt, ep += m * a.rowf, up += m) {
        float un[m], cw[m], ev[SPT][m];
#pragma unroll
        for (int b = 0; b < m; ++b) {
          un[b] = up[b];
          cw[b] = mul(cs.isig[b], un[b]);
#pragma unroll
          for (int j = 0; j < SPT; ++j) ev[j][b] = live[j] ? ep[b * a.rowf + j * nt] : 0.0f;
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
      }
      NPT_WAIT(S[0]);
      NPT_STAMP(1);
    }
    float Sl = CUDART_INF_F;
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
      if (live[j]) Sl = fminf(Sl, S[j]);
    }
    // resident: the next round's chunk 0, into the one slot this round leaves free
    if (a.resident) issue(it + 1, 0, slot_of(L0 + a.nch));
    NPT_WAIT(Sl);
    NPT_STAMP(1);

    // -- softmax weights over the samples, and the ESS --
    const float Smin = block_reduce(Sl, red, Min());
    NPT_STAMP(2);
    float w[SPT], ws = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      w[j] = live[j] ? expf(mul(-sub(S[j], Smin), a.inv_lam)) : 0.0f;
      ws = add(ws, w[j]);
    }
    const float tot = block_reduce(ws, red + 32, Sum());
    NPT_STAMP(3);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      w[j] = plants::dvd(w[j], tot);
      wsm[tid + j * nt] = w[j];
      sq = add(sq, mul(w[j], w[j]));
    }
    const float ss = block_reduce(sq, red + 64, Sum());  // its barrier also publishes wsm
    if (tid == 0) a.ess[static_cast<size_t>(s) * a.iters + it] = plants::dvd(1.0f, ss);
    NPT_STAMP(4);

    // -- the update: sum_k w_k (cand_k - u_nom) a warp an entry, kE entries
    // a pass, lane i over samples i, i + 32, ... (resident: every entry of
    // the round in one go; streaming: a chunk's at a time) --
    const int passes = a.resident ? 1 : a.nch;
    for (int c = 0; c < passes; ++c) {
      if (!a.resident) {
        issue_load(L0 + a.nch + c + 2);
        __pipeline_wait_prior(2);
        __syncthreads();  // every warp's runs of the update's chunk c have landed
        NPT_STAMP(0);
      }
      const int e_lo = a.resident ? 0 : c * crows;
      const int e_hi = a.resident ? TM : min(TM, e_lo + crows);
      // entry e = t m + b sits in row (e - e_lo) % crows of chunk (e - e_lo) /
      // crows past the slot s_lo; the warp steps its (chunk, row) along
      const int s_lo = (L0 + (a.resident ? 0 : a.nch + c)) % a.slots;
      int chb = 0, rowb = warp;
      while (rowb >= crows) rowb -= crows, ++chb;
      for (int eb = e_lo + warp; eb < e_hi; eb += kE * nw) {
        // entries eb, eb + nw, ... (eb again past e_hi)
        int ee[kE];
        const float* rp[kE];
        float un[kE], v[kE];
        int ch = chb, row = rowb;
#pragma unroll
        for (int q = 0; q < kE; ++q) {
          const bool in = eb + q * nw < e_hi;
          ee[q] = in ? eb + q * nw : eb;
          int slot = s_lo + (in ? ch : chb);
          if (slot >= a.slots) slot -= a.slots;
          rp[q] = ring + (static_cast<size_t>(slot) * crows + (in ? row : rowb)) * a.rowf + lane;
          un[q] = u_nom[ee[q]];
          v[q] = 0.0f;
          row += nw;
          while (row >= crows) row -= crows, ++ch;
        }
        rowb += kE * nw;
        while (rowb >= crows) rowb -= crows, ++chb;
#pragma unroll
        for (int i = 0; i < kIters; ++i) {
          if (i * 32 + lane < a.K) {
            const float wk = wsm[i * 32 + lane];
#pragma unroll
            for (int q = 0; q < kE; ++q)
              v[q] = add(v[q], mul(wk, sub(clipu(add(un[q], rp[q][i * 32]), a), un[q])));
          }
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
      NPT_STAMP(5);
    }
    __syncthreads();  // the new nominal is in place; the round's slots are free
    // resident: the next round's chunk 1, into the slot of this round's chunk 0
    if (a.resident) issue(it + 1, 1, slot_of(L0 + a.nch + 1));
    NPT_STAMP(5);
  }
  for (int r = tid; r < TM; r += nt) a.us[static_cast<size_t>(s) * TM + r] = u_nom[r];
  NPT_STAMP(6);
  NPT_STAMP_END;
}

// One bit per device for each instance (plant, SPT 1/2/4) that has been
// allowed the largest dynamic shared memory. Internal linkage: a static
// inside a template function would be one object across every library that
// holds these kernels (the probe's beside the package's).
namespace {
unsigned smem_allowed[plants::kNumPlants][3];
}  // namespace

// Allows `kernel` the largest dynamic shared memory, once per device (a bit
// of `done`).
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
  const size_t ring = static_cast<size_t>(a.slots) * a.Tc * m * a.rowf * sizeof(float);
  const size_t smem = sizeof(float) * head_floats(a.T * m, SPT * threads) + ring;
  if (a.T * m > kMaxTM || ring > (a.resident ? kResidentBudget : kStreamBudget) ||
      smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(mppi_kernel<P, SPT>, smem_allowed[P][SPT / 2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  mppi_kernel<P, SPT><<<a.N, threads, smem, stream>>>(cs, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mppi

// us (N, T, m) and ess (N, iters) from the plant index and its parameter
// floats p0..p7 (plants::kMaxParams, by value); consts = Q (n, n), R (m, m),
// QF (n, n), goal (n), sigma^-2 (m) packed, fp32 in host memory (copied into
// the kernel's parameters); x0s (N, n); eps (iters*T*m, N, K); us0 (T*m);
// all fp32, row-major contiguous, on the device. lam and 1/lam as the caller
// rounds them; clip != 0 clips candidates and nominal to [lo, hi]. The plan
// (kernels/mppi.py chunk_plan): `threads` a block, each carrying `spt`
// samples, chunks of Tc steps, the round's slice resident in shared memory
// (resident != 0, Tc chosen so that ceil(T/Tc) + 1 chunks fit) or streamed;
// eps is staged by 16-byte copies where its rows are 16-byte aligned (eps
// aligned, K % 4 == 0), else a float at a time.
// n and m are the plant's; the caller checks the shapes against them.
// Returns the CUDA error code of the launch.
extern "C" int npt_mppi(int plant, float p0, float p1, float p2, float p3, float p4, float p5,
                        float p6, float p7, const float* consts, const float* x0s,
                        const float* eps, const float* us0, float* us, float* ess, int N, int K,
                        int T, int iters, float lam, float inv_lam, int clip, float lo, float hi,
                        int threads, int spt, int Tc, int resident, void* stream) {
  using namespace mppi;
  static_assert(plants::kMaxParams == 8, "one argument per plant parameter");
  if (N < 1 || K < 1 || K > kMaxK || T < 1 || iters < 1 || Tc < 1 || Tc > kMaxTc ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || threads * spt < K ||
      consts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float params[plants::kMaxParams] = {p0, p1, p2, p3, p4, p5, p6, p7};
  const int nch = (T + Tc - 1) / Tc;
  // every row starts on a 16-byte boundary when eps does and K % 4 == 0
  const int vec = reinterpret_cast<uintptr_t>(eps) % 16 == 0 && K % 4 == 0;
  const Args a{x0s, eps, us0, us, ess, N, K, T, iters, lam, inv_lam, clip, lo, hi,
               Tc, nch, resident ? nch + 1 : 4, resident ? 1 : 0, vec, spt * threads};
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
