// FISTA box-QP solves for condensed MPC: the fused one (g formed from x0, the
// residual reduced in the kernel), the two-step one (g given) and the one
// that forms g from x0 and returns (U, g).
//
// Replaces three TPU kernels of numpower_tpu/kernels/boxqp_fista.py:
//   fista_mpc_pallas_res (body _fista_g_res_kernel, loop _fista_loop): K2,
//   fista_boxqp_pallas   (body _fista_kernel, the same loop):          K3b,
//   fista_mpc_pallas     (body _fista_g_kernel, the same loop):        K2'.
// For each scenario (row of the batch) it solves
//     min 1/2 U'HU + g'U  s.t.  lo <= U <= hi,
// with g = x0 @ W (K2, K2'; W = Sx'(Su'Q)' folded on the host; K2' writes g
// out) or g read from the (N, d) operand (K3b, for reference tracking and
// single-vector solves), by static-beta FISTA:
//     grad = Y @ H' + g;  U+ = clip(Y - grad / L);  Y = U+ + beta_k (U+ - U)
// The beta schedule restarts at the switch from the coarse to the tail phase
// and is 0 on the last coarse iteration. All write U (K2' from a cold start
// at 0); K2 also folds max |U - clip(U - (U @ H' + g) / L)| over the N x d
// real entries into *resid (K3b's and K2''s callers form the residual
// outside, as the JAX package does). One template,
// fista_kernel<kMode, kTailPrec, kGPrec>, runs the loop for all three.
//
// Precision. The first `coarse` products round both operands to bf16
// (round-to-nearest-even) and accumulate in fp32, as the TPU's single-pass
// DEFAULT matmul does, so the calibrated schedules of
// models/condensed.default_coarse_iters keep their meaning. K2's tail
// products and residual product run in the class kTailPrec and its g in the
// class kGPrec (boxqp_tile.cuh: "highest" fp32, or the bf16x3 / bf16x4
// hi/lo splits of the TPU kernel's tail_precision and g_precision); K3b's
// and K2''s products are fp32, at least as accurate as the TPU kernels'
// bf16x3 tail and HIGHEST g. On this card's FMA pipes a split class costs 3
// or 4 FMAs where fp32 costs one, so the port's default is "highest".
//
// What bounds it on the H100. Each iteration is an (N, d) x (d, d) product,
// 2 N d^2 flops, with nothing to read from device memory: H' stays in shared
// memory and the carries in registers for the whole solve (boxqp_tile.cuh),
// so device memory is touched once per scenario (x0 or g, and U0 in, U out;
// K2' also writes g). The bound is the SM's fp32 FMA rate and shared-memory
// bandwidth for the operands: per k a warp issues 16 FMAs per thread against
// one broadcast and one 512-byte shared load. The tensor cores are unused;
// moving the products onto wgmma is the next step for speed.

#include "boxqp_tile.cuh"

namespace boxqp {

enum FistaMode : int { kFistaMpcRes = 0, kFistaBoxqp = 1, kFistaMpc = 2 };  // K2, K3b, K2'

template <int kMode, int kTailPrec, int kGPrec>
__global__ void __launch_bounds__(kThreads)
    fista_kernel(const float* __restrict__ Ht, const float* __restrict__ W,
                 const float* __restrict__ x0, const float* __restrict__ g_in,
                 const float* __restrict__ U0, const float* __restrict__ lipschitz,
                 float* __restrict__ U_out, float* __restrict__ g_out, float* __restrict__ resid,
                 int N, int n, int d, int iters, int coarse, float lo, float hi) {
  static_assert(kMode == kFistaMpcRes || (kTailPrec == kHighest && kGPrec == kHighest),
                "the precision classes are K2's");
  extern __shared__ __align__(16) float smem_base[];
  __shared__ int scratch[kThreads / 32];
  const Smem sm = carve(smem_base, d, n);
  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  const int row0 = blockIdx.x * kTileS;

  stage_inputs(sm, Ht, W, x0, row0, N, n, d);  // n = 0 on the two-step route: H' only
  __syncthreads();

  const float step = 1.0f / *lipschitz;
  float g[4][4], U[4][4], Y[4][4], acc[4][4];
  if constexpr (kMode == kFistaBoxqp) {
    load_tile(g_in, row0, N, d, rg, cg, g);
  } else {
    tile_product<kGPrec, true>(sm.x0T, sm.w, nullptr, n, rg, cg, g);  // g = x0 @ W
    if constexpr (kMode == kFistaMpc) store_tile(g_out, g, row0, N, d, rg, cg);
  }
  load_tile(U0, row0, N, d, rg, cg, U);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Y[r][c] = U[r][c];
  store_operand(sm.opT, Y, coarse > 0, rg, cg, d);
  __syncthreads();

  double t = 1.0;  // FISTA's t_k, in double as the schedule is built on the host
  for (int k = 0; k < iters; ++k) {
    if (k == coarse) t = 1.0;
    const double t_next = 0.5 * (1.0 + sqrt(1.0 + 4.0 * t * t));
    const float beta = (k == coarse - 1) ? 0.0f : static_cast<float>((t - 1.0) / t_next);
    t = t_next;

    iteration_product<kTailPrec>(sm, k < coarse, d, rg, cg, acc);
    __syncthreads();  // every read of opT is done before it is overwritten
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float grad = acc[r][c] + g[r][c];
        const float u_new = clip(Y[r][c] - step * grad, lo, hi);
        Y[r][c] = u_new + beta * (u_new - U[r][c]);
        U[r][c] = u_new;
      }
    store_operand(sm.opT, Y, k + 1 < coarse, rg, cg, d);
    __syncthreads();
  }
  store_tile(U_out, U, row0, N, d, rg, cg);

  if constexpr (kMode == kFistaMpcRes) {
    // Projected-gradient residual at the final U, over the real entries only.
    store_operand(sm.opT, U, false, rg, cg, d);
    __syncthreads();
    iteration_product<kTailPrec>(sm, false, d, rg, cg, acc);
    float r_max = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 4 * rg + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * cg + c;
        if (row < N && col < d) {
          const float grad = acc[r][c] + g[r][c];
          r_max = max_keep_nan(r_max, fabsf(U[r][c] - clip(U[r][c] - step * grad, lo, hi)));
        }
      }
    }
    block_max_into(r_max, resid, scratch);
  }
}

template <int kMode, int kTailPrec = kHighest, int kGPrec = kHighest>
int launch_fista(const float* Ht, const float* W, const float* x0, const float* g,
                 const float* U0, const float* lipschitz, float* U, float* g_out, float* resid,
                 int N, int n, int d, int iters, int coarse, float lo, float hi, void* stream) {
  const bool needs_x0 = kMode != kFistaBoxqp;
  if (N < 1 || n < 0 || n > kMaxN || (needs_x0 && n < 1) || d < 1 || d > kMaxD || iters < 0 ||
      coarse < 0 || coarse > iters)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(d, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fista_kernel<kMode, kTailPrec, kGPrec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + kTileS - 1) / kTileS;
  fista_kernel<kMode, kTailPrec, kGPrec>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          Ht, W, x0, g, U0, lipschitz, U, g_out, resid, N, n, d, iters, coarse, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// K2 with tail class kTailPrec, the class of g chosen at run time.
template <int kTailPrec>
int launch_fista_res(int g_prec, const float* Ht, const float* W, const float* x0,
                     const float* U0, const float* lipschitz, float* U, float* resid, int N,
                     int n, int d, int iters, int coarse, float lo, float hi, void* stream) {
  switch (g_prec) {
    case kHighest:
      return launch_fista<kFistaMpcRes, kTailPrec, kHighest>(
          Ht, W, x0, nullptr, U0, lipschitz, U, nullptr, resid, N, n, d, iters, coarse, lo, hi,
          stream);
    case kBf16x3:
      return launch_fista<kFistaMpcRes, kTailPrec, kBf16x3>(
          Ht, W, x0, nullptr, U0, lipschitz, U, nullptr, resid, N, n, d, iters, coarse, lo, hi,
          stream);
    case kBf16x4:
      return launch_fista<kFistaMpcRes, kTailPrec, kBf16x4>(
          Ht, W, x0, nullptr, U0, lipschitz, U, nullptr, resid, N, n, d, iters, coarse, lo, hi,
          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace boxqp

// K2: launches the fused kernel on `stream`, its tail and residual products
// in class `tail_prec` (0 "highest", 3 "bf16x3") and g in class `g_prec`
// (0 "highest", 3 "bf16x3", 4 "bf16x4"). U0 may be null (cold start at 0).
// *resid must be zeroed. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int npt_fista_mpc_res(const float* Ht, const float* W, const float* x0,
                                 const float* U0, const float* lipschitz, float* U,
                                 float* resid, int N, int n, int d, int iters, int coarse,
                                 float lo, float hi, int tail_prec, int g_prec, void* stream) {
  switch (tail_prec) {
    case boxqp::kHighest:
      return boxqp::launch_fista_res<boxqp::kHighest>(g_prec, Ht, W, x0, U0, lipschitz, U, resid,
                                                      N, n, d, iters, coarse, lo, hi, stream);
    case boxqp::kBf16x3:
      return boxqp::launch_fista_res<boxqp::kBf16x3>(g_prec, Ht, W, x0, U0, lipschitz, U, resid,
                                                     N, n, d, iters, coarse, lo, hi, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3b: launches the two-step kernel on `stream`: U (N, d) from g (N, d). U0 may
// be null (cold start at 0). Returns the CUDA error code of the launch.
extern "C" int npt_fista_boxqp(const float* Ht, const float* g, const float* U0,
                               const float* lipschitz, float* U, int N, int d, int iters,
                               int coarse, float lo, float hi, void* stream) {
  return boxqp::launch_fista<boxqp::kFistaBoxqp>(Ht, nullptr, nullptr, g, U0, lipschitz, U,
                                                 nullptr, nullptr, N, 0, d, iters, coarse, lo,
                                                 hi, stream);
}

// K2': launches the kernel that forms g = x0 @ W on `stream` and writes
// (U, g), (N, d) each, from a cold start at 0. Returns the CUDA error code.
extern "C" int npt_fista_mpc(const float* Ht, const float* W, const float* x0,
                             const float* lipschitz, float* U, float* g, int N, int n, int d,
                             int iters, int coarse, float lo, float hi, void* stream) {
  return boxqp::launch_fista<boxqp::kFistaMpc>(Ht, W, x0, nullptr, nullptr, lipschitz, U, g,
                                               nullptr, N, n, d, iters, coarse, lo, hi, stream);
}
