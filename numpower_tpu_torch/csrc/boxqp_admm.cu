// ADMM box-QP solves for condensed MPC (s-form): the fused one (c formed from
// x0, the primal and dual residuals reduced in the kernel) and the two-step
// one (g given, z and the scaled dual y returned).
//
// Replaces two TPU kernels of numpower_tpu/kernels/boxqp_admm.py:
//   admm_mpc_pallas_res (body _admm_g_res_kernel, loop _s_loop, form "s"): K1,
//   admm_boxqp_pallas   (body _admm_kernel, the same loop):                 K3a.
// For each scenario it runs over-relaxed exact-solve ADMM on
//     min 1/2 U'HU + g'U  s.t.  lo <= U <= hi
// carrying the single pre-projection state s = x_r + y:
//     c = x0 @ Wc                  (K1; Wc = Sx'(Su'Q)'Minv', folded on the host)
//     c = (g @ (rho Minv)') / rho  (K3a; g read from the (N, d) operand)
//     p = clip(s);  t = 2p - s;  u = t @ (rho Minv)';  s += alpha (u - c - p)
// from s = z0 = clip(U0) (or clip(0) cold). Then z = clip(s) is written. K1,
// with x = (2z - s) @ (rho Minv)' - c and z+ = clip(s + alpha (x - z)), folds
// max |x - z| into *rp and rho max |z+ - z| into *rd over the N x d real
// entries only; K3a writes y = s - z, from which its caller forms the
// residuals outside, as the JAX package does. One template,
// admm_kernel<kFused>, runs the loop for both.
//
// Precision. The first `coarse` products round both operands to bf16
// (round-to-nearest-even) and accumulate in fp32, as the TPU's single-pass
// DEFAULT matmul does, so the calibrated schedule of
// models/condensed.admm_coarse_iters keeps its meaning. The tail products,
// the residual product and c are plain fp32 FMA: at least as accurate as the
// TPU kernels' bf16x3 tail, bf16x4 c (K1) and HIGHEST c (K3a). The hi/lo
// split schemes are for a later tensor-core version.
//
// What bounds it on the H100: the same as boxqp_fista.cu. (rho Minv)' stays in
// shared memory and s, p, c in registers for the whole solve, so device
// memory is touched once per scenario; the SM's fp32 FMA rate and its
// shared-memory bandwidth for the operands bound it. K3a's c costs one more
// (32, d) x (d, d) product per tile, as the TPU kernel's does.

#include "boxqp_tile.cuh"

namespace boxqp {

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
    admm_kernel(const float* __restrict__ rMt, const float* __restrict__ Wc,
                const float* __restrict__ x0, const float* __restrict__ g_in,
                const float* __restrict__ U0, const float* __restrict__ rho,
                float* __restrict__ z_out, float* __restrict__ y_out, float* __restrict__ rp,
                float* __restrict__ rd, int N, int n, int d, int iters, int coarse, float lo,
                float hi, float alpha) {
  extern __shared__ __align__(16) float smem_base[];
  __shared__ int scratch[kThreads / 32];
  const Smem sm = carve(smem_base, d, n);
  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  const int row0 = blockIdx.x * kTileS;

  stage_inputs(sm, rMt, Wc, x0, row0, N, n, d);  // n = 0 on the two-step route
  __syncthreads();

  float c[4][4], s[4][4], p[4][4], t[4][4], acc[4][4];
  if constexpr (kFused) {
    tile_product(sm.x0T, sm.w, n, rg, cg, c);
  } else {
    // c = (g @ (rho Minv)') * (1 / rho), through opT in fp32.
    load_tile(g_in, row0, N, d, rg, cg, t);
    store_operand(sm.opT, t, false, rg, cg, d);
    __syncthreads();
    tile_product(sm.opT, sm.mat, d, rg, cg, acc);
    const float inv_rho = 1.0f / *rho;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[r][q] = acc[r][q] * inv_rho;
    __syncthreads();  // every read of opT is done before it is overwritten
  }
  load_tile(U0, row0, N, d, rg, cg, s);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[r][q] = clip(s[r][q], lo, hi);
      p[r][q] = clip(s[r][q], lo, hi);
      t[r][q] = 2.0f * p[r][q] - s[r][q];
    }
  store_operand(sm.opT, t, coarse > 0, rg, cg, d);
  __syncthreads();

  for (int k = 0; k < iters; ++k) {
    tile_product(sm.opT, k < coarse ? sm.matb : sm.mat, d, rg, cg, acc);
    __syncthreads();  // every read of opT is done before it is overwritten
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[r][q] = s[r][q] + alpha * (acc[r][q] - c[r][q] - p[r][q]);
        p[r][q] = clip(s[r][q], lo, hi);
        t[r][q] = 2.0f * p[r][q] - s[r][q];
      }
    store_operand(sm.opT, t, k + 1 < coarse, rg, cg, d);
    __syncthreads();
  }
  store_tile(z_out, p, row0, N, d, rg, cg);  // z = p = clip(s)

  if constexpr (kFused) {
    // opT now holds 2z - s in fp32: one more x-update for the residuals, over
    // the real entries only.
    tile_product(sm.opT, sm.mat, d, rg, cg, acc);
    float rp_max = 0.0f, rd_max = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 4 * rg + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 4 * cg + q;
        if (row < N && col < d) {
          const float z = p[r][q];
          const float x = acc[r][q] - c[r][q];
          const float z_next = clip(s[r][q] + alpha * (x - z), lo, hi);
          rp_max = max_keep_nan(rp_max, fabsf(x - z));
          rd_max = max_keep_nan(rd_max, fabsf(z_next - z));
        }
      }
    }
    block_max_into(rp_max, rp, scratch);
    block_max_into(*rho * rd_max, rd, scratch);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) t[r][q] = s[r][q] - p[r][q];  // y = s - z
    store_tile(y_out, t, row0, N, d, rg, cg);
  }
}

template <bool kFused>
int launch_admm(const float* rMt, const float* Wc, const float* x0, const float* g,
                const float* U0, const float* rho, float* z, float* y, float* rp, float* rd,
                int N, int n, int d, int iters, int coarse, float lo, float hi, float alpha,
                void* stream) {
  if (N < 1 || n < 0 || n > kMaxN || (kFused && n < 1) || d < 1 || d > kMaxD || iters < 0 ||
      coarse < 0 || coarse > iters)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(d, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      admm_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + kTileS - 1) / kTileS;
  admm_kernel<kFused><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rMt, Wc, x0, g, U0, rho, z, y, rp, rd, N, n, d, iters, coarse, lo, hi, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace boxqp

// K1: launches the fused kernel on `stream`. U0 may be null (cold start at
// clip(0)). *rp and *rd must be zeroed. Returns the CUDA error code of the launch.
extern "C" int npt_admm_mpc_res(const float* rMt, const float* Wc, const float* x0,
                                const float* U0, const float* rho, float* z, float* rp,
                                float* rd, int N, int n, int d, int iters, int coarse, float lo,
                                float hi, float alpha, void* stream) {
  return boxqp::launch_admm<true>(rMt, Wc, x0, nullptr, U0, rho, z, nullptr, rp, rd, N, n, d,
                                  iters, coarse, lo, hi, alpha, stream);
}

// K3a: launches the two-step kernel on `stream`: (z, y) (N, d) each from g
// (N, d). U0 may be null (cold start at clip(0)). Returns the CUDA error code.
extern "C" int npt_admm_boxqp(const float* rMt, const float* g, const float* U0,
                              const float* rho, float* z, float* y, int N, int d, int iters,
                              int coarse, float lo, float hi, float alpha, void* stream) {
  return boxqp::launch_admm<false>(rMt, nullptr, nullptr, g, U0, rho, z, y, nullptr, nullptr, N,
                                   0, d, iters, coarse, lo, hi, alpha, stream);
}
