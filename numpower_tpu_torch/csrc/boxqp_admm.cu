// Fused ADMM box-QP solve for condensed MPC (s-form), with the primal and dual
// residuals reduced in the kernel.
//
// Replaces the TPU kernel numpower_tpu/kernels/boxqp_admm.py
// admm_mpc_pallas_res (body _admm_g_res_kernel, loop _s_loop, form "s"). For
// each scenario x0 it runs over-relaxed exact-solve ADMM on
//     min 1/2 U'HU + g'U  s.t.  lo <= U <= hi
// carrying the single pre-projection state s = x_r + y:
//     c = x0 @ Wc                  (Wc = Sx'(Su'Q)'Minv', folded on the host)
//     p = clip(s);  t = 2p - s;  u = t @ (rho Minv)';  s += alpha (u - c - p)
// from s = z0 = clip(U0) (or clip(0) cold). Then z = clip(s) is written, and
// with x = (2z - s) @ (rho Minv)' - c and z+ = clip(s + alpha (x - z)) it folds
// max |x - z| into *rp and rho max |z+ - z| into *rd, over the N x d real
// entries only.
//
// Precision. The first `coarse` products round both operands to bf16
// (round-to-nearest-even) and accumulate in fp32, as the TPU's single-pass
// DEFAULT matmul does, so the calibrated schedule of
// models/condensed.admm_coarse_iters keeps its meaning. The tail products,
// the residual product and c = x0 @ Wc are plain fp32 FMA: at least as
// accurate as the TPU kernel's bf16x3 tail and bf16x4 c. The hi/lo split
// schemes are for a later tensor-core version.
//
// What bounds it on the H100: the same as boxqp_fista.cu. (rho Minv)' stays in
// shared memory and s, p, c in registers for the whole solve, so device
// memory is touched once per scenario; the SM's fp32 FMA rate and its
// shared-memory bandwidth for the operands bound it.

#include "boxqp_tile.cuh"

namespace boxqp {

__global__ void __launch_bounds__(kThreads)
    admm_mpc_res_kernel(const float* __restrict__ rMt, const float* __restrict__ Wc,
                        const float* __restrict__ x0, const float* __restrict__ U0,
                        const float* __restrict__ rho, float* __restrict__ z_out,
                        float* __restrict__ rp, float* __restrict__ rd, int N, int n, int d,
                        int iters, int coarse, float lo, float hi, float alpha) {
  extern __shared__ __align__(16) float smem_base[];
  __shared__ int scratch[kThreads / 32];
  const Smem sm = carve(smem_base, d, n);
  const int rg = threadIdx.x / 32, cg = threadIdx.x % 32;
  const int row0 = blockIdx.x * kTileS;

  stage_inputs(sm, rMt, Wc, x0, row0, N, n, d);
  __syncthreads();

  float c[4][4], s[4][4], p[4][4], t[4][4], acc[4][4];
  tile_product(sm.x0T, sm.w, n, rg, cg, c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * rg + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * cg + q;
      const bool real = row < N && col < d;
      s[r][q] = clip((U0 != nullptr && real) ? U0[static_cast<size_t>(row) * d + col] : 0.0f,
                     lo, hi);
      p[r][q] = clip(s[r][q], lo, hi);
      t[r][q] = 2.0f * p[r][q] - s[r][q];
    }
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

  // opT now holds 2z - s in fp32 (z = p = clip(s)): one more x-update for the
  // residuals, over the real entries only.
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
        z_out[static_cast<size_t>(row) * d + col] = z;
      }
    }
  }
  block_max_into(rp_max, rp, scratch);
  block_max_into(*rho * rd_max, rd, scratch);
}

}  // namespace boxqp

// Launches the kernel on `stream`. U0 may be null (cold start at clip(0)).
// *rp and *rd must be zeroed. Returns the CUDA error code of the launch.
extern "C" int npt_admm_mpc_res(const float* rMt, const float* Wc, const float* x0,
                                const float* U0, const float* rho, float* z, float* rp,
                                float* rd, int N, int n, int d, int iters, int coarse, float lo,
                                float hi, float alpha, void* stream) {
  using namespace boxqp;
  if (N < 1 || n < 1 || n > kMaxN || d < 1 || d > kMaxD || iters < 0 || coarse < 0 ||
      coarse > iters)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(d, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      admm_mpc_res_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + kTileS - 1) / kTileS;
  admm_mpc_res_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rMt, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters, coarse, lo, hi, alpha);
  return static_cast<int>(cudaGetLastError());
}
