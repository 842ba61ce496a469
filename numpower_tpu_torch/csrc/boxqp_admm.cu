// ADMM box-QP solves for condensed MPC: the fused one (c formed from x0, the
// primal and dual residuals reduced in the kernel), the two-step one (g
// given, z and the scaled dual y returned) and the one that forms g from x0
// and returns (z, y, g).
//
// Replaces three TPU kernels of numpower_tpu/kernels/boxqp_admm.py:
//   admm_mpc_pallas_res (body _admm_g_res_kernel, loops _s_loop, _zy_loop,
//                        _s_loop_pipelined by `form`):                      K1,
//   admm_boxqp_pallas   (body _admm_kernel, loop _s_loop):                  K3a,
//   admm_mpc_pallas     (body _admm_g_kernel, loop _s_loop):                K1'.
// For each scenario it runs over-relaxed exact-solve ADMM on
//     min 1/2 U'HU + g'U  s.t.  lo <= U <= hi
// carrying the single pre-projection state s = x_r + y (form "s"):
//     c = x0 @ Wc                  (K1; Wc = Sx'(Su'Q)'Minv', folded on the host)
//     c = (g @ (rho Minv)') / rho  (K3a: g read from the (N, d) operand;
//                                   K1': g = x0 @ W formed here and written,
//                                   W = Sx'(Su'Q)' folded on the host)
//     p = clip(s);  t = 2p - s;  u = t @ (rho Minv)';  s += alpha (u - c - p)
// from s = z0 = clip(U0) (or clip(0) cold; K1' always starts cold). Then
// z = clip(s) is written. K1, with x = (2z - s) @ (rho Minv)' - c and
// z+ = clip(s + alpha (x - z)), folds max |x - z| into *rp and rho max
// |z+ - z| into *rd over the N x d real entries only; K3a and K1' write
// y = s - z, from which the caller forms the residuals outside, as the JAX
// package does. One template, admm_kernel<kMode, kForm, kCPrec>, runs the
// loop for all three.
//
// K1's loop forms (kForm), the same recursion in three groupings:
//   "s"  above;
//   "sp" a = s - alpha c - alpha p before the product, s' = a + alpha u after
//        it (one FMA follows the product);
//   "zy" the classic carries z = clip(U0), y = 0: t = z - y,
//        u = t @ (rho Minv)', x = u - c, x_r = alpha x + (1 - alpha) z,
//        z' = clip(x_r + y), y += x_r - z'; it ends with s = z + y, so the
//        epilogue is shared. In the coarse phase t is the rounded operand.
// K3a and K1' run "s".
//
// Precision. The first `coarse` products round both operands to bf16
// (round-to-nearest-even) and accumulate in fp32, as the TPU's single-pass
// DEFAULT matmul does, so the calibrated schedule of
// models/condensed.admm_coarse_iters keeps its meaning: one bf16 pass. The
// tail products, the residual product and K3a's and K1''s c product are
// "highest", 6 bf16 passes (boxqp_tile.cuh): at least as accurate as the TPU
// kernels' bf16x3 tail. K1's c is formed in the class kCPrec (fp32 FMAs, or
// the hi/lo splits of the TPU kernel's c_precision); K1''s g is fp32, as the
// TPU kernels form it HIGHEST.
//
// What bounds it on the H100: the same as boxqp_fista.cu. (rho Minv)' stays in
// shared memory in its three bf16 splits and s, p, c in registers, in the
// accumulator's layout, for the whole solve, so device memory is touched once
// per scenario; the operation bound is the tensor cores' bf16 rate, but each
// iteration is a latency chain (store, fence, barrier, passes, wait) at 32
// scenarios a block. K3a's and K1''s c cost one more 6-pass product per
// tile, as the TPU kernels' do; K1' writes three (N, d) outputs where K1
// writes one. Past d = 128 each instance runs on the wide tile, as the FISTA
// kernels (boxqp_fista.cu, boxqp_tile.cuh).

#include "boxqp_tile.cuh"

namespace boxqp {

enum AdmmMode : int { kAdmmMpcRes = 0, kAdmmBoxqp = 1, kAdmmMpc = 2 };  // K1, K3a, K1'
enum AdmmForm : int { kFormS = 0, kFormZY = 1, kFormSP = 2 };

constexpr int kTail = passes(kHighest);

template <int kMode, int kForm, int kCPrec, class Tile>
__global__ void __launch_bounds__(kThreads)
    admm_kernel(const float* __restrict__ rMt, const float* __restrict__ fold,
                const float* __restrict__ x0, const float* __restrict__ g_in,
                const float* __restrict__ U0, const float* __restrict__ rho,
                float* __restrict__ z_out, float* __restrict__ y_out, float* __restrict__ g_out,
                float* __restrict__ rp, float* __restrict__ rd, int N, int n, int d, int iters,
                int coarse, float lo, float hi, float alpha) {
  static_assert(kMode == kAdmmMpcRes || (kForm == kFormS && kCPrec == kHighest),
                "the loop forms and c's precision classes are K1's");
  extern __shared__ __align__(128) unsigned char smem_base[];
  __shared__ int scratch[kThreads / 32];
  const Tile tile(smem_base, n, d, rMt);
  const Frag f = frag();
  const int row0 = tile.row0(), j_off = tile.j_off();

  tile.stage(rMt, fold, x0, N, n);  // n = 0 on the two-step route

  float c[16], s[16], p[16], t[16], acc[16];
  int buf = 0;
  if constexpr (kMode == kAdmmMpcRes) {
    fold_product<kCPrec>(tile.sm, fold, x0, row0, N, n, d, j_off, f, c);  // c = x0 @ Wc
  } else {
    if constexpr (kMode == kAdmmMpc) {
      fold_product<kHighest>(tile.sm, fold, x0, row0, N, n, d, j_off, f, t);  // g = x0 @ W
      store_frag(g_out, t, row0, N, d, f, j_off);
    } else {
      load_frag(g_in, row0, N, d, f, t, j_off);
    }
    // c = (g @ (rho Minv)') * (1 / rho), a "highest" product.
    tile.template store_iterate<kTail>(buf, t, f, false);
    tile.template product<kTail>(buf, f, acc);
    const float inv_rho = 1.0f / *rho;
#pragma unroll
    for (int r = 0; r < 16; ++r) c[r] = acc[r] * inv_rho;
    buf = 1;  // the other warpgroup (or CTA) may still read buffer 0
  }
  // The zy form's carries live in the s-form's registers: z in s, y in p.
  float(&z)[16] = s;
  float(&y)[16] = p;
  load_frag(U0, row0, N, d, f, s, j_off);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    s[r] = clip(s[r], lo, hi);
    if constexpr (kForm == kFormZY) {
      y[r] = 0.0f;
      t[r] = z[r];
    } else {
      p[r] = clip(s[r], lo, hi);
      t[r] = 2.0f * p[r] - s[r];
    }
  }
  tile.template store_iterate<kTail>(buf, t, f, coarse > 0);

  for (int k = 0; k < iters; ++k) {
    if constexpr (kForm == kFormSP) {
#pragma unroll
      for (int r = 0; r < 16; ++r) s[r] = s[r] - alpha * c[r] - alpha * p[r];
    }
    if (k < coarse) {
      tile.template product<kCoarse>(buf, f, acc);
    } else {
      tile.template product<kTail>(buf, f, acc);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if constexpr (kForm == kFormZY) {
        const float x_r = alpha * (acc[r] - c[r]) + (1.0f - alpha) * z[r];
        const float z_new = clip(x_r + y[r], lo, hi);
        y[r] = y[r] + x_r - z_new;
        z[r] = z_new;
        t[r] = z[r] - y[r];
      } else {
        if constexpr (kForm == kFormSP) {
          s[r] = s[r] + alpha * acc[r];
        } else {
          s[r] = s[r] + alpha * (acc[r] - c[r] - p[r]);
        }
        p[r] = clip(s[r], lo, hi);
        t[r] = 2.0f * p[r] - s[r];
      }
    }
    buf ^= 1;  // the other warpgroup (or CTA) may still read `buf`
    tile.template store_iterate<kTail>(buf, t, f, k + 1 < coarse);
  }
  if constexpr (kForm == kFormZY) {
    // s = z + y, then the s-form's state: p = clip(s) and, for the residual
    // product, 2p - s as the operand; every product of the loop is done, so
    // `buf` is free.
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      s[r] = z[r] + y[r];
      p[r] = clip(s[r], lo, hi);
      t[r] = 2.0f * p[r] - s[r];
    }
    if constexpr (kMode == kAdmmMpcRes) tile.template store_iterate<kTail>(buf, t, f, false);
  }
  store_frag(z_out, p, row0, N, d, f, j_off);  // z = p = clip(s)

  if constexpr (kMode == kAdmmMpcRes) {
    // `buf` now holds 2z - s in the tail's parts: one more x-update for the
    // residuals, over the real entries only.
    tile.template product<kTail>(buf, f, acc);
    float rp_max = 0.0f, rd_max = 0.0f;
    const int d_loc = tile.d_loc();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + frag_s(f, r), j = frag_j(f, r);
      if (row < N && j < d_loc) {
        const float zq = p[r];
        const float x = acc[r] - c[r];
        const float z_next = clip(s[r] + alpha * (x - zq), lo, hi);
        rp_max = max_keep_nan(rp_max, fabsf(x - zq));
        rd_max = max_keep_nan(rd_max, fabsf(z_next - zq));
      }
    }
    block_max_into(rp_max, rp, scratch);
    block_max_into(*rho * rd_max, rd, scratch);
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) t[r] = s[r] - p[r];  // y = s - z
    store_frag(y_out, t, row0, N, d, f, j_off);
  }
  tile.finish();
}

// Launch one instance on the narrow tile (d <= kMaxD; `rMt` the fp32
// (rho Minv)') or the wide one (kMaxD < d <= kMaxWideD; `rMt` the wrapper's
// split operand, WideTile), for any n >= 1 (n = 0 on the two-step route):
// shared memory holds one chunk of the fold (smem_bytes, wide_smem_bytes).
template <int kMode, int kForm = kFormS, int kCPrec = kHighest>
int launch_admm(const float* rMt, const float* fold, const float* x0, const float* g,
                const float* U0, const float* rho, float* z, float* y, float* g_out, float* rp,
                float* rd, int N, int n, int d, int iters, int coarse, float lo, float hi,
                float alpha, bool wide, void* stream) {
  const bool needs_x0 = kMode != kAdmmBoxqp;
  if (N < 1 || n < 0 || (needs_x0 && n < 1) || d < 1 ||
      d > (wide ? kMaxWideD : kMaxD) || (wide && d <= kMaxD) || iters < 0 || coarse < 0 ||
      coarse > iters)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    return launch_wide(admm_kernel<kMode, kForm, kCPrec, WideTile>, N, n, d, stream, rMt, fold,
                       x0, g, U0, rho, z, y, g_out, rp, rd, N, n, d, iters, coarse, lo, hi,
                       alpha);
  }
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(admm_kernel<kMode, kForm, kCPrec, NarrowTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + kTileS - 1) / kTileS;
  admm_kernel<kMode, kForm, kCPrec, NarrowTile>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          rMt, fold, x0, g, U0, rho, z, y, g_out, rp, rd, N, n, d, iters, coarse, lo, hi,
          alpha);
  return static_cast<int>(cudaGetLastError());
}

// K1 at one loop form, the precision class of c chosen at run time.
template <int kForm>
int launch_admm_res(int c_prec, const float* rMt, const float* Wc, const float* x0,
                    const float* U0, const float* rho, float* z, float* rp, float* rd, int N,
                    int n, int d, int iters, int coarse, float lo, float hi, float alpha,
                    bool wide, void* stream) {
  switch (c_prec) {
    case kHighest:
      return launch_admm<kAdmmMpcRes, kForm, kHighest>(rMt, Wc, x0, nullptr, U0, rho, z,
                                                       nullptr, nullptr, rp, rd, N, n, d, iters,
                                                       coarse, lo, hi, alpha, wide, stream);
    case kBf16x3:
      return launch_admm<kAdmmMpcRes, kForm, kBf16x3>(rMt, Wc, x0, nullptr, U0, rho, z,
                                                      nullptr, nullptr, rp, rd, N, n, d, iters,
                                                      coarse, lo, hi, alpha, wide, stream);
    case kBf16x4:
      return launch_admm<kAdmmMpcRes, kForm, kBf16x4>(rMt, Wc, x0, nullptr, U0, rho, z,
                                                      nullptr, nullptr, rp, rd, N, n, d, iters,
                                                      coarse, lo, hi, alpha, wide, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1, the loop form and c's class chosen at run time.
int admm_res(const float* rMt, const float* Wc, const float* x0, const float* U0,
             const float* rho, float* z, float* rp, float* rd, int N, int n, int d, int iters,
             int coarse, float lo, float hi, float alpha, int form, int c_prec, bool wide,
             void* stream) {
  switch (form) {
    case kFormS:
      return launch_admm_res<kFormS>(c_prec, rMt, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters,
                                     coarse, lo, hi, alpha, wide, stream);
    case kFormZY:
      return launch_admm_res<kFormZY>(c_prec, rMt, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters,
                                      coarse, lo, hi, alpha, wide, stream);
    case kFormSP:
      return launch_admm_res<kFormSP>(c_prec, rMt, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters,
                                      coarse, lo, hi, alpha, wide, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace boxqp

// The C entries. Each returns the CUDA error code of its launch (0 on
// success). An entry named *_wide takes kMaxD < d <= kMaxWideD (128 < d <=
// 1024) and, in place of the fp32 (rho Minv)', the wrapper's split operand
// of the wide tile (boxqp_tile.cuh, WideTile); the others take d <= 128 and
// (rho Minv)'.

// K1: launches the fused kernel on `stream` with loop form `form` (0 "s",
// 1 "zy", 2 "sp") and c formed in class `c_prec` (0 "highest", 3 "bf16x3",
// 4 "bf16x4"). U0 may be null (cold start at clip(0)). *rp and *rd must be
// zeroed.
extern "C" int npt_admm_mpc_res(const float* rMt, const float* Wc, const float* x0,
                                const float* U0, const float* rho, float* z, float* rp,
                                float* rd, int N, int n, int d, int iters, int coarse, float lo,
                                float hi, float alpha, int form, int c_prec, void* stream) {
  return boxqp::admm_res(rMt, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters, coarse, lo, hi, alpha,
                         form, c_prec, false, stream);
}

extern "C" int npt_admm_mpc_res_wide(const float* A, const float* Wc, const float* x0,
                                     const float* U0, const float* rho, float* z, float* rp,
                                     float* rd, int N, int n, int d, int iters, int coarse,
                                     float lo, float hi, float alpha, int form, int c_prec,
                                     void* stream) {
  return boxqp::admm_res(A, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters, coarse, lo, hi, alpha,
                         form, c_prec, true, stream);
}

// K3a: launches the two-step kernel on `stream`: (z, y) (N, d) each from g
// (N, d). U0 may be null (cold start at clip(0)).
extern "C" int npt_admm_boxqp(const float* rMt, const float* g, const float* U0,
                              const float* rho, float* z, float* y, int N, int d, int iters,
                              int coarse, float lo, float hi, float alpha, void* stream) {
  return boxqp::launch_admm<boxqp::kAdmmBoxqp>(rMt, nullptr, nullptr, g, U0, rho, z, y, nullptr,
                                               nullptr, nullptr, N, 0, d, iters, coarse, lo, hi,
                                               alpha, false, stream);
}

extern "C" int npt_admm_boxqp_wide(const float* A, const float* g, const float* U0,
                                   const float* rho, float* z, float* y, int N, int d, int iters,
                                   int coarse, float lo, float hi, float alpha, void* stream) {
  return boxqp::launch_admm<boxqp::kAdmmBoxqp>(A, nullptr, nullptr, g, U0, rho, z, y, nullptr,
                                               nullptr, nullptr, N, 0, d, iters, coarse, lo, hi,
                                               alpha, true, stream);
}

// K1': launches the kernel that forms g = x0 @ W on `stream` and writes
// (z, y, g), (N, d) each, from a cold start at clip(0).
extern "C" int npt_admm_mpc(const float* rMt, const float* W, const float* x0, const float* rho,
                            float* z, float* y, float* g, int N, int n, int d, int iters,
                            int coarse, float lo, float hi, float alpha, void* stream) {
  return boxqp::launch_admm<boxqp::kAdmmMpc>(rMt, W, x0, nullptr, nullptr, rho, z, y, g, nullptr,
                                             nullptr, N, n, d, iters, coarse, lo, hi, alpha,
                                             false, stream);
}

extern "C" int npt_admm_mpc_wide(const float* A, const float* W, const float* x0,
                                 const float* rho, float* z, float* y, float* g, int N, int n,
                                 int d, int iters, int coarse, float lo, float hi, float alpha,
                                 void* stream) {
  return boxqp::launch_admm<boxqp::kAdmmMpc>(A, W, x0, nullptr, nullptr, rho, z, y, g, nullptr,
                                             nullptr, N, n, d, iters, coarse, lo, hi, alpha,
                                             true, stream);
}
