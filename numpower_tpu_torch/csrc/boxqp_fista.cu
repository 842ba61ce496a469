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
// models/condensed.default_coarse_iters keep their meaning: one bf16 pass.
// K2's tail products and residual product run in the class kTailPrec
// ("highest", 6 passes, or "bf16x3", 3) and its g in the class kGPrec (fp32
// FMAs, or the hi/lo splits of the TPU kernel's g_precision; boxqp_tile.cuh);
// K3b's and K2''s tail products are "highest", at least as accurate as the
// TPU kernels' bf16x3 tail, and K2''s g fp32.
//
// What bounds it on the H100. Each iteration is a (32, d) x (d, d) product per
// block on the tensor cores (boxqp_tile.cuh: wgmma m64n32k16, A = H staged
// once in shared memory, the carries in the accumulator's layout in
// registers), so device memory is touched once per scenario (x0 or g, and U0
// in, U out; K2' also writes g). The operation bound is 2 N d^2 flops per
// bf16 pass at the tensor cores' 989 TFLOP/s. At N = 32 a block, though, each
// iteration is a latency chain with nothing to overlap it: split and store
// the next operand, fence, barrier, start the passes (8 k-steps each), wait
// for them, update elementwise. The time per iteration is what to watch; the
// two B buffers make one barrier a step enough.
//
// Past d = 128 (to the JAX kernels' bound of d = 1024) each instance runs on
// the wide tile (boxqp_tile.cuh, WideTile): a cluster of ceil(d / 128) blocks
// per 32-scenario tile, each block owning 128 rows of every product and
// carry, H streamed from L2 in 64-wide slabs (the wrapper splits and lays it
// out once), the iterate's slabs pulled from the owning block's shared
// memory, one cluster barrier an iteration. A product there reads its
// matrix panel from L2 each iteration (1.5 MB of splits at d = 400 per
// cluster), so it is bound by L2 and the slab loop's latency, not by the
// tensor cores.

#include "boxqp_tile.cuh"

namespace boxqp {

enum FistaMode : int { kFistaMpcRes = 0, kFistaBoxqp = 1, kFistaMpc = 2 };  // K2, K3b, K2'

template <int kMode, int kTailPrec, int kGPrec, class Tile>
__global__ void __launch_bounds__(kThreads)
    fista_kernel(const float* __restrict__ Ht, const float* __restrict__ W,
                 const float* __restrict__ x0, const float* __restrict__ g_in,
                 const float* __restrict__ U0, const float* __restrict__ lipschitz,
                 float* __restrict__ U_out, float* __restrict__ g_out, float* __restrict__ resid,
                 int N, int n, int d, int iters, int coarse, float lo, float hi) {
  static_assert(kMode == kFistaMpcRes || (kTailPrec == kHighest && kGPrec == kHighest),
                "the precision classes are K2's");
  constexpr int kTail = passes(kTailPrec);
  extern __shared__ __align__(128) unsigned char smem_base[];
  __shared__ int scratch[kThreads / 32];
  const Tile tile(smem_base, n, d, Ht);
  const Frag f = frag();
  const int row0 = tile.row0(), j_off = tile.j_off();

  tile.stage(Ht, W, x0, N, n);  // n = 0 on the two-step route: H' only

  const float step = 1.0f / *lipschitz;
  float g[16], U[16], Y[16], acc[16];
  if constexpr (kMode == kFistaBoxqp) {
    load_frag(g_in, row0, N, d, f, g, j_off);
  } else {
    fold_product<kGPrec>(tile.sm, W, x0, row0, N, n, d, j_off, f, g);  // g = x0 @ W
    if constexpr (kMode == kFistaMpc) store_frag(g_out, g, row0, N, d, f, j_off);
  }
  load_frag(U0, row0, N, d, f, U, j_off);
#pragma unroll
  for (int r = 0; r < 16; ++r) Y[r] = U[r];
  int buf = 0;
  tile.template store_iterate<kTail>(buf, Y, f, coarse > 0);

  double t = 1.0;  // FISTA's t_k, in double as the schedule is built on the host
  for (int k = 0; k < iters; ++k) {
    if (k == coarse) t = 1.0;
    const double t_next = 0.5 * (1.0 + sqrt(1.0 + 4.0 * t * t));
    const float beta = (k == coarse - 1) ? 0.0f : static_cast<float>((t - 1.0) / t_next);
    t = t_next;

    if (k < coarse) {
      tile.template product<kCoarse>(buf, f, acc);
    } else {
      tile.template product<kTail>(buf, f, acc);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float grad = acc[r] + g[r];
      const float u_new = clip(Y[r] - step * grad, lo, hi);
      Y[r] = u_new + beta * (u_new - U[r]);
      U[r] = u_new;
    }
    buf ^= 1;  // the other warpgroup (or CTA) may still read `buf`
    tile.template store_iterate<kTail>(buf, Y, f, k + 1 < coarse);
  }
  store_frag(U_out, U, row0, N, d, f, j_off);

  if constexpr (kMode == kFistaMpcRes) {
    // Projected-gradient residual at the final U, over the real entries only;
    // every product of the loop is done, so `buf` is free.
    tile.template store_iterate<kTail>(buf, U, f, false);
    tile.template product<kTail>(buf, f, acc);
    float r_max = 0.0f;
    const int d_loc = tile.d_loc();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + frag_s(f, r), j = frag_j(f, r);
      if (row < N && j < d_loc) {
        const float grad = acc[r] + g[r];
        r_max = max_keep_nan(r_max, fabsf(U[r] - clip(U[r] - step * grad, lo, hi)));
      }
    }
    block_max_into(r_max, resid, scratch);
  }
  tile.finish();
}

// Launch one instance on the narrow tile (d <= kMaxD; `Ht` the fp32 H') or
// the wide one (kMaxD < d <= kMaxWideD; `Ht` the wrapper's split operand,
// WideTile), for any n >= 1 (n = 0 on the two-step route): shared memory
// holds one chunk of the fold (smem_bytes, wide_smem_bytes).
template <int kMode, int kTailPrec = kHighest, int kGPrec = kHighest>
int launch_fista(const float* Ht, const float* W, const float* x0, const float* g,
                 const float* U0, const float* lipschitz, float* U, float* g_out, float* resid,
                 int N, int n, int d, int iters, int coarse, float lo, float hi, bool wide,
                 void* stream) {
  const bool needs_x0 = kMode != kFistaBoxqp;
  if (N < 1 || n < 0 || (needs_x0 && n < 1) || d < 1 ||
      d > (wide ? kMaxWideD : kMaxD) || (wide && d <= kMaxD) || iters < 0 || coarse < 0 ||
      coarse > iters)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    return launch_wide(fista_kernel<kMode, kTailPrec, kGPrec, WideTile>, N, n, d, stream, Ht, W,
                       x0, g, U0, lipschitz, U, g_out, resid, N, n, d, iters, coarse, lo, hi);
  }
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(fista_kernel<kMode, kTailPrec, kGPrec, NarrowTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + kTileS - 1) / kTileS;
  fista_kernel<kMode, kTailPrec, kGPrec, NarrowTile>
      <<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          Ht, W, x0, g, U0, lipschitz, U, g_out, resid, N, n, d, iters, coarse, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// K2 with tail class kTailPrec, the class of g chosen at run time.
template <int kTailPrec>
int launch_fista_res(int g_prec, const float* Ht, const float* W, const float* x0,
                     const float* U0, const float* lipschitz, float* U, float* resid, int N,
                     int n, int d, int iters, int coarse, float lo, float hi, bool wide,
                     void* stream) {
  switch (g_prec) {
    case kHighest:
      return launch_fista<kFistaMpcRes, kTailPrec, kHighest>(
          Ht, W, x0, nullptr, U0, lipschitz, U, nullptr, resid, N, n, d, iters, coarse, lo, hi,
          wide, stream);
    case kBf16x3:
      return launch_fista<kFistaMpcRes, kTailPrec, kBf16x3>(
          Ht, W, x0, nullptr, U0, lipschitz, U, nullptr, resid, N, n, d, iters, coarse, lo, hi,
          wide, stream);
    case kBf16x4:
      return launch_fista<kFistaMpcRes, kTailPrec, kBf16x4>(
          Ht, W, x0, nullptr, U0, lipschitz, U, nullptr, resid, N, n, d, iters, coarse, lo, hi,
          wide, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2, the tail's class and g's chosen at run time.
int fista_res(const float* Ht, const float* W, const float* x0, const float* U0,
              const float* lipschitz, float* U, float* resid, int N, int n, int d, int iters,
              int coarse, float lo, float hi, int tail_prec, int g_prec, bool wide,
              void* stream) {
  switch (tail_prec) {
    case kHighest:
      return launch_fista_res<kHighest>(g_prec, Ht, W, x0, U0, lipschitz, U, resid, N, n, d,
                                        iters, coarse, lo, hi, wide, stream);
    case kBf16x3:
      return launch_fista_res<kBf16x3>(g_prec, Ht, W, x0, U0, lipschitz, U, resid, N, n, d,
                                       iters, coarse, lo, hi, wide, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace boxqp

// The C entries. Each returns the CUDA error code of its launch (0 on
// success). An entry named *_wide takes kMaxD < d <= kMaxWideD (128 < d <=
// 1024) and, in place of the fp32 H', the wrapper's split operand of the
// wide tile (boxqp_tile.cuh, WideTile); the others take d <= 128 and H'.

// K2: launches the fused kernel on `stream`, its tail and residual products
// in class `tail_prec` (0 "highest", 3 "bf16x3") and g in class `g_prec`
// (0 "highest", 3 "bf16x3", 4 "bf16x4"). U0 may be null (cold start at 0).
// *resid must be zeroed.
extern "C" int npt_fista_mpc_res(const float* Ht, const float* W, const float* x0,
                                 const float* U0, const float* lipschitz, float* U,
                                 float* resid, int N, int n, int d, int iters, int coarse,
                                 float lo, float hi, int tail_prec, int g_prec, void* stream) {
  return boxqp::fista_res(Ht, W, x0, U0, lipschitz, U, resid, N, n, d, iters, coarse, lo, hi,
                          tail_prec, g_prec, false, stream);
}

extern "C" int npt_fista_mpc_res_wide(const float* A, const float* W, const float* x0,
                                      const float* U0, const float* lipschitz, float* U,
                                      float* resid, int N, int n, int d, int iters, int coarse,
                                      float lo, float hi, int tail_prec, int g_prec,
                                      void* stream) {
  return boxqp::fista_res(A, W, x0, U0, lipschitz, U, resid, N, n, d, iters, coarse, lo, hi,
                          tail_prec, g_prec, true, stream);
}

// K3b: launches the two-step kernel on `stream`: U (N, d) from g (N, d). U0 may
// be null (cold start at 0).
extern "C" int npt_fista_boxqp(const float* Ht, const float* g, const float* U0,
                               const float* lipschitz, float* U, int N, int d, int iters,
                               int coarse, float lo, float hi, void* stream) {
  return boxqp::launch_fista<boxqp::kFistaBoxqp>(Ht, nullptr, nullptr, g, U0, lipschitz, U,
                                                 nullptr, nullptr, N, 0, d, iters, coarse, lo,
                                                 hi, false, stream);
}

extern "C" int npt_fista_boxqp_wide(const float* A, const float* g, const float* U0,
                                    const float* lipschitz, float* U, int N, int d, int iters,
                                    int coarse, float lo, float hi, void* stream) {
  return boxqp::launch_fista<boxqp::kFistaBoxqp>(A, nullptr, nullptr, g, U0, lipschitz, U,
                                                 nullptr, nullptr, N, 0, d, iters, coarse, lo,
                                                 hi, true, stream);
}

// K2': launches the kernel that forms g = x0 @ W on `stream` and writes
// (U, g), (N, d) each, from a cold start at 0.
extern "C" int npt_fista_mpc(const float* Ht, const float* W, const float* x0,
                             const float* lipschitz, float* U, float* g, int N, int n, int d,
                             int iters, int coarse, float lo, float hi, void* stream) {
  return boxqp::launch_fista<boxqp::kFistaMpc>(Ht, W, x0, nullptr, nullptr, lipschitz, U, g,
                                               nullptr, N, n, d, iters, coarse, lo, hi, false,
                                               stream);
}

extern "C" int npt_fista_mpc_wide(const float* A, const float* W, const float* x0,
                                  const float* lipschitz, float* U, float* g, int N, int n,
                                  int d, int iters, int coarse, float lo, float hi,
                                  void* stream) {
  return boxqp::launch_fista<boxqp::kFistaMpc>(A, W, x0, nullptr, nullptr, lipschitz, U, g,
                                               nullptr, N, n, d, iters, coarse, lo, hi, true,
                                               stream);
}

// The clusters of K2 ("highest") on the wide tile for d and a fold of n rows
// that the card can hold at once (cudaOccupancyMaxActiveClusters), or minus
// the CUDA error code.
extern "C" int npt_boxqp_wide_clusters(int n, int d) {
  return boxqp::wide_active_clusters(
      boxqp::fista_kernel<boxqp::kFistaMpcRes, boxqp::kHighest, boxqp::kHighest, boxqp::WideTile>,
      n, d);
}
