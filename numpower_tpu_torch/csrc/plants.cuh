// The registered nonlinear plants as CUDA device functions, for the kernels
// that run a plant in the kernel (ilqr_forward.cu).
//
// Each Plant<P> is the device twin of one torch function of
// numpower_tpu_torch/models/plants.py, registered there under the index P
// (kernel_plant): the same formulas in the same order. The torch function
// is the reference; numpower_tpu/models/plants.py:94-146 is the JAX one.
//  - Each product, quotient, sum and difference is one IEEE operation
//    rounded to nearest (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn), which
//    the compiler never contracts into an FMA, as eager PyTorch runs one
//    operation per kernel. sinf/cosf are the accurate library functions
//    (the build has no --use_fast_math), as torch.sin/torch.cos on the card.
//  - The parameter floats p[] come from the registry's pack function: its
//    products and sums of Python floats (cartpole's mp * l, mc + mp; the
//    pendulum's -(g / l), m * l * l) are formed in double on the host and
//    rounded once, as the torch function forms them before they meet a
//    tensor.
//  - One thread steps one state: x (n), u (m) and the result in registers.

#pragma once

#include <cuda_runtime.h>

namespace plants {

constexpr int kMaxParams = 8;  // models/plants.py MAX_PLANT_PARAMS

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <int P>
struct Plant;

// 0: cartpole_step. p = (mc + mp, mp * l, mp, l, g, dt).
template <>
struct Plant<0> {
  static constexpr int n = 4, m = 1;
  __device__ static void step(const float* x, const float* u, const float* p, float* out) {
    const float total_m = p[0], mpl = p[1], mp = p[2], l = p[3], g = p[4], dt = p[5];
    const float pos = x[0], th = x[1], v = x[2], w = x[3];
    const float f = u[0];
    const float sin_t = sinf(th), cos_t = cosf(th);
    const float tmp = dvd(add(f, mul(mul(mul(mpl, w), w), sin_t)), total_m);
    const float den = mul(l, sub(4.0f / 3.0f, dvd(mul(mul(mp, cos_t), cos_t), total_m)));
    const float th_acc = dvd(sub(mul(g, sin_t), mul(cos_t, tmp)), den);
    const float x_acc = sub(tmp, dvd(mul(mul(mpl, th_acc), cos_t), total_m));
    const float v2 = add(v, mul(x_acc, dt));
    const float w2 = add(w, mul(th_acc, dt));
    out[0] = add(pos, mul(v2, dt));
    out[1] = add(th, mul(w2, dt));
    out[2] = v2;
    out[3] = w2;
  }
};

// 1: pendulum_step. p = (-(g / l), m * l * l, dt).
template <>
struct Plant<1> {
  static constexpr int n = 2, m = 1;
  __device__ static void step(const float* x, const float* u, const float* p, float* out) {
    const float neg_g_l = p[0], mll = p[1], dt = p[2];
    const float th = x[0], w = x[1];
    const float w2 = add(w, mul(add(mul(neg_g_l, sinf(th)), dvd(u[0], mll)), dt));
    out[0] = add(th, mul(w2, dt));
    out[1] = w2;
  }
};

// 2: unicycle_step. p = (dt,).
template <>
struct Plant<2> {
  static constexpr int n = 3, m = 2;
  __device__ static void step(const float* x, const float* u, const float* p, float* out) {
    const float dt = p[0];
    const float px = x[0], py = x[1], th = x[2];
    const float v = u[0], w = u[1];
    out[0] = add(px, mul(mul(v, cosf(th)), dt));
    out[1] = add(py, mul(mul(v, sinf(th)), dt));
    out[2] = add(th, mul(w, dt));
  }
};

// 3: planar_quadrotor_step. p = (m, l, inertia, g, dt).
template <>
struct Plant<3> {
  static constexpr int n = 6, m = 2;
  __device__ static void step(const float* x, const float* u, const float* p, float* out) {
    const float mass = p[0], l = p[1], inertia = p[2], g = p[3], dt = p[4];
    const float px = x[0], pz = x[1], phi = x[2], vx = x[3], vz = x[4], w = x[5];
    const float f1 = u[0], f2 = u[1];
    const float ft = add(f1, f2);
    const float ax = dvd(mul(-ft, sinf(phi)), mass);
    const float az = sub(dvd(mul(ft, cosf(phi)), mass), g);
    const float aphi = dvd(mul(l, sub(f1, f2)), inertia);
    const float vx2 = add(vx, mul(ax, dt)), vz2 = add(vz, mul(az, dt)), w2 = add(w, mul(aphi, dt));
    out[0] = add(px, mul(vx2, dt));
    out[1] = add(pz, mul(vz2, dt));
    out[2] = add(phi, mul(w2, dt));
    out[3] = vx2;
    out[4] = vz2;
    out[5] = w2;
  }
};

constexpr int kNumPlants = 4;

}  // namespace plants
