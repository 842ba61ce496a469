// The registered nonlinear plants and measurements as CUDA device
// functions, for the kernels that run them in the kernel (ilqr_forward.cu,
// ekf.cu, ukf.cu).
//
// Each Plant<P> is the device twin of one torch function of
// numpower_tpu_torch/models/plants.py, registered there under the index P
// (kernel_plant): the same formulas in the same order. The torch function
// is the reference; numpower_tpu/models/plants.py:94-146 is the JAX one.
// Each Measure<H> is the twin of a registered measurement function
// (kernel_measurement) in the same way.
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
//  - step() is a template on the scalar type S of the state: S = float for a
//    rollout (K8, K12), S = Dual for a forward-mode derivative (K11). The
//    controls and parameters stay float: the EKF differentiates in x only.
//    With S = float every operation is the float one it always was.

#pragma once

#include <cuda_runtime.h>

namespace plants {

constexpr int kMaxParams = 8;  // models/plants.py MAX_PLANT_PARAMS

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float neg(float a) { return -a; }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }

// A forward-mode dual number: the value and one directional derivative
// (tangent). The operations follow JAX's jvp rules, each tangent term one
// IEEE operation as above: d(ab) = da b + a db, d(a/b) = da / b - (a/b) db / b,
// d sin a = cos a da, d cos a = -(sin a) da; a float operand has no tangent.
struct Dual {
  float v, t;
};

__device__ __forceinline__ Dual mul(Dual a, Dual b) {
  return {mul(a.v, b.v), add(mul(a.t, b.v), mul(a.v, b.t))};
}
__device__ __forceinline__ Dual mul(float a, Dual b) { return {mul(a, b.v), mul(a, b.t)}; }
__device__ __forceinline__ Dual mul(Dual a, float b) { return {mul(a.v, b), mul(a.t, b)}; }
__device__ __forceinline__ Dual dvd(Dual a, Dual b) {
  const float q = dvd(a.v, b.v);
  return {q, sub(dvd(a.t, b.v), dvd(mul(q, b.t), b.v))};
}
__device__ __forceinline__ Dual dvd(float a, Dual b) {
  const float q = dvd(a, b.v);
  return {q, neg(dvd(mul(q, b.t), b.v))};
}
__device__ __forceinline__ Dual dvd(Dual a, float b) { return {dvd(a.v, b), dvd(a.t, b)}; }
__device__ __forceinline__ Dual add(Dual a, Dual b) { return {add(a.v, b.v), add(a.t, b.t)}; }
__device__ __forceinline__ Dual add(float a, Dual b) { return {add(a, b.v), b.t}; }
__device__ __forceinline__ Dual add(Dual a, float b) { return {add(a.v, b), a.t}; }
__device__ __forceinline__ Dual sub(Dual a, Dual b) { return {sub(a.v, b.v), sub(a.t, b.t)}; }
__device__ __forceinline__ Dual sub(float a, Dual b) { return {sub(a, b.v), neg(b.t)}; }
__device__ __forceinline__ Dual sub(Dual a, float b) { return {sub(a.v, b), a.t}; }
__device__ __forceinline__ Dual neg(Dual a) { return {neg(a.v), neg(a.t)}; }
__device__ __forceinline__ Dual sin_(Dual a) { return {sinf(a.v), mul(cosf(a.v), a.t)}; }
__device__ __forceinline__ Dual cos_(Dual a) { return {cosf(a.v), neg(mul(sinf(a.v), a.t))}; }

template <int P>
struct Plant;

// 0: cartpole_step. p = (mc + mp, mp * l, mp, l, g, dt).
template <>
struct Plant<0> {
  static constexpr int n = 4, m = 1;
  template <class S>
  __device__ static void step(const S* x, const float* u, const float* p, S* out) {
    const float total_m = p[0], mpl = p[1], mp = p[2], l = p[3], g = p[4], dt = p[5];
    const S pos = x[0], th = x[1], v = x[2], w = x[3];
    const float f = u[0];
    const S sin_t = sin_(th), cos_t = cos_(th);
    const S tmp = dvd(add(f, mul(mul(mul(mpl, w), w), sin_t)), total_m);
    const S den = mul(l, sub(4.0f / 3.0f, dvd(mul(mul(mp, cos_t), cos_t), total_m)));
    const S th_acc = dvd(sub(mul(g, sin_t), mul(cos_t, tmp)), den);
    const S x_acc = sub(tmp, dvd(mul(mul(mpl, th_acc), cos_t), total_m));
    const S v2 = add(v, mul(x_acc, dt));
    const S w2 = add(w, mul(th_acc, dt));
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
  template <class S>
  __device__ static void step(const S* x, const float* u, const float* p, S* out) {
    const float neg_g_l = p[0], mll = p[1], dt = p[2];
    const S th = x[0], w = x[1];
    const S w2 = add(w, mul(add(mul(neg_g_l, sin_(th)), dvd(u[0], mll)), dt));
    out[0] = add(th, mul(w2, dt));
    out[1] = w2;
  }
};

// 2: unicycle_step. p = (dt,).
template <>
struct Plant<2> {
  static constexpr int n = 3, m = 2;
  template <class S>
  __device__ static void step(const S* x, const float* u, const float* p, S* out) {
    const float dt = p[0];
    const S px = x[0], py = x[1], th = x[2];
    const float v = u[0], w = u[1];
    out[0] = add(px, mul(mul(v, cos_(th)), dt));
    out[1] = add(py, mul(mul(v, sin_(th)), dt));
    out[2] = add(th, mul(w, dt));
  }
};

// 3: planar_quadrotor_step. p = (m, l, inertia, g, dt).
template <>
struct Plant<3> {
  static constexpr int n = 6, m = 2;
  template <class S>
  __device__ static void step(const S* x, const float* u, const float* p, S* out) {
    const float mass = p[0], l = p[1], inertia = p[2], g = p[3], dt = p[4];
    const S px = x[0], pz = x[1], phi = x[2], vx = x[3], vz = x[4], w = x[5];
    const float f1 = u[0], f2 = u[1];
    const float ft = add(f1, f2);
    const S ax = dvd(mul(-ft, sin_(phi)), mass);
    const S az = sub(dvd(mul(ft, cos_(phi)), mass), g);
    const float aphi = dvd(mul(l, sub(f1, f2)), inertia);
    const S vx2 = add(vx, mul(ax, dt)), vz2 = add(vz, mul(az, dt)), w2 = add(w, mul(aphi, dt));
    out[0] = add(px, mul(vx2, dt));
    out[1] = add(pz, mul(vz2, dt));
    out[2] = add(phi, mul(w2, dt));
    out[3] = vx2;
    out[4] = vz2;
    out[5] = w2;
  }
};

constexpr int kNumPlants = 4;

template <int H>
struct Measure;

// 0: first_components(x, k): y = x[:k], the measurement of every estimator
// caller in the repository (a position or an angle). k = p, the kernel's
// compile-time measurement width.
template <>
struct Measure<0> {
  template <int p, class S>
  __device__ static void eval(const S* x, S* y) {
#pragma unroll
    for (int c = 0; c < p; ++c) y[c] = x[c];
  }
};

constexpr int kNumMeasures = 1;

}  // namespace plants
