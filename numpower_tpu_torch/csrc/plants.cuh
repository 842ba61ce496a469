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
//    rollout (K8, K12), S = Dual<n> for the value and the Jacobian in one
//    evaluation (K11). The controls and parameters stay float: the EKF
//    differentiates in x only. With S = float every operation is the float
//    one it always was.

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

// A forward-mode dual number with K tangents: the value and K directional
// derivatives, so that one evaluation of a plant on Dual<n> gives its value
// and every column of its Jacobian (K11: A = df/dx and C = dh/dx, one
// evaluation each a step). The operations follow JAX's jvp rules, each
// tangent term one IEEE operation as above, tangent by tangent:
// d(ab) = da b + a db, d(a/b) = da / b - (a/b) db / b, d sin a = cos a da,
// d cos a = -(sin a) da; a float operand has no tangent. Tangent k is thus
// the same operations on the same operands as a single-tangent pass seeded
// with basis vector k, and the value part is the float plant's.
template <int K>
struct Dual {
  float v, t[K];
};

// The dual number of value v whose tangent k is tangent(k).
template <int K, class Fn>
__device__ __forceinline__ Dual<K> dual(float v, Fn tangent) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.t[k] = tangent(k);
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> mul(Dual<K> a, Dual<K> b) {
  return dual<K>(mul(a.v, b.v), [&](int k) { return add(mul(a.t[k], b.v), mul(a.v, b.t[k])); });
}
template <int K>
__device__ __forceinline__ Dual<K> mul(float a, Dual<K> b) {
  return dual<K>(mul(a, b.v), [&](int k) { return mul(a, b.t[k]); });
}
template <int K>
__device__ __forceinline__ Dual<K> mul(Dual<K> a, float b) {
  return dual<K>(mul(a.v, b), [&](int k) { return mul(a.t[k], b); });
}
template <int K>
__device__ __forceinline__ Dual<K> dvd(Dual<K> a, Dual<K> b) {
  const float q = dvd(a.v, b.v);
  return dual<K>(q, [&](int k) { return sub(dvd(a.t[k], b.v), dvd(mul(q, b.t[k]), b.v)); });
}
template <int K>
__device__ __forceinline__ Dual<K> dvd(float a, Dual<K> b) {
  const float q = dvd(a, b.v);
  return dual<K>(q, [&](int k) { return neg(dvd(mul(q, b.t[k]), b.v)); });
}
template <int K>
__device__ __forceinline__ Dual<K> dvd(Dual<K> a, float b) {
  return dual<K>(dvd(a.v, b), [&](int k) { return dvd(a.t[k], b); });
}
template <int K>
__device__ __forceinline__ Dual<K> add(Dual<K> a, Dual<K> b) {
  return dual<K>(add(a.v, b.v), [&](int k) { return add(a.t[k], b.t[k]); });
}
template <int K>
__device__ __forceinline__ Dual<K> add(float a, Dual<K> b) {
  b.v = add(a, b.v);
  return b;
}
template <int K>
__device__ __forceinline__ Dual<K> add(Dual<K> a, float b) {
  a.v = add(a.v, b);
  return a;
}
template <int K>
__device__ __forceinline__ Dual<K> sub(Dual<K> a, Dual<K> b) {
  return dual<K>(sub(a.v, b.v), [&](int k) { return sub(a.t[k], b.t[k]); });
}
template <int K>
__device__ __forceinline__ Dual<K> sub(float a, Dual<K> b) {
  return dual<K>(sub(a, b.v), [&](int k) { return neg(b.t[k]); });
}
template <int K>
__device__ __forceinline__ Dual<K> sub(Dual<K> a, float b) {
  a.v = sub(a.v, b);
  return a;
}
template <int K>
__device__ __forceinline__ Dual<K> neg(Dual<K> a) {
  return dual<K>(neg(a.v), [&](int k) { return neg(a.t[k]); });
}
// One accurate sinf and one cosf of the angle for the value and every
// tangent's factor (probes/ekf_kalman.py counts the range reductions in each
// K11 instance's step loop).
template <int K>
__device__ __forceinline__ Dual<K> sin_(Dual<K> a) {
  const float c = cosf(a.v);
  return dual<K>(sinf(a.v), [&](int k) { return mul(c, a.t[k]); });
}
template <int K>
__device__ __forceinline__ Dual<K> cos_(Dual<K> a) {
  const float s = sinf(a.v);
  return dual<K>(cosf(a.v), [&](int k) { return neg(mul(s, a.t[k])); });
}

// Dual<K> seeded at x with the basis tangents: x[j] carries tangent j.
template <int K>
__device__ __forceinline__ void seed(const float (&x)[K], Dual<K> (&xd)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    xd[j].v = x[j];
#pragma unroll
    for (int k = 0; k < K; ++k) xd[j].t[k] = j == k ? 1.0f : 0.0f;
  }
}

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
