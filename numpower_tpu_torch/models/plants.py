"""Benchmark plants (port of numpower_tpu/models/plants.py) and the plant
registry of the kernels that run a plant in the kernel.

  #1 double-integrator LQR       (2-state, 1-input)
  #3 cartpole iLQR               (4-state nonlinear, 1-input)
  #4 quadrotor trajopt           (12-state linearized hover, 4-input)
  and the pendulum, unicycle and planar quadrotor (nonlinear extras)

An LTI plant is an (A, B) pair of host numpy fp32 arrays, discrete-time (dt
pre-applied). A nonlinear plant is a torch function f(x, u) -> x_next that
indexes the last axis of x and u, so any batch shape rides along: one
scenario (n,), a batch (N, n), line-search candidates (A, N, n). It returns
the same stacked layout and is differentiable with torch.func.jacfwd.

The registry. A kernel that runs the plant in the kernel (K8,
kernels/ilqr_forward.py) cannot trace a torch function, so each registered
plant pairs its torch function with a CUDA device function of the same
formulas, in the same order, in ``csrc/plants.cuh``. :func:`kernel_plant`
maps a registered function, or a ``functools.partial`` of one that sets
keyword parameters, to the (plant id, n, m, parameter floats) the kernel
takes; :func:`plant_from_jax` maps the JAX package's plant (or a partial of
it) to the port's, by name and keywords, so both packages can be handed the
same plant. The measurement registry beside it does the same for the
estimators' kernels (K11, K12): :func:`first_components` and its device twin
``Measure<0>``, looked up by :func:`kernel_measurement`.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class LTIPlant(NamedTuple):
    """Discrete-time x_{t+1} = A x_t + B u_t, with A (n, n) and B (n, m)
    host numpy arrays."""

    A: np.ndarray
    B: np.ndarray

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.B.shape[-1]

    def step(self, x, u):
        """A x + B u for numpy arrays or tensors (on the tensor's device)."""
        if isinstance(x, torch.Tensor):
            A = torch.as_tensor(self.A, dtype=x.dtype, device=x.device)
            B = torch.as_tensor(self.B, dtype=x.dtype, device=x.device)
            return A @ x + B @ u
        return self.A @ x + self.B @ u


def double_integrator(dt: float = 0.1) -> LTIPlant:
    """BASELINE config #1: 1-D double integrator (pos, vel) with force input."""
    A = np.array([[1.0, dt], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * dt * dt], [dt]], np.float32)
    return LTIPlant(A, B)


def quadrotor12(dt: float = 0.02) -> LTIPlant:
    """BASELINE config #4: 12-state quadrotor linearized about hover.

    State: [pos(3), vel(3), rpy(3), angular rate(3)];
    inputs: [total thrust delta, body torques(3)] (mass/inertia normalized).
    Horizontal accelerations couple to roll/pitch via gravity tilt; yaw is
    decoupled; altitude couples to thrust.
    """
    g = 9.81
    n, m = 12, 4
    A = np.eye(n, dtype=np.float32)
    # pos += vel*dt
    A[0, 3] = A[1, 4] = A[2, 5] = dt
    # horizontal vel += g*tilt*dt  (x couples to pitch(7), y to -roll(6))
    A[3, 7] = g * dt
    A[4, 6] = -g * dt
    # attitude += rate*dt
    A[6, 9] = A[7, 10] = A[8, 11] = dt
    B = np.zeros((n, m), np.float32)
    # thrust -> vertical acceleration; torques -> angular accelerations
    B[5, 0] = dt
    B[9, 1] = B[10, 2] = B[11, 3] = dt
    return LTIPlant(A, B)


def _parts(x, k: int):
    """The first k components of the last axis, each kept as a (..., 1)
    slice: a 0-dim component would let a Python float promote its tangent to
    float64 under torch.func.jacfwd, which a slice does not."""
    return [x[..., i:i + 1] for i in range(k)]


def cartpole_params():
    return dict(mc=1.0, mp=0.1, l=0.5, g=9.81, dt=0.05)


def cartpole_step(x, u, mc=1.0, mp=0.1, l=0.5, g=9.81, dt=0.05):
    """BASELINE config #3: nonlinear cartpole, semi-implicit Euler.

    State [pos, theta, vel, theta_dot]; input: cart force (1,)."""
    pos, th, v, w = _parts(x, 4)
    f, = _parts(u, 1)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    total_m = mc + mp
    tmp = (f + mp * l * w * w * sin_t) / total_m
    th_acc = (g * sin_t - cos_t * tmp) / (l * (4.0 / 3.0 - mp * cos_t * cos_t / total_m))
    x_acc = tmp - mp * l * th_acc * cos_t / total_m
    v2 = v + x_acc * dt
    w2 = w + th_acc * dt
    return torch.cat([pos + v2 * dt, th + w2 * dt, v2, w2], dim=-1)


def pendulum_step(x, u, g=9.81, l=1.0, m=1.0, dt=0.05):
    """Simple pendulum swing-up plant (extra nonlinear test case).
    State [theta, theta_dot]; input torque (1,)."""
    th, w = _parts(x, 2)
    f, = _parts(u, 1)
    w2 = w + (-(g / l) * torch.sin(th) + f / (m * l * l)) * dt
    return torch.cat([th + w2 * dt, w2], dim=-1)


def unicycle_step(x, u, dt=0.1):
    """Unicycle / differential-drive kinematics (nonholonomic: linearization
    loses controllability at rest). State [px, py, heading]; input [forward
    speed, turn rate]."""
    px, py, th = _parts(x, 3)
    v, w = _parts(u, 2)
    return torch.cat([
        px + v * torch.cos(th) * dt,
        py + v * torch.sin(th) * dt,
        th + w * dt,
    ], dim=-1)


def planar_quadrotor_step(x, u, m=1.0, l=0.3, inertia=0.1, g=9.81, dt=0.05):
    """Planar quadrotor (2-D VTOL): 6-state, 2 thrust inputs.
    State [px, pz, phi, vx, vz, phi_dot]; input [f1, f2] rotor thrusts."""
    px, pz, phi, vx, vz, w = _parts(x, 6)
    f1, f2 = _parts(u, 2)
    ft = f1 + f2
    ax = -ft * torch.sin(phi) / m
    az = ft * torch.cos(phi) / m - g
    aphi = l * (f1 - f2) / inertia
    vx2, vz2, w2 = vx + ax * dt, vz + az * dt, w + aphi * dt
    return torch.cat([px + vx2 * dt, pz + vz2 * dt, phi + w2 * dt,
                      vx2, vz2, w2], dim=-1)


class KernelPlant(NamedTuple):
    """A registered plant as the kernels take it: the PLANT index of its
    device function in csrc/plants.cuh, its dimensions, and the floats that
    function reads, in its order."""

    plant_id: int
    n: int
    m: int
    params: tuple


class _Entry(NamedTuple):
    plant_id: int
    n: int
    m: int
    # keyword parameters -> the device function's floats. The products and
    # sums of Python floats are formed here in double, as the torch function
    # forms them before they meet a tensor.
    pack: Callable[..., tuple]


_REGISTRY = {
    cartpole_step: _Entry(0, 4, 1, lambda mc, mp, l, g, dt: (mc + mp, mp * l, mp, l, g, dt)),
    pendulum_step: _Entry(1, 2, 1, lambda g, l, m, dt: (-(g / l), m * l * l, dt)),
    unicycle_step: _Entry(2, 3, 2, lambda dt: (dt,)),
    planar_quadrotor_step: _Entry(3, 6, 2, lambda m, l, inertia, g, dt: (m, l, inertia, g, dt)),
}
MAX_PLANT_PARAMS = 8  # csrc/plants.cuh kMaxParams


def _split_partial(f):
    """(function, keyword parameters) of f or of a functools.partial of f
    that sets keywords only; None for a partial with positional arguments."""
    if isinstance(f, functools.partial):
        if f.args:
            return None
        return f.func, dict(f.keywords)
    return f, {}


def kernel_plant(f) -> Optional[KernelPlant]:
    """The kernel form of plant f, or None when f is not registered.

    f is a registered function or a functools.partial of one that sets some
    of its keyword parameters (the others keep their defaults); each
    parameter enters the kernel as a float. A keyword the function does not
    have raises TypeError, as calling the partial would."""
    split = _split_partial(f)
    if split is None:
        return None
    fn, kw = split
    try:
        entry = _REGISTRY.get(fn)
    except TypeError:  # an unhashable callable is not registered
        return None
    if entry is None:
        return None
    bound = inspect.signature(fn).bind_partial(None, None, **kw)
    bound.apply_defaults()
    params = {k: float(v) for k, v in list(bound.arguments.items())[2:]}
    return KernelPlant(entry.plant_id, entry.n, entry.m, tuple(entry.pack(**params)))


def first_components(x, k: int = 1):
    """The measurement y = x[..., :k]: the first k state components (a
    position or an angle), the measurement model of every estimator caller
    in the repository (the JAX package's ``lambda x: x[:1]``)."""
    return x[..., :k]


class KernelMeasurement(NamedTuple):
    """A registered measurement as the kernels take it: the index H of its
    device function Measure<H> in csrc/plants.cuh and its output width p."""

    measure_id: int
    p: int


# function -> (measure id, keyword parameters -> output width p)
_MEASUREMENTS = {first_components: (0, lambda k: int(k))}


def kernel_measurement(h) -> Optional[KernelMeasurement]:
    """The kernel form of measurement h, or None when h is not registered.
    h is a registered function or a functools.partial of one that sets its
    keyword parameters, as for :func:`kernel_plant`."""
    split = _split_partial(h)
    if split is None:
        return None
    fn, kw = split
    try:
        entry = _MEASUREMENTS.get(fn)
    except TypeError:
        return None
    if entry is None:
        return None
    bound = inspect.signature(fn).bind_partial(None, **kw)
    bound.apply_defaults()
    return KernelMeasurement(entry[0], entry[1](**dict(list(bound.arguments.items())[1:])))


def plant_from_jax(f):
    """The port's plant for the JAX package's plant function f, or for a
    functools.partial of one that sets keyword parameters: the function of
    the same name here, with the same keywords. Reads names only; imports
    no jax."""
    split = _split_partial(f)
    fn = None if split is None else split[0]
    module = getattr(fn, "__module__", "") or ""
    port = {g.__name__: g for g in _REGISTRY}.get(getattr(fn, "__name__", None))
    if port is None or not module.startswith("numpower_tpu.models"):
        raise ValueError(f"{f!r} is not a plant of numpower_tpu.models.plants that the "
                         f"port has ({', '.join(g.__name__ for g in _REGISTRY)})")
    kw = split[1]
    return functools.partial(port, **kw) if kw else port
