"""Benchmark plants (port of numpower_tpu/models/plants.py, LTI part).

  #1 double-integrator LQR       (2-state, 1-input)
  #4 quadrotor trajopt           (12-state linearized hover, 4-input)

An LTI plant is an (A, B) pair of host numpy fp32 arrays, discrete-time (dt
pre-applied). The nonlinear step functions (cartpole, pendulum, unicycle,
planar quadrotor) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

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
