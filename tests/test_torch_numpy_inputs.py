"""numpy operands at the port's entry points, as the JAX package takes them.

The leading operand of each entry point goes through utils.state_tensor and
the others follow it: where the call has a QP or a controller, a numpy
operand is taken in the QP's dtype on its device, so on the CPU the numpy
call equals the CPU-tensor call to the bit; where it has none, the numpy
operand goes to the card as float32, so without CUDA the call raises torch's
error for the missing device (never an AttributeError or a TypeError from a
numpy array handed to torch), and with a card it returns a CUDA float32
tensor.
"""

import numpy as np
import pytest
import torch

import numpower_tpu_torch.models as tm

N, T = 3, 5
A, B = (np.asarray(M, np.float32) for M in tm.double_integrator(0.1))
Q, R = np.eye(2, dtype=np.float32), 0.1 * np.eye(1, dtype=np.float32)
QF = 10 * np.eye(2, dtype=np.float32)
C, P0 = np.array([[1.0, 0.0]], np.float32), 0.1 * np.eye(2, dtype=np.float32)


def _arr(*shape, seed=0, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


X0S = _arr(N, 2)


def _cpu_qp_calls():
    """Calls on a QP or a controller built on the CPU: x -> a tensor."""
    qp = tm.condense(A, B, Q, R, QF, T, device="cpu")
    ctrl = tm.MPCController(A, B, Q, R, QF, horizon=T, u_lo=-0.5, u_hi=0.5, iters=6,
                            device="cpu")
    ctrl_admm = tm.MPCController(A, B, Q, R, QF, horizon=T, u_lo=-0.5, u_hi=0.5, iters=6,
                                 solver="admm", device="cpu")
    return {
        "solve_mpc_boxqp": lambda x: tm.solve_mpc_boxqp(qp, x, -0.5, 0.5, iters=6).U,
        "solve_mpc_boxqp_x_ref": lambda x: tm.solve_mpc_boxqp(
            qp, x, -0.5, 0.5, x_ref=x[0], iters=6, U0=np.full((N, T), 0.1, np.float32)).U,
        "solve_mpc_boxqp_admm": lambda x: tm.solve_mpc_boxqp_admm(qp, x, -0.5, 0.5, iters=6).U,
        "MPCController.step": lambda x: ctrl.step(ctrl.init(N), x)[0],
        "MPCController.step_admm": lambda x: ctrl_admm.step(ctrl_admm.init(N), x)[0],
        "gradient_offset": lambda x: tm.gradient_offset(qp, x),
    }


def _plant(x, u):
    return x @ torch.as_tensor(A, device=x.device).T + u @ torch.as_tensor(B, device=x.device).T


def _gain(K, x, t):
    return -(x @ torch.as_tensor(K, device=x.device).T), K


# Calls with no QP, controller or device: `a` makes every array operand
# (numpy as it is, or a CPU tensor); the first array is the leading operand.
FREE_CALLS = {
    "riccati_scan_per_scenario": lambda a: tm.riccati_scan_per_scenario(
        a(np.stack([A] * N)), a(np.stack([B] * N)), a(Q), a(R), a(QF), T)[0],
    "rollout_lti": lambda a: tm.rollout_lti(a(A), a(B), a(X0S), a(_arr(N, T, 1, seed=1))),
    "rollout_ltv": lambda a: tm.rollout_ltv(a(np.stack([A] * T)), a(np.stack([B] * T)),
                                            a(X0S), a(_arr(N, T, 1, seed=1))),
    "batched_rollout_lti": lambda a: tm.batched_rollout_lti(a(A), a(B), a(X0S),
                                                            a(_arr(N, T, 1, seed=1))),
    "linearize": lambda a: tm.linearize(tm.pendulum_step, a(X0S[0]), a(_arr(1, seed=2)))[0],
    "linearize_finite_diff": lambda a: tm.linearize_finite_diff(
        tm.pendulum_step, a(X0S), a(_arr(N, 1, seed=2)))[0],
    "linearize_trajectory": lambda a: tm.linearize_trajectory(
        tm.pendulum_step, a(_arr(N, T + 1, 2, seed=3)), a(_arr(N, T, 1, seed=2)))[0],
    "quadratic_cost": lambda a: tm.quadratic_cost(a(Q), a(R), a(QF))(
        a(_arr(N, T + 1, 2, seed=3)), a(_arr(N, T, 1, seed=2))),
    "prediction_matrices": lambda a: tm.prediction_matrices(a(A), a(B), T)[1],
    "solve_boxqp_pg": lambda a: tm.solve_boxqp_pg(a(Q + Q.T), a(X0S), -0.5, 0.5, iters=4).U,
    "solve_boxqp_fista": lambda a: tm.solve_boxqp_fista(a(Q + Q.T), a(X0S), -0.5, 0.5,
                                                        iters=4).U,
    "solve_boxqp_admm": lambda a: tm.solve_boxqp_admm(a(Q + Q.T), a(X0S), -0.5, 0.5,
                                                      iters=4).U,
    "simulate_closed_loop": lambda a: tm.simulate_closed_loop(
        _plant, _gain, np.array([[1.0, 1.5]], np.float32), a(X0S), 3).xs,
    "kalman_estimator": lambda a: tm.kalman_estimator(A, C, Q, R, P0)[0](a(X0S))[1][0],
}


@pytest.mark.parametrize("name", [*_cpu_qp_calls(), *FREE_CALLS])
def test_entry_points_accept_numpy(name):
    if name in FREE_CALLS:
        call = FREE_CALLS[name]
        on_cpu = call(torch.from_numpy)
        assert on_cpu.device.type == "cpu" and on_cpu.dtype == torch.float32
        if torch.cuda.is_available():
            got = call(lambda x: x)
            assert got.device.type == "cuda" and got.dtype == torch.float32
            torch.testing.assert_close(got.cpu(), on_cpu, rtol=1e-5, atol=1e-5)
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call(lambda x: x)
        return
    call = _cpu_qp_calls()[name]
    got, want = call(X0S), call(torch.from_numpy(X0S))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert torch.equal(got, want)
