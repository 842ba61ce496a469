"""Output-feedback control: noisy sensing -> Kalman filter -> MPC in one
closed loop (the port of examples/04_output_feedback_loop.py).

Run from the repository root (on the card; --device cpu for the CPU):
    PYTHONPATH=. python numpower_tpu_torch/examples/04_output_feedback_loop.py
"""

import argparse

import numpy as np
import torch

from numpower_tpu_torch.models import (
    MPCController, double_integrator, kalman_estimator, simulate_closed_loop,
)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)

A, B = double_integrator(0.1)
A_t, B_t = torch.as_tensor(A, device=dev), torch.as_tensor(B, device=dev)
C = np.array([[1.0, 0.0]], np.float32)  # position-only sensing
ctrl = MPCController(A, B, np.eye(2, dtype=np.float32), 0.1 * np.eye(1, dtype=np.float32),
                     10 * np.eye(2, dtype=np.float32), horizon=15, u_lo=-1.0, u_hi=1.0,
                     device=dev)
make_state, kf_update = kalman_estimator(
    A, C, np.eye(2, dtype=np.float32) * 1e-4, np.eye(1, dtype=np.float32) * 1e-2,
    np.eye(2, dtype=np.float32) * 0.5, B=B)

N = 16  # parallel closed loops (thousands on the card)
x0s = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, (N, 2)), dtype=torch.float32,
                      device=dev)
res = simulate_closed_loop(
    lambda x, u: x @ A_t.T + u @ B_t.T,    # true plant
    ctrl.callback(), ctrl.callback_init(N),
    x0s, steps=80, generator=torch.Generator(device=dev).manual_seed(1),
    w_std=0.01,                            # process noise
    h=lambda x: x[..., :1], v_std=0.05,    # noisy position measurement
    estimator=kf_update, est_state0=make_state(x0s),
)
xs, xhats = res.xs.cpu().numpy(), res.xhats.cpu().numpy()
final = np.abs(xs[-1]).max()
vel_err = np.abs(xhats[20:, :, 1] - xs[21:, :, 1]).mean()
print(f"{N} closed loops, 80 ticks")
print(f"final max |x|: {final:.3f} (regulated from up to 2.0)")
print(f"velocity estimate error: {vel_err:.3f} (velocity never measured)")
print(f"controls respected the box: max|u| = {float(res.us.abs().max()):.3f} <= 1.0")
