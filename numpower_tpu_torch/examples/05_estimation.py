"""Estimation family: KF / sqrt-KF / RTS smoother / EKF / UKF / PF / MHE
(the port of examples/05_estimation.py).

Run from the repository root (on the card: the batched filters take the K9,
K10, K11 and K12 kernels; --device cpu runs their plain versions):
    PYTHONPATH=. python numpower_tpu_torch/examples/05_estimation.py
"""

import argparse

import numpy as np
import torch

from numpower_tpu_torch.models import (
    double_integrator, ekf_filter, ekf_filter_batched, kalman_filter, kalman_filter_associative,
    kalman_filter_batched, kalman_filter_sqrt, kalman_smoother, kalman_smoother_batched,
    mhe_solve, particle_filter, pendulum_step, rollout_nonlinear, ukf_filter, ukf_filter_batched,
)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def cpu(x):
    return x.detach().cpu().numpy()


A, B = double_integrator(0.1)
A, C = t(A), t([[1.0, 0.0]])
Q = torch.eye(2, device=dev) * 1e-3
R = torch.eye(1, device=dev) * 1e-2

# simulate noisy data
rng = np.random.default_rng(0)
T = 50
x = np.array([1.0, 0.0])
ys, xs_true = [], []
for _ in range(T):
    x = cpu(A).astype(np.float64) @ x + rng.normal(0, 0.03, 2)
    ys.append([x[0] + rng.normal(0, 0.1)])
    xs_true.append(x.copy())
ys, xs_true = t(ys), np.array(xs_true)

x0, P0 = t([1.0, 0.0]), torch.eye(2, device=dev) * 0.1
filt = kalman_filter(A, C, Q, R, x0, P0, ys)
sm = kalman_smoother(A, filt)
par = kalman_filter_associative(A, C, Q, R, x0, P0, ys)  # O(log T) depth
mhe = mhe_solve(A, C, Q, R, P0, x0, ys[:20], x_lo=t([-10.0, -1.0]), x_hi=t([10.0, 1.0]))


def err(m):
    m = cpu(m)
    return np.abs(m[:, 0] - xs_true[: len(m), 0]).mean()


print(f"measurement err {np.abs(cpu(ys)[:, 0] - xs_true[:, 0]).mean():.4f}")
print(f"filter err      {err(filt.means):.4f}  (ll={float(filt.log_likelihood):.1f})")
print(f"smoother err    {err(sm.means):.4f}")
print(f"parallel == sequential: {float((par.means - filt.means).abs().max()):.1e}")
print(f"MHE window (velocity bounded to [-1,1]): max|v| = {float(mhe.xs[:, 1].abs().max()):.3f}")

# nonlinear: EKF vs UKF on the pendulum with angle-only sensing
us = torch.zeros((40, 1), device=dev)
xs_t = rollout_nonlinear(pendulum_step, t([0.8, 0.0]), us)
ys2 = xs_t[1:, :1] + t(0.03 * rng.standard_normal((40, 1)))


def h(x):
    return x[..., :1]


for name, f in [("EKF", ekf_filter), ("UKF", ukf_filter)]:
    r = f(pendulum_step, h, torch.eye(2, device=dev) * 1e-4, torch.eye(1, device=dev) * 1e-3,
          t([0.5, 0.0]), torch.eye(2, device=dev), ys2, us)
    e = np.abs(cpu(r.means)[:, 0] - cpu(xs_t)[1:, 0]).mean()
    print(f"{name} pendulum angle err: {e:.4f}")

# square-root filter: the same posterior, PSD by construction in fp32
sq = kalman_filter_sqrt(A, C, Q, R, x0, P0, ys)
print(f"sqrt-KF == KF: {float((sq.means - filt.means).abs().max()):.1e}")

# particle filter: the non-Gaussian member (pendulum, angle-only sensing)
pf = particle_filter(pendulum_step, h, torch.eye(2, device=dev) * 1e-4,
                     torch.eye(1, device=dev) * 1e-3, t([0.5, 0.0]), torch.eye(2, device=dev),
                     ys2, us, torch.Generator(device=dev).manual_seed(0), n_particles=2048)
e = np.abs(cpu(pf.means)[:, 0] - cpu(xs_t)[1:, 0]).mean()
print(f"PF pendulum angle err: {e:.4f} (min ESS {float(pf.ess.min()):.0f})")

# batched fleets: ekf/ukf_filter_batched run B trajectories at once; on the
# card they route through the whole-T kernels K11 and K12
Bn = 16
ys_b = ys2.expand((Bn,) + ys2.shape)
us_b = torch.zeros((Bn, 40, 1), device=dev)
x0s_b = t(np.tile([0.5, 0.0], (Bn, 1)) + 0.05 * rng.standard_normal((Bn, 2)))
for name, fb in [("EKF", ekf_filter_batched), ("UKF", ukf_filter_batched)]:
    rb = fb(pendulum_step, h, torch.eye(2, device=dev) * 1e-4, torch.eye(1, device=dev) * 1e-3,
            x0s_b, torch.eye(2, device=dev), ys_b, us_b)
    print(f"batched {name}: {Bn} trajectories, mean ll {float(rb.log_likelihood.mean()):.1f}")

# batched linear fleet + RTS: the shared-covariance filter and the
# shared-gain smoother run the small recursions once and batch only the
# mean passes (the K9 and K10 kernels on the card)
ys_lb = ys.expand((Bn,) + ys.shape)
x0s_lb = t(np.tile([1.0, 0.0], (Bn, 1)) + 0.05 * rng.standard_normal((Bn, 2)))
fb = kalman_filter_batched(A, C, Q, R, x0s_lb, P0, ys_lb)
smb = kalman_smoother_batched(A, fb)
print(f"batched KF+RTS: {Bn} trajectories, smoother err "
      f"{np.abs(cpu(smb.means)[:, :, 0] - xs_true[:, 0]).mean():.4f}")
