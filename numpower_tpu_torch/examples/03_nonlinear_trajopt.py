"""Nonlinear trajectory optimization: iLQR, AL-iLQR (box constraints), MPPI
(the port of examples/03_nonlinear_trajopt.py).

Run from the repository root (on the card; --device cpu for the CPU):
    PYTHONPATH=. python numpower_tpu_torch/examples/03_nonlinear_trajopt.py
"""

import argparse
import math

import torch

from numpower_tpu_torch.models import (
    al_ilqr_solve, cartpole_step, ilqr_solve, mppi_solve, pendulum_step,
    quadratic_mppi_cost, unicycle_step,
)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)


def t(x):
    return torch.tensor(x, dtype=torch.float32, device=dev)


# iLQR: cartpole swing toward upright
x0 = t([0.0, math.pi, 0.0, 0.0])
Q = torch.diag(t([1.0, 10.0, 0.1, 0.1]))
R = torch.eye(1, device=dev) * 0.01
QF = torch.diag(t([10.0, 100.0, 1.0, 1.0]))
res = ilqr_solve(cartpole_step, x0, Q, R, QF, torch.zeros(4, device=dev), horizon=60,
                 iters=30, unroll_scans=True)
print(f"iLQR cartpole: cost {float(res.costs[0]):.1f} -> {float(res.cost):.1f}")

# AL-iLQR: pendulum swing-up with |u| <= 2 (a hard constraint, not a clip)
Qp = torch.diag(t([1.0, 0.1]))
Rp = torch.eye(1, device=dev) * 0.01
QFp = torch.diag(t([100.0, 10.0]))
res = al_ilqr_solve(pendulum_step, t([math.pi, 0.0]), Qp, Rp, QFp, torch.zeros(2, device=dev),
                    horizon=80, u_lo=-2.0, u_hi=2.0)
print(f"AL-iLQR pendulum: cost {float(res.cost):.1f}, "
      f"max|u| {float(res.us.abs().max()):.3f} (box 2.0), "
      f"violation {float(res.max_violation):.1e}")

# MPPI: sampling control on the nonholonomic unicycle
goal = t([1.0, 1.0, 0.0])
cost_fn = quadratic_mppi_cost(torch.diag(t([1.0, 1.0, 0.0])), torch.eye(2) * 0.01,
                              torch.diag(t([50.0, 50.0, 0.0])), goal)
res = mppi_solve(unicycle_step, torch.zeros(3, device=dev), cost_fn, horizon=30,
                 generator=torch.Generator(device=dev).manual_seed(0), samples=512, iters=15,
                 lam=0.5, sigma=1.0, m=2)
print(f"MPPI unicycle final position: {res.xs[-1][:2].tolist()} (goal [1, 1]), "
      f"ESS {float(res.ess):.0f}/512")
