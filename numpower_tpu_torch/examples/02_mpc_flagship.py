"""Flagship MPC workflow: a batched quadrotor box-QP and the serving
controller (the port of examples/02_mpc_flagship.py).

Run from the repository root (on the card: the fused box-QP kernels K2 and
K1; --device cpu runs their plain versions):
    PYTHONPATH=. python numpower_tpu_torch/examples/02_mpc_flagship.py
"""

import argparse

import numpy as np
import torch

from numpower_tpu_torch.models import (
    MPCController, condense, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    solve_mpc_state_constrained,
)

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)

A, B = quadrotor12(0.02)
Q = np.eye(12, dtype=np.float32)
R = 0.1 * np.eye(4, dtype=np.float32)
QF = 5 * np.eye(12, dtype=np.float32)
qp = condense(A, B, Q, R, QF, 30, device=dev)

N = 512  # 4096 on the card in BASELINE config #4
x0s = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((N, 12)),
                      dtype=torch.float32, device=dev)

# one-shot batched solves: FISTA and ADMM converge to the same optimum
r1 = solve_mpc_boxqp(qp, x0s, -1.0, 1.0, iters=40)
r2 = solve_mpc_boxqp_admm(qp, x0s, -1.0, 1.0, iters=40)
print(f"FISTA residual {float(r1.residual):.1e}; "
      f"ADMM residuals {float(r2.primal_residual):.1e}/"
      f"{float(r2.dual_residual):.1e}; "
      f"max diff {float((r1.U - r2.U).abs().max()):.1e}")

# state constraints: the full OSQP splitting. ALWAYS check primal_residual:
# bounds that the plant cannot satisfy with |u| <= 1 show up as a large
# residual (infeasibility), not an exception.
r3 = solve_mpc_state_constrained(qp, x0s[:32], -1.0, 1.0, -6.0, 6.0, iters=200)
print(f"state-constrained residual {float(r3.primal_residual.max()):.1e} "
      f"(feasible bounds; +-2 would be infeasible here and report ~2.2)")

# receding-horizon serving: warm-started ticks
ctrl = MPCController(A, B, Q, R, QF, horizon=30, u_lo=-1.0, u_hi=1.0, device=dev)
state = ctrl.init(N)
for tick in range(3):
    u0, state = ctrl.step(state, x0s)  # (N, 4) first-stage controls
print("tick controls shape:", tuple(u0.shape), " plan norm:", float(torch.linalg.norm(u0)))
