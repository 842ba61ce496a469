"""Receding-horizon MPC controller (port of numpower_tpu/models/mpc.py).

One controller object holds a condensed QP and solves a batch of scenarios
every tick, warm-started from the previous plan shifted one stage. On a CUDA
device each tick is one launch of the fused solver kernel plus a few small
tensor ops; there is no host math and no device-to-host wait on the tick path
(the 10 ms real-time budget, BASELINE.md). With a mesh (parallel/mesh.py)
each rank serves its block of the scenarios through the data-parallel
solvers of parallel/sharding.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from numpower_tpu_torch.models.admm import solve_mpc_boxqp_admm
from numpower_tpu_torch.models.boxqp import solve_mpc_boxqp
from numpower_tpu_torch.models.condensed import (
    CondensedQP, admm_coarse_iters, condense, default_coarse_iters,
)
from numpower_tpu_torch.parallel.sharding import solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp
from numpower_tpu_torch.utils.device import default_device


@dataclass
class MPCState:
    """Warm-start state carried between ticks, a checkpointable tree
    (utils/checkpoint.py): a node of torch.utils._pytree whose leaves are
    U_prev and tick, the JAX package's two leaves in its order. The tick
    leaf is a 0-d int32 CPU tensor, as the JAX state's int32 scalar (a
    Python int would be stored as int64); it reads back as an int."""

    U_prev: torch.Tensor  # (N, T*m) previous optimal plans (this rank's block with a mesh)
    tick: int


def _state_flatten(state: MPCState):
    tick = state.tick
    if isinstance(tick, int):
        tick = torch.tensor(tick, dtype=torch.int32)
    return [state.U_prev, tick], None


def _state_unflatten(leaves, context) -> MPCState:
    U_prev, tick = leaves
    if isinstance(tick, (torch.Tensor, np.ndarray, np.generic)) and tick.ndim == 0:
        tick = int(tick)
    return MPCState(U_prev=U_prev, tick=tick)


pytree.register_pytree_node(MPCState, _state_flatten, _state_unflatten,
                            serialized_type_name="numpower_tpu_torch.models.mpc.MPCState")


class MPCController:
    """Batched box-constrained linear MPC with warm starting.

    >>> ctrl = MPCController(A, B, Q, R, QF, horizon=30, u_lo=-1, u_hi=1)  # on the card
    >>> state = ctrl.init(n_scenarios=4096)
    >>> u0, state = ctrl.step(state, x0s)   # (N, m) first-stage controls
    """

    def __init__(self, A, B, Q, R, QF, horizon: int, u_lo: float, u_hi: float,
                 iters: int = 30, coarse_iters: Optional[int] = None,
                 x_ref=None, mesh=None, solver: str = "fista", *, device=None):
        """solver: "fista" (default) or "admm"; the ADMM solver warm-starts
        its z iterate from the shifted previous plan. x_ref is FISTA-only.
        device: where the QP, the state and every tick's solve live
        (default: the mesh's device with a mesh, else the card,
        utils.default_device; pass "cpu" for the CPU).

        mesh: a parallel.mesh.Mesh for multi-device serving. Each rank holds
        its block of the scenarios over the data axis (init, step's x0s) and
        each tick runs parallel/sharding.solve_mpc_boxqp_dp (or _admm_dp)
        on it with the shifted warm start: on a mesh of cards one K2 (K1)
        launch per tick and rank. x_ref is not supported with a mesh (the
        sharded path is the regulation solve)."""
        if mesh is not None and x_ref is not None:
            raise ValueError("mesh serving does not support x_ref")
        if solver not in ("fista", "admm"):
            raise ValueError(f"unknown solver {solver!r} (fista|admm)")
        if solver == "admm" and x_ref is not None:
            raise ValueError("solver='admm' does not support x_ref")
        self.solver = solver
        self.mesh = mesh
        if device is None:
            device = default_device() if mesh is None else mesh.device
        self.device = torch.device(device)
        self.qp: CondensedQP = condense(A, B, Q, R, QF, horizon, device=self.device)
        self.u_lo, self.u_hi = float(u_lo), float(u_hi)
        self.iters = int(iters)
        if coarse_iters is None:
            sched = admm_coarse_iters if solver == "admm" else default_coarse_iters
            self.coarse_iters = sched(self.qp, self.iters)
        else:
            self.coarse_iters = int(coarse_iters)
        self.x_ref = (None if x_ref is None else
                      torch.as_tensor(x_ref, dtype=torch.float32, device=self.device))

    def init(self, n_scenarios: int, *, device=None) -> MPCState:
        """Zero plans for n_scenarios, on ``device`` (default: the
        controller's). With a mesh, n_scenarios is the global count and the
        state holds this rank's block of it."""
        d = self.qp.T * self.qp.m
        device = self.device if device is None else torch.device(device)
        if self.mesh is not None:
            parts = self.mesh.size(self.mesh.axis_names[0])
            if n_scenarios % parts:
                raise ValueError(f"{n_scenarios} scenarios do not split into {parts} blocks")
            n_scenarios //= parts
        return MPCState(U_prev=torch.zeros((n_scenarios, d), dtype=torch.float32,
                                           device=device), tick=0)

    def _step_impl(self, qp: CondensedQP, state: MPCState, x0s: torch.Tensor):
        m = qp.m
        # warm start: shift previous plan one stage, hold last input
        U_shift = torch.cat([state.U_prev[:, m:], state.U_prev[:, -m:]], dim=1)
        if self.mesh is not None:
            dp = solve_mpc_boxqp_admm_dp if self.solver == "admm" else solve_mpc_boxqp_dp
            res = dp(qp, x0s, self.u_lo, self.u_hi, self.mesh, iters=self.iters, U0=U_shift,
                     coarse_iters=self.coarse_iters)
            resid = res.primal_residual if self.solver == "admm" else res.residual
        elif self.solver == "admm":
            res = solve_mpc_boxqp_admm(qp, x0s, self.u_lo, self.u_hi, iters=self.iters,
                                       U0=U_shift, coarse_iters=self.coarse_iters)
            resid = res.primal_residual
        else:
            res = solve_mpc_boxqp(qp, x0s, self.u_lo, self.u_hi, x_ref=self.x_ref,
                                  iters=self.iters, U0=U_shift,
                                  coarse_iters=self.coarse_iters)
            resid = res.residual
        u0 = res.U[:, :m]
        # the counterpart of JAX's buffer donation: the new plan goes into the
        # passed state's own buffer, which the returned state reuses
        state.U_prev.copy_(res.U)
        return u0, MPCState(U_prev=state.U_prev, tick=state.tick + 1), resid

    def step(self, state: MPCState, x0s: torch.Tensor):
        """One tick: returns ((N, m) first-stage controls, new state). A
        numpy x0s is taken in the QP's dtype on the controller's device; with
        a mesh, x0s and the controls are this rank's block.

        The passed state's U_prev buffer is reused in place for the new plan
        (the counterpart of the JAX controller's donation): thread the
        returned state and do not read the passed one afterwards."""
        u0, new_state, _ = self._step_impl(self.qp, state, x0s)
        return u0, new_state

    def step_with_residual(self, state: MPCState, x0s: torch.Tensor):
        """step, also returning the solve's residual (the primal residual for
        ADMM)."""
        return self._step_impl(self.qp, state, x0s)

    def callback_init(self, n_scenarios: int):
        """Initial ctrl_state for a closed-loop simulation: (qp, state)."""
        return (self.qp, self.init(n_scenarios))

    def callback(self):
        """(ctrl_state, x0s, t) -> (u0, ctrl_state); pair with
        ctrl_state0=callback_init(N). t is ignored: the plan is re-solved each
        tick with a warm start."""
        def fn(state, x0s, t):
            qp, mpc_state = state
            u0, new_state, _ = self._step_impl(qp, mpc_state, x0s)
            return u0, (qp, new_state)

        return fn
