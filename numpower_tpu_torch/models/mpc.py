"""Receding-horizon MPC controller (port of numpower_tpu/models/mpc.py).

One controller object holds a condensed QP and solves a batch of scenarios
every tick, warm-started from the previous plan shifted one stage. There is
no host math and no device-to-host wait on the tick path (the 10 ms
real-time budget, BASELINE.md): what depends on the QP alone (the kernels'
folds, ADMM's rho and factorization) is formed once, with the controller.

On a CUDA device the tick is captured as a CUDA graph, once per tick
signature (batch size, dtype, solver, x_ref or not), and every later tick of
that signature replays it: the counterpart of the JAX controller's one
jitted, donated tick. Its one solver kernel (K2 fista_mpc_res, K1
admm_mpc_res, or K3b fista_boxqp after g with an x_ref) and the few tensor
ops around it are then one launch of the graph. The box [u_lo, u_hi] is
baked into the graph as kernel arguments, which is right because a
controller's box is fixed. With a mesh (parallel/mesh.py) each rank serves
its block of the scenarios through the data-parallel solvers of
parallel/sharding.py, eagerly: their NCCL collectives stay outside any
graph by design. On the CPU the tick is eager too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models.admm import _default_rho, _kernel_folds, _solve_mpc_boxqp_admm
from numpower_tpu_torch.models.boxqp import _solve_mpc_boxqp
from numpower_tpu_torch.models.condensed import (
    CondensedQP, admm_coarse_iters, condense, default_coarse_iters,
)
from numpower_tpu_torch.parallel.sharding import solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp
from numpower_tpu_torch.utils.device import default_device, state_tensor


@dataclass(frozen=True)
class MPCState:
    """Warm-start state carried between ticks, a checkpointable tree
    (utils/checkpoint.py): a node of torch.utils._pytree whose leaves are
    U_prev and tick, the JAX package's two leaves in its order. The tick
    leaf is a 0-d int32 CPU tensor, as the JAX state's int32 scalar (a
    Python int would be stored as int64); it reads back as an int. Frozen,
    as the JAX package's flax.struct.dataclass: :meth:`replace` makes a
    changed copy (a tick writes U_prev's storage in place, which freezing
    the fields allows)."""

    U_prev: torch.Tensor  # (N, T*m) previous optimal plans (this rank's block with a mesh)
    tick: int

    def replace(self, **changes) -> "MPCState":
        """A copy with the named fields changed (dataclasses.replace)."""
        return dataclasses.replace(self, **changes)


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


class _Graph(NamedTuple):
    """One captured tick: the graph, its static input x0s, the plan buffer
    it reads U_prev from and writes the new plan to, and its outputs u0 and
    the residual."""

    graph: torch.cuda.CUDAGraph
    x0s: torch.Tensor
    plan: torch.Tensor
    u0: torch.Tensor
    resid: torch.Tensor


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
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
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
        self._graphs: dict = {}       # tick signature -> _Graph (on the card, no mesh)
        self._signatures: set = set()  # tick signatures served eagerly
        self._plans: dict = {}        # batch size -> the plan buffer of its graphs
        self._prepare()

    def _prepare(self) -> None:
        """Form what the tick's kernels need of self.qp alone, once for each
        QP the controller serves: FISTA's H' and fold W = Sx'(Su'Q)'; ADMM's
        rho, (H + rho I)^{-1} and folds ((rho Minv)', Wc), the same
        operations as each solve makes; on the card past d = 128 (horizons
        above 32 on the quadrotor) also the wide tile's split operand of H'
        or (rho Minv)' (kernels/boxqp_fista._wide_operand), so that a tick
        forms nothing of the QP. A graph reads the QP it was captured
        on, so the graphs and their plan buffers of an earlier QP go."""
        qp = self.qp
        if self.solver == "admm":
            self._rho = _default_rho(qp)
            self._prepared = _kernel_folds(qp, self._rho)
        else:
            self._folds = boxqp_fista._fista_folds(qp.H, qp.Sx.T, qp.SuTQ.T)
        self._prepared_for = qp
        self._graphs.clear()
        self._plans.clear()

    def _captures(self, device: torch.device) -> bool:
        """Whether ticks on `device` are captured: on the card, without a mesh."""
        return self.mesh is None and device.type == "cuda"

    def _plan_buffer(self, n_scenarios: int) -> torch.Tensor:
        """The plan buffer the graphs of batch size n_scenarios read U_prev
        from and write the new plan to."""
        if n_scenarios not in self._plans:
            self._plans[n_scenarios] = torch.zeros((n_scenarios, self.qp.T * self.qp.m),
                                                   dtype=torch.float32, device=self.device)
        return self._plans[n_scenarios]

    def init(self, n_scenarios: int, *, device=None) -> MPCState:
        """Zero plans for n_scenarios, on ``device`` (default: the
        controller's). With a mesh, n_scenarios is the global count and the
        state holds this rank's block of it. On the card without a mesh, the
        first state of each batch size holds the plan buffer of that batch
        size's captured tick, so that a steady tick copies no plan; later
        states get buffers of their own, which each tick copies in and out
        (6-8% of a 0.07-0.12 ms tick at 4096 scenarios on an H100,
        chip_smoke.py phase 25)."""
        d = self.qp.T * self.qp.m
        device = self.device if device is None else torch.device(device)
        if self.mesh is not None:
            parts = self.mesh.size(self.mesh.axis_names[0])
            if n_scenarios % parts:
                raise ValueError(f"{n_scenarios} scenarios do not split into {parts} blocks")
            n_scenarios //= parts
        if device == self.device and self._captures(device) and n_scenarios not in self._plans:
            return MPCState(U_prev=self._plan_buffer(n_scenarios), tick=0)
        return MPCState(U_prev=torch.zeros((n_scenarios, d), dtype=torch.float32,
                                           device=device), tick=0)

    def _step_impl(self, qp: CondensedQP, state: MPCState, x0s: torch.Tensor):
        """The tick's operations (eager, or recorded into a graph): the warm
        start, the solve, the new plan written into the passed state's
        buffer. Returns (u0, new state, residual)."""
        m = qp.m
        # warm start: shift previous plan one stage, hold last input
        U_shift = torch.cat([state.U_prev[:, m:], state.U_prev[:, -m:]], dim=1)
        own = qp is self._prepared_for  # the QP the controller's operands were formed for
        if self.mesh is not None:
            dp = solve_mpc_boxqp_admm_dp if self.solver == "admm" else solve_mpc_boxqp_dp
            res = dp(qp, x0s, self.u_lo, self.u_hi, self.mesh, iters=self.iters, U0=U_shift,
                     coarse_iters=self.coarse_iters)
            resid = res.primal_residual if self.solver == "admm" else res.residual
        elif self.solver == "admm":
            res = _solve_mpc_boxqp_admm(qp, x0s, self.u_lo, self.u_hi, None,
                                        self._rho if own else None, self.iters, U_shift, "auto",
                                        self.coarse_iters, self._prepared if own else None)
            resid = res.primal_residual
        else:
            res = _solve_mpc_boxqp(qp, x0s, self.u_lo, self.u_hi, self.x_ref, self.iters, "auto",
                                   U_shift, self.coarse_iters, self._folds if own else None)
            resid = res.residual
        u0 = res.U[:, :m]
        # the counterpart of JAX's buffer donation: the new plan goes into the
        # passed state's own buffer, which the returned state reuses
        state.U_prev.copy_(res.U)
        return u0, MPCState(U_prev=state.U_prev, tick=state.tick + 1), resid

    def _tick(self, state: MPCState, x0s, with_residual: bool):
        """One tick of the controller's QP: replayed from its graph where the
        tick is captured and the operands fit one (x0s (N, n) and an
        (N, T*m) float32 plan on the controller's card), eager otherwise.
        A replayed tick's residual is None unless with_residual. A QP
        assigned to ``qp`` since the last tick is served from this tick on,
        as the JAX controller passes its current QP to every tick."""
        if self.qp is not self._prepared_for:
            self._prepare()
        x0s = state_tensor(x0s, self.qp.H)
        U = state.U_prev
        key = (tuple(x0s.shape), x0s.dtype, self.solver, self.x_ref is not None)
        fits = (self._captures(x0s.device) and x0s.device == self.device and x0s.ndim == 2
                and U.device == self.device and U.dtype == torch.float32
                and tuple(U.shape) == (x0s.shape[0], self.qp.T * self.qp.m))
        if not fits:
            out = self._step_impl(self.qp, state, x0s)
            self._signatures.add(key + (tuple(U.shape), U.dtype, str(x0s.device)))
            return out
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, state, x0s)
        entry.x0s.copy_(x0s)
        plan = entry.plan
        if U.data_ptr() == plan.data_ptr() and U.stride() == plan.stride():
            entry.graph.replay()
        else:
            # another state of this batch size: its plan in, the graph's back
            # out, and the buffer's holder's plan kept aside meanwhile
            held = plan.clone()
            plan.copy_(U)
            entry.graph.replay()
            U.copy_(plan)
            plan.copy_(held)
        resid = entry.resid.clone() if with_residual else None
        return entry.u0.clone(), MPCState(U_prev=U, tick=state.tick + 1), resid

    def _capture(self, key, state: MPCState, x0s: torch.Tensor):
        """The first tick of a signature: the eager tick, run on a side
        stream on copies of x0s and of the state's plan (its results are
        this tick's), then the capture of the tick on the signature's static
        buffers, which executes nothing. The kernels' wrappers count the
        eager tick's launches and not those they record into the graph, and
        a replay calls no wrapper. A capture that fails raises."""
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            static_x0s = x0s.clone(memory_format=torch.contiguous_format)
            warm = MPCState(U_prev=state.U_prev.clone(), tick=state.tick)
            u0, _, resid = self._step_impl(self.qp, warm, static_x0s)
        stream.wait_stream(side)
        for t in (static_x0s, warm.U_prev, u0, resid):
            t.record_stream(stream)
        plan = self._plan_buffer(x0s.shape[0])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_u0, _, g_resid = self._step_impl(self.qp, MPCState(U_prev=plan, tick=0), static_x0s)
        self._graphs[key] = _Graph(graph, static_x0s, plan, g_u0, g_resid)
        state.U_prev.copy_(warm.U_prev)
        return u0, MPCState(U_prev=state.U_prev, tick=state.tick + 1), resid

    def step(self, state: MPCState, x0s: torch.Tensor):
        """One tick: returns ((N, m) first-stage controls, new state). A
        numpy x0s is taken in the QP's dtype on the controller's device; with
        a mesh, x0s and the controls are this rank's block.

        The passed state's U_prev buffer is reused in place for the new plan
        (the counterpart of the JAX controller's donation): thread the
        returned state and do not read the passed one afterwards."""
        u0, new_state, _ = self._tick(state, x0s, with_residual=False)
        return u0, new_state

    def compile_cache_size(self) -> int:
        """The number of tick programs behind the controller, the counterpart
        of the JAX controller's compiled executables: on the card without a
        mesh, the CUDA graphs captured, one per tick signature (batch size,
        dtype, solver, x_ref or not); on the CPU and with a mesh, where the
        tick runs eagerly, the tick signatures served. In steady state it
        stays 1 for one batch size: growth means the serving path meets new
        shapes or dtypes, and each new one costs a capture."""
        return len(self._graphs) + len(self._signatures)

    def step_with_residual(self, state: MPCState, x0s: torch.Tensor):
        """step, also returning the solve's residual (the primal residual for
        ADMM)."""
        return self._tick(state, x0s, with_residual=True)

    def callback_init(self, n_scenarios: int):
        """Initial ctrl_state for a closed-loop simulation: (qp, state)."""
        return (self.qp, self.init(n_scenarios))

    def callback(self):
        """(ctrl_state, x0s, t) -> (u0, ctrl_state); pair with
        ctrl_state0=callback_init(N). t is ignored: the plan is re-solved each
        tick with a warm start (eagerly, on the QP the state carries)."""
        def fn(state, x0s, t):
            qp, mpc_state = state
            u0, new_state, _ = self._step_impl(qp, mpc_state, x0s)
            return u0, (qp, new_state)

        return fn
