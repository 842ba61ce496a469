"""MPCController's serving contract in both packages (the twin of
tests/test_controller_utils.py:87-123): the tick programs behind the
controller (compile_cache_size), the warm-start buffer's donation, the frozen
state and QP with .replace, and two fleets on one controller; and the tick
with its QP-only operands formed once, against the tick of the public entry
points, bit for bit.

On the CPU the port's tick runs eagerly and compile_cache_size() counts the
tick signatures served; on the card it counts the CUDA graphs captured
behind the tick (chip_smoke.py phase 25). JAX invalidates a donated buffer;
the port writes the new plan into the passed state's storage and cannot
invalidate the passed tensor (ROADMAP queue 3, a deliberate difference).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402

COSTS = (np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32) * 0.1,
         np.eye(2, dtype=np.float32) * 10.0)


def _controllers(**kw):
    A, B = jm.double_integrator(0.1)
    args = (A, B, *COSTS)
    opts = dict(horizon=12, u_lo=-1.0, u_hi=1.0, iters=10, **kw)
    return jm.MPCController(*args, **opts), tm.MPCController(*args, **opts, device="cpu")


def _drive(ctrl, state, x, rng, A, B, ticks, to):
    """`ticks` ticks of the closed loop of the JAX test, x <- A x + B u0 +
    0.01 w; returns the last u0, state and x."""
    u0 = None
    for _ in range(ticks):
        u0, state = ctrl.step(state, x)
        x = x @ to(A).T + u0 @ to(B).T + to(0.01 * rng.standard_normal(x.shape).astype(np.float32))
    return u0, state, x


@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_controller_no_retrace_steady_state(solver):
    """11 ticks of one batch size: one tick program in both packages, and
    the same controls."""
    jc, tc = _controllers(solver=solver)
    A, B = jm.double_integrator(0.1)
    x = np.random.default_rng(2).standard_normal((4, 2)).astype(np.float32)
    u_j, _, x_j = _drive(jc, jc.init(4), jnp.asarray(x), np.random.default_rng(3), A, B, 11,
                         jnp.asarray)
    u_t, _, x_t = _drive(tc, tc.init(4), torch.from_numpy(x), np.random.default_rng(3), A, B, 11,
                         torch.from_numpy)
    assert jc.compile_cache_size() == 1
    assert tc.compile_cache_size() == 1, "serving tick retraced"
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-4)


def test_controller_second_batch_size_is_a_second_program():
    jc, tc = _controllers()
    for ctrl, to in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        for n in (4, 4, 4, 6, 6, 4):
            state = ctrl.init(n)
            ctrl.step(state, to(np.ones((n, 2), np.float32)))
    assert jc.compile_cache_size() == 2
    assert tc.compile_cache_size() == 2


def test_controller_state_donated():
    """JAX deletes the donated buffer; the port's returned state holds the
    passed state's storage, which holds the new plan."""
    jc, tc = _controllers()
    j_state = jc.init(4)
    old = j_state.U_prev
    _, j_new = jc.step(j_state, jnp.ones((4, 2), jnp.float32))
    assert old.is_deleted()
    t_state = tc.init(4)
    ptr = t_state.U_prev.data_ptr()
    u0, t_new = tc.step(t_state, torch.ones((4, 2)))
    assert t_new.U_prev.shape == tuple(j_new.U_prev.shape) == (4, 12)
    assert t_new.U_prev.data_ptr() == ptr and t_new.U_prev is t_state.U_prev
    assert t_new.tick == int(j_new.tick) == 1
    np.testing.assert_allclose(t_new.U_prev.numpy(), np.asarray(j_new.U_prev), rtol=0, atol=1e-4)
    np.testing.assert_allclose(u0.numpy(), np.asarray(j_new.U_prev)[:, :1], rtol=0, atol=1e-4)


def test_state_and_qp_are_frozen_with_replace():
    jc, tc = _controllers()
    for ctrl in (jc, tc):
        state = ctrl.init(2)
        moved = state.replace(tick=3)
        assert int(moved.tick) == 3 and int(state.tick) == 0 and moved is not state
        assert moved.U_prev is state.U_prev
        qp = ctrl.qp.replace()
        assert qp is not ctrl.qp and qp.H is ctrl.qp.H and (qp.T, qp.n, qp.m) == (12, 2, 1)
        with pytest.raises(dataclasses.FrozenInstanceError):
            state.tick = 1
        with pytest.raises(dataclasses.FrozenInstanceError):
            ctrl.qp.T = 3
    assert type(tc.init(2).replace(U_prev=torch.ones(2, 12))) is tm.MPCState


def test_two_fleets_on_one_controller():
    """Two states of one batch size ticked in turns on one controller: each
    equals the same fleet ticked alone on a controller of its own, and the
    JAX controller's."""
    jc, tc = _controllers()
    _, alone = _controllers()
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((4, 2)).astype(np.float32) for _ in range(2)]
    t_states = [tc.init(4), tc.init(4)]
    j_states = [jc.init(4), jc.init(4)]
    solo = alone.init(4)
    for t in range(4):
        for k in range(2):
            x = xs[k] * (1.0 - 0.1 * t)
            u_t, t_states[k] = tc.step(t_states[k], torch.from_numpy(x))
            u_j, j_states[k] = jc.step(j_states[k], jnp.asarray(x))
            np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
            if k == 0:
                u_s, solo = alone.step(solo, torch.from_numpy(x))
                assert torch.equal(u_t, u_s) and torch.equal(t_states[0].U_prev, solo.U_prev)
    assert t_states[0].U_prev.data_ptr() != t_states[1].U_prev.data_ptr()
    assert tc.compile_cache_size() == 1


@pytest.mark.parametrize("solver,x_ref", [("fista", False), ("fista", True), ("admm", False)])
def test_tick_with_formed_operands_is_the_public_tick(solver, x_ref):
    """The tick, with what depends on the QP alone formed with the
    controller, gives the controls and plan of the public solve on the
    shifted plan bit for bit (the tick before those operands were hoisted),
    and the JAX controller's within 1e-4. On the CPU the tick takes the
    plain route, which reads the formed rho (ADMM) but not the kernels'
    folds: test_formed_operands_through_the_kernel_route holds those."""
    A, B = jm.quadrotor12(0.02)
    ref = (0.2 * np.random.default_rng(5).standard_normal(12)).astype(np.float32) if x_ref else None
    costs = (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
             np.eye(12, dtype=np.float32) * 5.0)
    kw = dict(iters=30, solver=solver, x_ref=ref)
    tc = tm.MPCController(A, B, *costs, 10, -1.0, 1.0, **kw, device="cpu")
    jc = jm.MPCController(A, B, *costs, 10, -1.0, 1.0, **kw)
    x = (0.3 * np.random.default_rng(0).standard_normal((6, 12))).astype(np.float32)
    state, j_state = tc.init(6), jc.init(6)
    for _ in range(3):
        U_shift = torch.cat([state.U_prev[:, 4:], state.U_prev[:, -4:]], dim=1)
        if solver == "admm":
            want = tm.solve_mpc_boxqp_admm(tc.qp, torch.from_numpy(x), -1.0, 1.0, iters=30,
                                           U0=U_shift, coarse_iters=tc.coarse_iters)
        else:
            want = tm.solve_mpc_boxqp(tc.qp, torch.from_numpy(x), -1.0, 1.0, x_ref=tc.x_ref,
                                      iters=30, U0=U_shift, coarse_iters=tc.coarse_iters)
        u0, state, resid = tc.step_with_residual(state, torch.from_numpy(x))
        u_j, j_state, r_j = jc.step_with_residual(j_state, jnp.asarray(x))
        assert torch.equal(u0, want.U[:, :4]) and torch.equal(state.U_prev, want.U)
        np.testing.assert_allclose(u0.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(resid), float(r_j), rtol=0, atol=1e-4)
        x = 0.9 * x


def _quadrotor_controller(solver="fista", x_ref=None, r=0.1, **kw):
    A, B = jm.quadrotor12(0.02)
    costs = (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * r,
             np.eye(12, dtype=np.float32) * 5.0)
    return tm.MPCController(A, B, *costs, 10, -1.0, 1.0, iters=30, solver=solver, x_ref=x_ref,
                            device="cpu", **kw)


@pytest.mark.parametrize("solver,x_ref", [("fista", False), ("fista", True), ("admm", False)])
def test_formed_operands_through_the_kernel_route(solver, x_ref):
    """The kernel route's plain version on the CPU, the route the card's tick
    takes: the controller's formed operands (FISTA's H' and W, ADMM's Minv
    and folds) give the solve with its operands formed in the call within
    1e-6, and operands formed for another QP (R doubled) do not."""
    from numpower_tpu_torch.models.admm import _solve_mpc_boxqp_admm
    from numpower_tpu_torch.models.boxqp import _solve_mpc_boxqp

    ref = (0.2 * np.random.default_rng(5).standard_normal(12)).astype(np.float32) if x_ref else None
    tc = _quadrotor_controller(solver, ref)
    other = _quadrotor_controller(solver, ref, r=0.2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.3 * rng.standard_normal((6, 12))).astype(np.float32))
    U0 = torch.from_numpy((0.5 * rng.standard_normal((6, 40))).astype(np.float32))

    def solve(formed):
        if solver == "admm":
            return _solve_mpc_boxqp_admm(tc.qp, x, -1.0, 1.0, None, tc._rho, 30, U0, "kernel",
                                         tc.coarse_iters, formed).U
        return _solve_mpc_boxqp(tc.qp, x, -1.0, 1.0, tc.x_ref, 30, "kernel", U0,
                                tc.coarse_iters, formed).U

    formed = (lambda c: c._prepared) if solver == "admm" else (lambda c: c._folds)
    want = solve(None)
    assert (solve(formed(tc)) - want).abs().max() <= 1e-6
    assert (solve(formed(other)) - want).abs().max() > 1e-3


@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_reassigned_qp_is_served(solver):
    """A QP assigned to ``qp`` is served from the next tick on, as the JAX
    controller passes its current QP to every tick: the tick equals that of
    a controller built on the new QP (the same coarse schedule) bit for bit
    and the JAX controller's after the same assignment within 1e-4, and the
    operands are formed again for it."""
    from numpower_tpu_torch.models.boxqp import _solve_mpc_boxqp

    A, B = jm.quadrotor12(0.02)
    Q, QF = np.eye(12, dtype=np.float32), np.eye(12, dtype=np.float32) * 5.0
    R2 = np.eye(4, dtype=np.float32) * 0.2
    tc = _quadrotor_controller(solver)
    fresh = _quadrotor_controller(solver, r=0.2, coarse_iters=tc.coarse_iters)
    jc = jm.MPCController(A, B, Q, np.eye(4, dtype=np.float32) * 0.1, QF, 10, -1.0, 1.0,
                          iters=30, solver=solver)
    x = (0.3 * np.random.default_rng(0).standard_normal((6, 12))).astype(np.float32)
    state, j_state = tc.init(6), jc.init(6)
    _, state = tc.step(state, torch.from_numpy(x))
    _, j_state = jc.step(j_state, jnp.asarray(x))
    tc.qp = fresh.qp.replace()
    jc.qp = jm.condense(A, B, Q, R2, QF, 10)
    twin = tm.MPCState(U_prev=state.U_prev.clone(), tick=state.tick)
    u0, state = tc.step(state, torch.from_numpy(x))
    u_f, _ = fresh.step(twin, torch.from_numpy(x))
    u_j, _ = jc.step(j_state, jnp.asarray(x))
    assert torch.equal(u0, u_f)
    np.testing.assert_allclose(u0.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
    assert tc._prepared_for is tc.qp
    if solver == "admm":
        assert torch.equal(tc._rho, fresh._rho)
    else:
        U0 = torch.zeros((6, 40))
        got, want = (_solve_mpc_boxqp(tc.qp, torch.from_numpy(x), -1.0, 1.0, None, 30, "kernel",
                                      U0, tc.coarse_iters, folds).U
                     for folds in (tc._folds, None))
        assert (got - want).abs().max() <= 1e-6


def test_callback_ticks_eagerly_on_the_qp_it_carries():
    _, tc = _controllers()
    qp, state = tc.callback_init(3)
    u0, (qp2, state2) = tc.callback()((qp, state), torch.ones(3, 2), 0)
    assert qp2 is qp and state2.tick == 1 and u0.shape == (3, 1)
    assert tc.compile_cache_size() == 0
