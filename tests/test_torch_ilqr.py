"""models/ilqr.py of numpower_tpu_torch against the JAX package, on the same
numpy inputs (CPU).

One deterministic backward pass, one forward pass and the trajectory cost are
held tightly (rtol 1e-4, atol 1e-5: the same fp32 formulas, summed in another
order). Full solves are held to the JAX package's documented cross-backend
bound on the cost, rtol 1e-2 and atol 1e-3 (tests/test_kernels.py:176): the
cartpole is chaotic, and two correct backends may take different line-search
branches (ROADMAP.md, queue 3). The fused backend's kernels run their plain
versions here; the JAX side runs its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.models import ilqr as jilqr  # noqa: E402
from numpower_tpu_torch.kernels import ilqr_backward, ilqr_forward  # noqa: E402
from numpower_tpu_torch.models import ilqr as tilqr  # noqa: E402

# the JAX package's iLQR test problem (tests/test_kernels.py:166-176)
Q = np.eye(4, dtype=np.float32)
R = np.eye(1, dtype=np.float32) * 0.01
QF = np.eye(4, dtype=np.float32) * 10.0
GOAL = np.zeros(4, np.float32)
COST_BOUND = dict(rtol=1e-2, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x0s(N, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal((N, 4))).astype(np.float32)


def _linearized(N, T, seed=0):
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(_x0s(N, seed))
    us = jnp.asarray((0.1 * rng.standard_normal((N, T, 1))).astype(np.float32))
    xs = jax.vmap(lambda a, b: jm.rollout_nonlinear(jm.cartpole_step, a, b))(x0s, us)
    As, Bs = jax.vmap(lambda x, u: jm.linearize_trajectory(jm.cartpole_step, x, u))(xs, us)
    return x0s, us, xs, As, Bs


def test_total_cost_matches_jax():
    _, us, xs, _, _ = _linearized(3, 12)
    want = jax.vmap(lambda x, u: jilqr._total_cost(x, u, Q, R, QF, GOAL))(xs, us)
    got = tilqr._total_cost(_t(xs), _t(us), _t(Q), _t(R), _t(QF), _t(GOAL))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("penalty", [False, True], ids=["plain", "al_penalty"])
def test_backward_pass_matches_jax(penalty):
    N, T = 3, 12
    _, us, xs, As, Bs = _linearized(N, T)
    rng = np.random.default_rng(4)
    lu_pen = rng.standard_normal((N, T, 1)).astype(np.float32) if penalty else None
    luu_pen = rng.uniform(0.0, 2.0, (N, T, 1)).astype(np.float32) if penalty else None
    ks_t, Ks_t = tilqr._backward_pass(
        _t(As), _t(Bs), _t(xs), _t(us), _t(Q), _t(R), _t(QF), _t(GOAL), 1e-3,
        lu_pen=None if lu_pen is None else _t(lu_pen),
        luu_pen=None if luu_pen is None else _t(luu_pen))
    for i in range(N):  # the JAX function is per scenario; the port's takes the batch
        ks_j, Ks_j = jilqr._backward_pass(
            As[i], Bs[i], xs[i], us[i], Q, R, QF, GOAL, 1e-3,
            lu_pen=None if lu_pen is None else jnp.asarray(lu_pen[i]),
            luu_pen=None if luu_pen is None else jnp.asarray(luu_pen[i]))
        np.testing.assert_allclose(ks_t[i].numpy(), np.asarray(ks_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(Ks_t[i].numpy(), np.asarray(Ks_j), rtol=1e-4, atol=1e-5)


def test_forward_pass_matches_jax_for_every_alpha():
    N, T = 3, 12
    x0s, us, xs, As, Bs = _linearized(N, T)
    ks, Ks = jax.vmap(lambda A, B, x, u: jilqr._backward_pass(A, B, x, u, Q, R, QF, GOAL, 1e-3))(
        As, Bs, xs, us)
    alphas = np.array([1.0, 0.3, 0.01], np.float32)
    us_t, xs_t = tilqr._forward_pass(tm.cartpole_step, _t(x0s), _t(xs), _t(us), _t(ks), _t(Ks),
                                     _t(alphas)[:, None, None])
    assert us_t.shape == (3, N, T, 1) and xs_t.shape == (3, N, T + 1, 4)
    for a, alpha in enumerate(alphas):
        us_j, xs_j = jax.vmap(lambda x0, x, u, k, K: jilqr._forward_pass(
            jm.cartpole_step, x0, x, u, k, K, float(alpha)))(x0s, xs, us, ks, Ks)
        np.testing.assert_allclose(us_t[a].numpy(), np.asarray(us_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(xs_t[a].numpy(), np.asarray(xs_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_fd", [False, True], ids=["jacfwd", "fd"])
def test_ilqr_solve_matches_jax(use_fd):
    x0 = _x0s(1)[0]
    kw = dict(horizon=12, iters=3, use_fd=use_fd)
    want = jm.ilqr_solve(jm.cartpole_step, jnp.asarray(x0), Q, R, QF, GOAL, **kw)
    got = tm.ilqr_solve(tm.cartpole_step, _t(x0), Q, R, QF, GOAL, unroll_scans=True, **kw)
    assert got.us.shape == (12, 1) and got.xs.shape == (13, 4) and got.costs.shape == (3,)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), **COST_BOUND)
    np.testing.assert_allclose(float(got.cost), float(want.cost), **COST_BOUND)
    assert bool((got.costs[1:] <= got.costs[:-1]).all())


def test_ilqr_solve_batched_backends_match_jax():
    x0s = _x0s(3)
    kw = dict(iters=3)
    want_v = jm.ilqr_solve_batched(jm.cartpole_step, jnp.asarray(x0s), Q, R, QF, GOAL, 10, **kw)
    want_f = jm.ilqr_solve_batched(jm.cartpole_step, jnp.asarray(x0s), Q, R, QF, GOAL, 10,
                                   backend="fused", interpret=True, **kw)
    got_v = tm.ilqr_solve_batched(tm.cartpole_step, _t(x0s), Q, R, QF, GOAL, 10, **kw)
    before = ilqr_backward.ilqr_backward_fused.launches
    got_f = tm.ilqr_solve_batched(tm.cartpole_step, _t(x0s), Q, R, QF, GOAL, 10,
                                  backend="fused", **kw)
    assert ilqr_backward.ilqr_backward_fused.launches == before  # no kernel on the CPU
    for got, want in ((got_v, want_v), (got_f, want_f)):
        assert got.us.shape == (3, 10, 1) and got.costs.shape == (3, 3)
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), **COST_BOUND)
        np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), **COST_BOUND)
    # the two backends of the port, one against the other (the JAX package's bound)
    np.testing.assert_allclose(got_f.cost.numpy(), got_v.cost.numpy(), **COST_BOUND)
    # a batch solves each scenario as ilqr_solve does (the batched products
    # round otherwise than one scenario's, so the cost bound again)
    one = tm.ilqr_solve(tm.cartpole_step, _t(x0s[1]), Q, R, QF, GOAL, 10, **kw)
    np.testing.assert_allclose(got_v.costs[1].numpy(), one.costs.numpy(), **COST_BOUND)


def test_fused_forward_routes_agree_on_cpu():
    """forward="kernel" runs K8's wrapper, which on a CPU tensor is the plain
    rollout of forward="plain": the same solve to the bit."""
    x0s = _t(_x0s(4, seed=6))
    kw = dict(horizon=8, iters=2, backend="fused", us_init=np.full((8, 1), 0.1, np.float32))
    before = ilqr_forward.ilqr_forward_fused.launches
    a = tm.ilqr_solve_batched(tm.cartpole_step, x0s, Q, R, QF, GOAL, forward="kernel", **kw)
    b = tm.ilqr_solve_batched(tm.cartpole_step, x0s, Q, R, QF, GOAL, forward="plain", **kw)
    assert torch.equal(a.us, b.us) and torch.equal(a.cost, b.cost)
    assert ilqr_forward.ilqr_forward_fused.launches == before


def test_options_are_checked():
    x0s = _t(_x0s(2))
    with pytest.raises(ValueError, match="backend"):
        tm.ilqr_solve_batched(tm.cartpole_step, x0s, Q, R, QF, GOAL, 5, backend="pallas")
    with pytest.raises(ValueError, match="forward"):  # JAX's "xla" is taken, this is not
        tm.ilqr_solve_batched(tm.cartpole_step, x0s, Q, R, QF, GOAL, 5, backend="fused",
                              forward="cuda")
    # the vmap backend drops the fused-only knob, as the JAX package does
    r = tm.ilqr_solve_batched(tm.cartpole_step, x0s, Q, R, QF, GOAL, 5, iters=1, forward="plain")
    assert r.us.shape == (2, 5, 1)


DEVICE_CALLS = {
    "ilqr_solve": lambda x0s: tm.ilqr_solve(tm.cartpole_step, x0s[0], Q, R, QF, GOAL, 4, iters=1),
    "ilqr_solve_batched_vmap": lambda x0s: tm.ilqr_solve_batched(
        tm.cartpole_step, x0s, Q, R, QF, GOAL, 4, iters=1),
    "ilqr_solve_batched_fused": lambda x0s: tm.ilqr_solve_batched(
        tm.cartpole_step, x0s, Q, R, QF, GOAL, 4, backend="fused", iters=1),
}


@pytest.mark.parametrize("call", list(DEVICE_CALLS.values()), ids=list(DEVICE_CALLS))
def test_entry_points_default_to_the_card(call):
    """A numpy state goes to the card as float32: without CUDA the call
    raises, because it reaches for it; CPU tensors keep the solve on the CPU."""
    x0s = _x0s(2)
    if torch.cuda.is_available():
        got = call(x0s)
        assert got.us.device.type == "cuda" and got.us.dtype == torch.float32
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(x0s)
    assert call(_t(x0s)).us.device.type == "cpu"
