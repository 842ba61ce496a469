"""K7 (ilqr_backward_fused) past the narrow envelope (n > 16 or m > 8) in
numpower_tpu_torch, against the JAX package on the same numpy inputs (CPU).

On the CPU the wrapper runs its plain version, ilqr_backward_reference, for
every (n, m); on the card the same (n, m) launch csrc/ilqr_backward_wide.cu
(tests/test_torch_ilqr_cuda.py, chip_smoke.py phase 29). The JAX kernel in
interpret mode takes minutes past n = 16 on the CPU, so the wide shapes are
held to the JAX package's plain recursion (models/al_ilqr._backward_pass_al
under jax.vmap, which is models/ilqr._backward_pass with the penalty terms,
zero for plain iLQR), with lx and
lu formed as its fused solver forms them (models/ilqr.py:236-242), and one
shape with m past 8 but a small n, (4, 12), to the JAX kernel itself. The
solves run on a formation of five planar quadrotors (n = 30, m = 10),
linearized by finite differences: the port's fused backend
(forward="plain") against the JAX package's "vmap".

Tolerances: the backward passes rtol 1e-3, atol 1e-4 (the K7 tests'
bound, tests/test_kernels.py:158-163); the solves' costs the JAX package's
cross-backend bound, rtol 1e-2, atol 1e-3 (tests/test_kernels.py:176), and
AL-iLQR's max_violation its 5e-3 (tests/test_kernels.py:609).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
from numpower_tpu.kernels import ilqr_backward as jkernel  # noqa: E402
from numpower_tpu.models import al_ilqr as jal  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.kernels import ilqr_backward  # noqa: E402
from numpower_tpu_torch.models import ilqr as tilqr  # noqa: E402

BOUND = dict(rtol=1e-3, atol=1e-4)
COST_BOUND = dict(rtol=1e-2, atol=1e-3)
HOVER = 0.5 * 9.81  # a rotor's share of m g at planar_quadrotor_step's defaults
WIDE_SHAPES = [(17, 1), (16, 9), (30, 10), (48, 16)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(N, T, n, m, seed):
    """A random backward-pass problem in numpy float32: As near I, small Bs,
    a trajectory, SPD weights, a goal, and AL penalty terms."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    Gq, Gr = rng.standard_normal((n, n)), rng.standard_normal((m, m))
    return dict(
        As=f32(np.eye(n) + 0.05 * rng.standard_normal((N, T, n, n))),
        Bs=f32(0.3 * rng.standard_normal((N, T, n, m))),
        xs=f32(rng.standard_normal((N, T + 1, n))), us=f32(rng.standard_normal((N, T, m))),
        Q=f32(np.eye(n) + 0.1 * Gq @ Gq.T / n), R=f32(0.1 * np.eye(m) + 0.01 * Gr @ Gr.T / m),
        QF=f32(10.0 * np.eye(n)), goal=f32(rng.standard_normal(n)),
        lu_pen=f32(rng.standard_normal((N, T, m))), luu_pen=f32(rng.uniform(0.0, 2.0, (N, T, m))))


def _terms(p, T, penalty):
    """K7's operands as the JAX package's fused solver forms them
    (models/ilqr.py:236-242), and luu_diags; torch tensors."""
    xs, us, Q, R, QF, goal = (_t(p[k]) for k in ("xs", "us", "Q", "R", "QF", "goal"))
    lus = 2.0 * us @ R.T
    if penalty:
        lus = lus + _t(p["lu_pen"])
    ops = (_t(p["As"]), _t(p["Bs"]), 2.0 * (xs[:, :T] - goal) @ Q.T, lus, 2.0 * Q, 2.0 * R,
           2.0 * (xs[:, T] - goal) @ QF.T, 2.0 * QF)
    return ops, (_t(p["luu_pen"]) if penalty else None)


@jax.jit
def _jax_backward(As, Bs, xs, us, Q, R, QF, goal, lu_pen, luu_pen):
    """The JAX package's backward pass under jax.vmap with the AL penalty
    terms (al_ilqr._backward_pass_al; zero penalties are ilqr._backward_pass
    without them): one compile a shape serves both cases (at m = 16 its
    unrolled SPD solve takes ~9 s to compile on the CPU)."""
    return jax.vmap(lambda A, B, x, u, lp, lpp: jal._backward_pass_al(
        A, B, x, u, Q, R, QF, goal, 1e-3, lp, lpp))(As, Bs, xs, us, lu_pen, luu_pen)


@pytest.mark.parametrize("n,m", WIDE_SHAPES, ids=[f"n{n}-m{m}" for n, m in WIDE_SHAPES])
@pytest.mark.parametrize("penalty", [False, True], ids=["ilqr", "al_penalty"])
def test_wide_backward_matches_jax_plain_recursion(n, m, penalty):
    N, T = 4, 6
    p = _problem(N, T, n, m, seed=n * 10 + m)
    ops, diags = _terms(p, T, penalty)
    ks, Ks = ilqr_backward.ilqr_backward_reference(*ops, reg=1e-3, luu_diags=diags)
    got = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3, luu_diags=diags)  # the CPU route
    assert all(torch.equal(a, b) for a, b in zip(got, (ks, Ks)))
    j = {k: jnp.asarray(v) for k, v in p.items()}
    if not penalty:  # _backward_pass's own default for absent penalties
        j["lu_pen"], j["luu_pen"] = jnp.zeros((N, T, m)), jnp.zeros((N, T, m))
    ks_j, Ks_j = _jax_backward(*(j[k] for k in ("As", "Bs", "xs", "us", "Q", "R", "QF", "goal",
                                                "lu_pen", "luu_pen")))
    assert ks.shape == (N, T, m) and Ks.shape == (N, T, m, n)
    np.testing.assert_allclose(ks.numpy(), np.asarray(ks_j), **BOUND)
    np.testing.assert_allclose(Ks.numpy(), np.asarray(Ks_j), **BOUND)


def test_m_past_8_matches_the_jax_kernel_in_interpret_mode():
    N, T, n, m = 4, 4, 4, 12
    p = _problem(N, T, n, m, seed=412)
    ops, diags = _terms(p, T, penalty=True)
    ks, Ks = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3, luu_diags=diags)
    ks_j, Ks_j = jkernel.ilqr_backward_fused(*(jnp.asarray(x.numpy()) for x in ops), reg=1e-3,
                                             interpret=True, luu_diags=jnp.asarray(p["luu_pen"]))
    np.testing.assert_allclose(ks.numpy(), np.asarray(ks_j), **BOUND)
    np.testing.assert_allclose(Ks.numpy(), np.asarray(Ks_j), **BOUND)


def _formation(k):
    """k planar quadrotors flown as one system (chip_smoke.quad_formation's
    plant and weights): (port's f, JAX's f, Q, R, QF, goal), numpy float32.
    JAX's plant indexes components on the leading axis, the port's on the
    last."""
    def f_t(x, u):
        y = tm.planar_quadrotor_step(x.reshape(*x.shape[:-1], k, 6),
                                     u.reshape(*u.shape[:-1], k, 2))
        return y.reshape(*y.shape[:-2], 6 * k)  # x and u broadcast

    def f_j(x, u):
        return jm.planar_quadrotor_step(x.reshape(k, 6).T, u.reshape(k, 2).T).T.reshape(-1)

    ring = 2 * np.eye(k) - np.roll(np.eye(k), 1, 1) - np.roll(np.eye(k), -1, 1)
    Q = np.eye(6 * k) + np.kron(ring, np.diag([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]))
    goal = np.zeros((k, 6))
    goal[:, 0], goal[:, 1] = np.arange(k), 1.0
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return (f_t, f_j, f32(Q), f32(0.1 * np.eye(2 * k)), f32(10.0 * np.eye(6 * k)),
            f32(goal.reshape(-1)))


def test_formation_plant_matches_jax():
    f_t, f_j, *_ = _formation(5)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 30)).astype(np.float32)
    u = (HOVER + rng.standard_normal((7, 10))).astype(np.float32)
    want = jax.vmap(f_j)(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(f_t(_t(x), _t(u)).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("solver", ["ilqr", "al_ilqr"])
def test_fused_solves_on_the_five_quadrotor_formation_match_jax_vmap(solver, monkeypatch):
    f_t, f_j, Q, R, QF, goal = _formation(5)
    N, T = 4, 10
    x0s = (goal + 0.2 * np.random.default_rng(5).standard_normal((N, 30))).astype(np.float32)
    shapes = []  # the (n, m) of each call of K7's wrapper by the fused backend

    def counted(As, Bs, *args, **kwargs):
        shapes.append((As.shape[-1], Bs.shape[-1]))
        return ilqr_backward.ilqr_backward_fused(As, Bs, *args, **kwargs)

    monkeypatch.setattr(tilqr, "ilqr_backward_fused", counted)
    kw = dict(use_fd=True)  # finite differences: autodiff's compiles would double the time
    if solver == "ilqr":
        got = tm.ilqr_solve_batched(f_t, _t(x0s), Q, R, QF, goal, T, backend="fused",
                                    forward="plain", iters=3, us_init=HOVER, **kw)
        want = jm.ilqr_solve_batched(f_j, jnp.asarray(x0s), Q, R, QF, goal, T, backend="vmap",
                                     iters=3, us_init=jnp.full((T, 10), HOVER, jnp.float32), **kw)
        calls = 3
    else:
        box = (0.0, 8.0)
        got = tm.al_ilqr_solve_batched(f_t, _t(x0s), Q, R, QF, goal, T, *box, backend="fused",
                                       forward="plain", al_iters=2, ilqr_iters=2, us_init=HOVER,
                                       **kw)
        want = jm.al_ilqr_solve_batched(f_j, jnp.asarray(x0s), Q, R, QF, goal, T, *box,
                                        backend="vmap", al_iters=2, ilqr_iters=2,
                                        us_init=jnp.full((T, 10), HOVER, jnp.float32), **kw)
        np.testing.assert_allclose(got.max_violation.numpy(), np.asarray(want.max_violation),
                                   atol=5e-3)
        assert bool(((got.us >= 0.0) & (got.us <= 8.0)).all())
        calls = 4
    assert shapes == [(30, 10)] * calls
    assert got.us.shape == (N, T, 10) and got.xs.shape == (N, T + 1, 30)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), **COST_BOUND)
    assert bool((got.costs[:, 1:] <= got.costs[:, :-1]).all())
