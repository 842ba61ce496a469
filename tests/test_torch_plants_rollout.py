"""The nonlinear plants, the plant registry and models/rollout.py of
numpower_tpu_torch against the JAX package, on the same numpy inputs (CPU).

Tolerances. Plant steps, rollouts (T = 16) and exact Jacobians: 1e-5, the
fp32 class of one plant step (torch's and XLA's sin/cos differ by at most one
ulp). Finite-difference Jacobians: the central quotient divides a difference
of two plant steps by 2 eps = 2e-4, so a one-ulp difference of a step
(|x| <= ~3, ulp <= 2.4e-7) moves an entry by up to ~1.2e-3; the JAX and the
port's FD Jacobians are held to 2e-3, and each to the port's exact Jacobian
at the same bound (the quotient's rounding error, the truncation error at
eps = 1e-4 being ~1e-8).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.models import plants as tp  # noqa: E402

PLANTS = {  # name: (n, m)
    "cartpole_step": (4, 1), "pendulum_step": (2, 1), "unicycle_step": (3, 2),
    "planar_quadrotor_step": (6, 2),
}
FD_TOL = 2e-3


def _xu(n, m, shape=(), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, shape + (n,)).astype(np.float32)
    u = rng.uniform(-1.0, 1.0, shape + (m,)).astype(np.float32)
    return x, u


@pytest.mark.parametrize("name", list(PLANTS))
def test_plant_step_matches_jax_on_any_batch_shape(name):
    n, m = PLANTS[name]
    f_j, f_t = getattr(jm, name), getattr(tm, name)
    x, u = _xu(n, m, (3, 5))
    got = f_t(torch.from_numpy(x), torch.from_numpy(u))
    assert got.shape == (3, 5, n)
    want = np.stack([np.stack([np.asarray(f_j(jnp.asarray(x[i, j]), jnp.asarray(u[i, j])))
                               for j in range(5)]) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    one = f_t(torch.from_numpy(x[0, 0]), torch.from_numpy(u[0, 0]))
    assert one.shape == (n,)


def test_cartpole_params_match():
    assert tm.cartpole_params() == jm.cartpole_params()


@pytest.mark.parametrize("name", list(PLANTS))
def test_rollout_nonlinear_matches_jax(name):
    n, m = PLANTS[name]
    x0, _ = _xu(n, m, seed=1)
    us = (0.5 * np.random.default_rng(2).standard_normal((16, m))).astype(np.float32)
    want = jm.rollout_nonlinear(getattr(jm, name), jnp.asarray(x0), jnp.asarray(us))
    got = tm.rollout_nonlinear(getattr(tm, name), torch.from_numpy(x0), torch.from_numpy(us))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the same rollouts batched: (4, 16, m) controls, one op per step
    x0s = np.stack([x0] * 4) + 0.1 * np.arange(4, dtype=np.float32)[:, None]
    uss = np.stack([us] * 4)
    got_b = tm.rollout_nonlinear(getattr(tm, name), torch.from_numpy(x0s), torch.from_numpy(uss))
    want_b = jax.vmap(lambda a, b: jm.rollout_nonlinear(getattr(jm, name), a, b))(
        jnp.asarray(x0s), jnp.asarray(uss))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-5)


def test_lti_rollouts_match_jax():
    rng = np.random.default_rng(3)
    A, B = jm.quadrotor12(0.02)
    x0 = rng.standard_normal(12).astype(np.float32)
    us = rng.standard_normal((16, 4)).astype(np.float32)
    As = (A + 0.01 * rng.standard_normal((16, 12, 12))).astype(np.float32)
    Bs = (B + 0.01 * rng.standard_normal((16, 12, 4))).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tm.rollout_lti(t(A), t(B), t(x0), t(us)).numpy(),
                               np.asarray(jm.rollout_lti(A, B, x0, us)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.rollout_ltv(t(As), t(Bs), t(x0), t(us)).numpy(),
                               np.asarray(jm.rollout_ltv(As, Bs, x0, us)), rtol=0, atol=1e-5)
    x0s = rng.standard_normal((5, 12)).astype(np.float32)
    uss = rng.standard_normal((5, 16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tm.batched_rollout_lti(t(A), t(B), t(x0s), t(uss)).numpy(),
        np.asarray(jm.batched_rollout_lti(A, B, x0s, uss)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(PLANTS))
def test_linearize_matches_jax(name):
    n, m = PLANTS[name]
    x, u = _xu(n, m, seed=4)
    A_j, B_j = jm.linearize(getattr(jm, name), jnp.asarray(x), jnp.asarray(u))
    A_t, B_t = tm.linearize(getattr(tm, name), torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0, atol=1e-5)
    Af_j, Bf_j = jm.linearize_finite_diff(getattr(jm, name), jnp.asarray(x), jnp.asarray(u))
    Af_t, Bf_t = tm.linearize_finite_diff(getattr(tm, name), torch.from_numpy(x),
                                          torch.from_numpy(u))
    np.testing.assert_allclose(Af_t.numpy(), np.asarray(Af_j), rtol=0, atol=FD_TOL)
    np.testing.assert_allclose(Bf_t.numpy(), np.asarray(Bf_j), rtol=0, atol=FD_TOL)
    np.testing.assert_allclose(Af_t.numpy(), A_t.numpy(), rtol=0, atol=FD_TOL)
    np.testing.assert_allclose(Bf_t.numpy(), B_t.numpy(), rtol=0, atol=FD_TOL)


@pytest.mark.parametrize("use_fd", [False, True], ids=["jacfwd", "fd"])
def test_linearize_trajectory_matches_jax_batched(use_fd):
    n, m, T, N = 4, 1, 16, 3
    rng = np.random.default_rng(5)
    x0s = (0.3 * rng.standard_normal((N, n))).astype(np.float32)
    uss = (0.3 * rng.standard_normal((N, T, m))).astype(np.float32)
    xs_j = jax.vmap(lambda a, b: jm.rollout_nonlinear(jm.cartpole_step, a, b))(
        jnp.asarray(x0s), jnp.asarray(uss))
    As_j, Bs_j = jax.vmap(lambda x, u: jm.linearize_trajectory(
        jm.cartpole_step, x, u, use_fd=use_fd))(xs_j, jnp.asarray(uss))
    xs_t = torch.from_numpy(np.array(xs_j))
    As_t, Bs_t = tm.linearize_trajectory(tm.cartpole_step, xs_t, torch.from_numpy(uss),
                                         use_fd=use_fd)
    assert As_t.shape == (N, T, n, n) and Bs_t.shape == (N, T, n, m)
    assert As_t.dtype == Bs_t.dtype == torch.float32
    tol = FD_TOL if use_fd else 1e-5
    np.testing.assert_allclose(As_t.numpy(), np.asarray(As_j), rtol=0, atol=tol)
    np.testing.assert_allclose(Bs_t.numpy(), np.asarray(Bs_j), rtol=0, atol=tol)
    # one trajectory alone gives the same Jacobians as inside the batch
    A1, B1 = tm.linearize_trajectory(tm.cartpole_step, xs_t[1], torch.from_numpy(uss[1]),
                                     use_fd=use_fd)
    torch.testing.assert_close(A1, As_t[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(B1, Bs_t[1], rtol=0, atol=1e-6)


def test_quadratic_cost_matches_jax():
    rng = np.random.default_rng(6)
    Q, R, QF = np.diag([1.0, 2.0, 0.5]).astype(np.float32), np.eye(2, dtype=np.float32), \
        5 * np.eye(3, dtype=np.float32)
    xs = rng.standard_normal((17, 3)).astype(np.float32)
    us = rng.standard_normal((16, 2)).astype(np.float32)
    x_ref = rng.standard_normal(3).astype(np.float32)
    for ref in (None, x_ref):
        want = jm.quadratic_cost(Q, R, QF, None if ref is None else jnp.asarray(ref))(xs, us)
        got = tm.quadratic_cost(torch.from_numpy(Q), torch.from_numpy(R), torch.from_numpy(QF),
                                None if ref is None else torch.from_numpy(ref))(
            torch.from_numpy(xs), torch.from_numpy(us))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_registry_maps_functions_and_partials():
    kp = tp.kernel_plant(tp.cartpole_step)
    assert (kp.plant_id, kp.n, kp.m) == (0, 4, 1)
    assert kp.params == (1.1, 0.1 * 0.5, 0.1, 0.5, 9.81, 0.05)
    kp2 = tp.kernel_plant(functools.partial(tp.cartpole_step, dt=0.02, mc=2.0))
    assert kp2.params == (2.1, 0.05, 0.1, 0.5, 9.81, 0.02)
    assert tp.kernel_plant(tp.pendulum_step).params == (-9.81, 1.0, 0.05)
    assert [tp.kernel_plant(f).plant_id for f in (tp.pendulum_step, tp.unicycle_step,
                                                  tp.planar_quadrotor_step)] == [1, 2, 3]
    assert tp.kernel_plant(lambda x, u: x) is None
    assert tp.kernel_plant(functools.partial(tp.cartpole_step, torch.zeros(4))) is None
    with pytest.raises(TypeError):
        tp.kernel_plant(functools.partial(tp.cartpole_step, mass=1.0))
    assert all(len(tp.kernel_plant(f).params) <= tp.MAX_PLANT_PARAMS for f in tp._REGISTRY)


def test_plant_from_jax():
    assert tp.plant_from_jax(jm.cartpole_step) is tp.cartpole_step
    p = tp.plant_from_jax(functools.partial(jm.pendulum_step, dt=0.1))
    assert p.func is tp.pendulum_step and p.keywords == {"dt": 0.1}
    x, u = _xu(2, 1, seed=7)
    np.testing.assert_allclose(
        p(torch.from_numpy(x), torch.from_numpy(u)).numpy(),
        np.asarray(functools.partial(jm.pendulum_step, dt=0.1)(jnp.asarray(x), jnp.asarray(u))),
        rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tp.plant_from_jax(lambda x, u: x)
    with pytest.raises(ValueError):
        tp.plant_from_jax(tp.cartpole_step)  # already the port's


@pytest.mark.parametrize("name", ["cartpole_step", "pendulum_step"])
def test_rollout_nonlinear_defaults_to_the_card(name):
    """A numpy x0 goes to the card as float32 and us follows it: without CUDA
    the rollout raises, because it reaches for it; with a CPU tensor x0 (us
    still numpy) it runs on the CPU."""
    n, m = PLANTS[name]
    x0, _ = _xu(n, m, shape=(3,), seed=1)
    us = (0.5 * np.random.default_rng(2).standard_normal((3, 6, m))).astype(np.float32)
    f = getattr(tm, name)
    if torch.cuda.is_available():
        got = tm.rollout_nonlinear(f, x0, us)
        assert got.device.type == "cuda" and got.dtype == torch.float32
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tm.rollout_nonlinear(f, x0, us)
    got = tm.rollout_nonlinear(f, torch.from_numpy(x0), us)
    assert got.device.type == "cpu" and got.shape == (3, 7, n)
