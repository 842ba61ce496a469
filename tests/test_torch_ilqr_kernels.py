"""The iLQR kernels of numpower_tpu_torch (K7 ilqr_backward_fused, K8
ilqr_forward_fused) against the JAX package's Pallas kernels, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs ilqr_backward_fused / ilqr_forward_pallas in interpret mode, as
tests/test_kernels.py does, on the same numpy inputs. Tolerances are the JAX
package's for its kernels: K7 rtol 1e-3, atol 1e-4 (tests/test_kernels.py:
158-163, tests/test_solvers_extra.py:411-433); K8 us/xs atol 1e-4, costs
rtol 1e-5 (tests/test_kernels.py:577-582). K8 is fed the nominal and the
gains of one backward pass, on a short horizon where every line-search
candidate stays near its nominal.

The kernels themselves are held against these plain versions on the card by
tests/test_torch_ilqr_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
from numpower_tpu.kernels.ilqr_backward import ilqr_backward_fused as jax_backward  # noqa: E402
from numpower_tpu.kernels.ilqr_forward import ilqr_forward_pallas  # noqa: E402
from numpower_tpu_torch.kernels import ilqr_backward, ilqr_forward  # noqa: E402
from numpower_tpu_torch.models import plant_from_jax  # noqa: E402

ALPHAS = np.array([1.0, 0.6, 0.3, 0.1, 0.03, 0.01], np.float32)
PLANTS = {  # name: (n, m)
    "cartpole_step": (4, 1), "pendulum_step": (2, 1), "unicycle_step": (3, 2),
    "planar_quadrotor_step": (6, 2),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _trajectory_problem(name, N, T, seed):
    """x0s, us, xs and the linearization (JAX, exact Jacobians) of a rollout
    of small random controls, with the costs Q = I, R = 0.1 I, QF = 10 I."""
    n, m = PLANTS[name]
    f = getattr(jm, name)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray((0.3 * rng.standard_normal((N, n))).astype(np.float32))
    us = jnp.asarray((0.1 * rng.standard_normal((N, T, m))).astype(np.float32))
    xs = jax.vmap(lambda x0, u: jm.rollout_nonlinear(f, x0, u))(x0s, us)
    As, Bs = jax.vmap(lambda x, u: jm.linearize_trajectory(f, x, u))(xs, us)
    Q, R, QF = np.eye(n, dtype=np.float32), 0.1 * np.eye(m, dtype=np.float32), \
        10.0 * np.eye(n, dtype=np.float32)
    goal = np.zeros(n, np.float32)
    lxs = 2.0 * (xs[:, :T] - goal) @ Q.T
    lus = 2.0 * us @ R.T
    lxT = 2.0 * (xs[:, T] - goal) @ QF.T
    return dict(f=f, x0s=x0s, us=us, xs=xs, As=As, Bs=Bs, lxs=lxs, lus=lus, lxT=lxT, Q=Q, R=R,
                QF=QF, goal=goal)


@pytest.mark.parametrize("name,diag", [("cartpole_step", False), ("cartpole_step", True),
                                       ("planar_quadrotor_step", True)])
def test_backward_plain_matches_jax_kernel(name, diag):
    T = 10 if name == "cartpole_step" else 6
    p = _trajectory_problem(name, N=4, T=T, seed=0)
    m = PLANTS[name][1]
    luu_diags = None
    if diag:  # the AL-iLQR active-set Hessian: a nonnegative diagonal per step
        luu_diags = np.random.default_rng(11).uniform(0.0, 2.0, (4, T, m)).astype(np.float32)
    args = (p["lxs"], p["lus"], 2.0 * p["Q"], 2.0 * p["R"], p["lxT"], 2.0 * p["QF"])
    ks_j, Ks_j = jax_backward(p["As"], p["Bs"], *args, reg=1e-3, tile_b=128, interpret=True,
                              luu_diags=None if luu_diags is None else jnp.asarray(luu_diags))
    ks_t, Ks_t = ilqr_backward.ilqr_backward_fused(
        _t(p["As"]), _t(p["Bs"]), _t(p["lxs"]), _t(p["lus"]), 2.0 * p["Q"], 2.0 * p["R"],
        _t(p["lxT"]), 2.0 * p["QF"], reg=1e-3,
        luu_diags=None if luu_diags is None else torch.from_numpy(luu_diags))
    assert ks_t.shape == (4, T, m) and Ks_t.shape == (4, T, m, PLANTS[name][0])
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(Ks_t.numpy(), np.asarray(Ks_j), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", list(PLANTS))
def test_forward_plain_matches_jax_kernel(name):
    N, T = 4, 5
    n, m = PLANTS[name]
    p = _trajectory_problem(name, N=N, T=T, seed=1)
    ks, Ks = (np.asarray(a) for a in ilqr_backward.ilqr_backward_reference(
        _t(p["As"]), _t(p["Bs"]), _t(p["lxs"]), _t(p["lus"]), 2.0 * p["Q"], 2.0 * p["R"],
        _t(p["lxT"]), 2.0 * p["QF"]))
    cost = (jnp.asarray(p["Q"]), jnp.asarray(p["R"]), jnp.asarray(p["QF"]),
            jnp.asarray(p["goal"]))
    us_l, xs_l, c_j = ilqr_forward_pallas(
        p["f"], *cost, jnp.asarray(ALPHAS), p["x0s"], p["xs"][:, :T].transpose(1, 2, 0),
        p["us"].transpose(1, 2, 0), jnp.asarray(ks.transpose(1, 2, 0)),
        jnp.asarray(Ks.transpose(1, 2, 3, 0).reshape(T, m * n, N)), n_alphas=len(ALPHAS),
        interpret=True)
    us_t, xs_t, c_t = ilqr_forward.ilqr_forward_fused(
        plant_from_jax(p["f"]), *(_t(c) for c in cost), _t(ALPHAS), _t(p["x0s"]), _t(p["xs"]),
        _t(p["us"]), _t(ks), _t(Ks))
    assert us_t.shape == (6, N, T, m) and xs_t.shape == (6, N, T + 1, n) and c_t.shape == (6, N)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_l).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_l).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)


def test_backward_reference_follows_the_kernel_recursion():
    """The plain version is the kernel's recursion (Vx' = Qx + Qux'k,
    Vxx' = Qxx + Qux'K, upper triangle mirrored): run in float64 it gives
    the float32 result to fp32 rounding, and it agrees with the full-form
    recursion of models/ilqr._backward_pass only up to rounding."""
    from numpower_tpu_torch.models.ilqr import _backward_pass

    p = _trajectory_problem("cartpole_step", N=3, T=12, seed=2)
    tensors = [_t(p[k]) for k in ("As", "Bs", "lxs", "lus", "lxT")]
    costs = (2.0 * p["Q"], 2.0 * p["R"], 2.0 * p["QF"])
    ks, Ks = ilqr_backward.ilqr_backward_reference(*tensors[:4], costs[0], costs[1], tensors[4],
                                                   costs[2])
    ks64, Ks64 = ilqr_backward.ilqr_backward_reference(
        *(t.double() for t in tensors[:4]), costs[0].astype(np.float64),
        costs[1].astype(np.float64), tensors[4].double(), costs[2].astype(np.float64))
    np.testing.assert_allclose(ks.numpy(), ks64.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Ks.numpy(), Ks64.numpy(), rtol=1e-4, atol=1e-5)
    ks_full, Ks_full = _backward_pass(_t(p["As"]), _t(p["Bs"]), _t(p["xs"]), _t(p["us"]),
                                      _t(p["Q"]), _t(p["R"]), _t(p["QF"]), _t(p["goal"]), 1e-3)
    np.testing.assert_allclose(ks.numpy(), ks_full.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(Ks.numpy(), Ks_full.numpy(), rtol=1e-3, atol=1e-4)


def test_wrappers_on_cpu_take_the_plain_version():
    p = _trajectory_problem("pendulum_step", N=3, T=6, seed=3)
    bwd = (_t(p["As"]), _t(p["Bs"]), _t(p["lxs"]), _t(p["lus"]), 2.0 * p["Q"], 2.0 * p["R"],
           _t(p["lxT"]), 2.0 * p["QF"])
    before = (ilqr_backward.ilqr_backward_fused.launches, ilqr_forward.ilqr_forward_fused.launches)
    ks, Ks = ilqr_backward.ilqr_backward_fused(*bwd, reg=1e-2)
    ks_r, Ks_r = ilqr_backward.ilqr_backward_reference(*bwd, reg=1e-2)
    assert torch.equal(ks, ks_r) and torch.equal(Ks, Ks_r)
    # any torch plant runs on the CPU, registered or not
    f = functools.partial(plant_from_jax(jm.pendulum_step), dt=0.05)
    for plant in (f, lambda x, u: f(x, u)):
        fwd = (plant, _t(p["Q"]), _t(p["R"]), _t(p["QF"]), _t(p["goal"]), _t(ALPHAS),
               _t(p["x0s"]), _t(p["xs"]), _t(p["us"]), ks, Ks)
        got = ilqr_forward.ilqr_forward_fused(*fwd)
        want = ilqr_forward.ilqr_forward_reference(*fwd)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # no kernel ran
    assert (ilqr_backward.ilqr_backward_fused.launches,
            ilqr_forward.ilqr_forward_fused.launches) == before
