"""models/mhe.py and the OSQP part of models/admm.py of numpower_tpu_torch
against the JAX package on the same numpy inputs (CPU).

The OSQP solves run on the identical condensed QP (carried over with
condensed_from_jax); both packages form the same explicit inverse of the
factorized x-update matrix and iterate the same fp32 products, so they are
held to 1e-4 (absolute) on every output. MHE is held to 1e-4 as well. The
statistical tests are the port's twins of tests/test_estimation.py:280-358
and tests/test_solvers_extra.py:172-230.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
A = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)  # double_integrator(0.1)
B = np.array([[0.005], [0.1]], np.float32)
C = np.array([[1.0, 0.0]], np.float32)
Q = np.eye(2, dtype=np.float32) * 1e-3
R = np.eye(1, dtype=np.float32) * 1e-2
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _qps(A_, B_, Q_, R_, QF_, T):
    """The JAX package's condensed QP and the same QP in the port, on the CPU."""
    jqp = jm.condense(*(jnp.asarray(a) for a in (A_, B_, Q_, R_, QF_)), T)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS}, T=T, n=jqp.n,
                             m=jqp.m, kappa=jqp.kappa, device="cpu")
    return jqp, tqp


def _di_qp(T=12, Qd=(1.0, 1.0), R_=0.1, QF_=10.0):
    return _qps(A, B, np.diag(Qd).astype(np.float32), np.eye(1, dtype=np.float32) * R_,
                np.eye(2, dtype=np.float32) * QF_, T)


def _close_osqp(got, want):
    for field in ("U", "Z", "primal_residual", "dual_residual"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL, err_msg=field)


def _lti_ys(T=50, seed=0):
    """tests/test_estimation.py's lti_data measurements."""
    rng = np.random.default_rng(seed)
    x, ys = np.array([1.0, 0.0]), []
    for _ in range(T):
        x = A.astype(np.float64) @ x + rng.multivariate_normal(np.zeros(2), Q.astype(np.float64))
        ys.append(x[0] + rng.normal(0, 0.1))
    return np.array(ys, np.float32).reshape(T, 1)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
def test_solve_qp_osqp_matches_jax(batched):
    jqp, tqp = _di_qp(T=8)
    rng = np.random.default_rng(21)
    x0s = (rng.standard_normal((3, 2)) * [1.5, 0.5]).astype(np.float32)
    d = jqp.H.shape[0]
    g = np.asarray(jm.gradient_offset(jqp, jnp.asarray(x0s)))
    Ac = np.concatenate([np.eye(d, dtype=np.float32), np.asarray(jqp.Su)], axis=0)
    sx = x0s @ np.asarray(jqp.Sx).T
    l = np.concatenate([np.full((3, d), -0.6, np.float32), -1.0 - sx], axis=1)
    u = np.concatenate([np.full((3, d), 0.6, np.float32), 1.0 - sx], axis=1)
    if not batched:
        g, l, u = g[0], l[0], u[0]
    want = jm.solve_qp_osqp(jqp.H, jnp.asarray(g), jnp.asarray(Ac), jnp.asarray(l), jnp.asarray(u),
                            rho=1.0, iters=100)
    got = tm.solve_qp_osqp(tqp.H, _t(g), _t(Ac), _t(l), _t(u), rho=1.0, iters=100)
    assert got.iterations == 100
    _close_osqp(got, want)


@pytest.mark.parametrize("bounds", ["loose", "tight", "per_state", "x_ref"])
def test_solve_mpc_state_constrained_matches_jax(bounds):
    jqp, tqp = _di_qp(T=12)
    x0s = np.array([[1.2, 0.0], [-0.4, 0.5], [0.3, -0.8]], np.float32)
    lo, hi = {"loose": (-1e6, 1e6), "tight": (-1.0, 1.0), "x_ref": (-2.0, 2.0),
              "per_state": (np.array([-10.0, -0.6], np.float32),
                            np.array([10.0, 0.6], np.float32))}[bounds]
    ref = np.array([0.5, 0.0], np.float32) if bounds == "x_ref" else None
    want = jm.solve_mpc_state_constrained(jqp, jnp.asarray(x0s), -0.5, 0.5, lo, hi,
                                          x_ref=None if ref is None else jnp.asarray(ref),
                                          iters=80)
    got = tm.solve_mpc_state_constrained(tqp, x0s, -0.5, 0.5, lo, hi,
                                         x_ref=None if ref is None else _t(ref), iters=80)
    _close_osqp(got, want)
    # one scenario as a vector, as the JAX package takes it
    want1 = jm.solve_mpc_state_constrained(jqp, jnp.asarray(x0s[1]), -0.5, 0.5, lo, hi,
                                           x_ref=None if ref is None else jnp.asarray(ref),
                                           iters=80)
    got1 = tm.solve_mpc_state_constrained(tqp, x0s[1], -0.5, 0.5, lo, hi,
                                          x_ref=None if ref is None else _t(ref), iters=80)
    _close_osqp(got1, want1)


def _mhe_pair(M=20, seed=0, **kw):
    ys = _lti_ys(seed=seed)[:M]
    x0, P0 = np.array([1.0, 0.0], np.float32), np.eye(2, dtype=np.float32) * 0.1
    want = jm.mhe_solve(*(jnp.asarray(a) for a in (A, C, Q, R, P0, x0, ys)),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tm.mhe_solve(*(_t(a) for a in (A, C, Q, R, P0, x0, ys)), **kw)
    return got, want


@pytest.mark.parametrize("case", ["plain", "inputs", "bounds"])
def test_mhe_solve_matches_jax(case):
    kw = {"plain": {},
          "inputs": dict(B=B, us=(0.3 * np.random.default_rng(9).standard_normal((20, 1)))
                         .astype(np.float32)),
          "bounds": dict(x_lo=np.array([-10.0, -0.05], np.float32),
                         x_hi=np.array([10.0, 0.05], np.float32))}[case]
    got, want = _mhe_pair(**kw)
    assert got.xs.shape == (21, 2) and got.ws.shape == (20, 2) and got.objective.shape == ()
    for field in got._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, field
        scale = max(1.0, float(np.abs(w).max())) if field == "objective" else 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL * scale, err_msg=field)
    if case == "bounds":
        assert float(got.xs[:, 1].abs().max()) <= 0.05 + 1e-3


def test_mhe_batched_windows_match_jax():
    """Leading batch dimensions of x_prior/ys/us against the JAX package's vmap,
    with and without bounds."""
    ys = _lti_ys()
    M = 10
    x_priors = np.array([[1.0, 0.0], [0.0, 0.5], [0.2, -0.1]], np.float32)
    yss = np.stack([ys[:M], ys[5:5 + M], ys[20:20 + M]])
    uss = (0.3 * np.random.default_rng(4).standard_normal((3, M, 1))).astype(np.float32)
    P0 = np.eye(2, dtype=np.float32) * 0.1
    for kw in ({}, dict(x_lo=-0.6, x_hi=0.6)):
        want = jax.vmap(lambda xp, yw, uw: jm.mhe_solve(A, C, Q, R, P0, xp, yw, B=B, us=uw,
                                                        **kw))(
            jnp.asarray(x_priors), jnp.asarray(yss), jnp.asarray(uss))
        got = tm.mhe_solve(A, C, Q, R, P0, _t(x_priors), yss, B=B, us=uss, **kw)
        assert got.xs.shape == (3, M + 1, 2) and got.objective.shape == (3,)
        for field in got._fields:
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)), rtol=1e-5, atol=TOL,
                                       err_msg=field)


# -- the port's twins of the JAX package's tests -------------------------------

def _smooth(ys, x0, P0, **kw):
    filt = tm.kalman_filter(*(_t(a) for a in (A, C, Q, R, x0, P0, ys)), **kw)
    return tm.kalman_smoother(_t(A), filt)


def test_mhe_equals_rts_smoother():
    ys = _lti_ys()[:20]
    x0, P0 = np.array([1.0, 0.0], np.float32), np.eye(2, dtype=np.float32) * 0.1
    res = tm.mhe_solve(A, C, Q, R, P0, _t(x0), ys)
    np.testing.assert_allclose(res.xs[1:].numpy(), _smooth(ys, x0, P0).means.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_mhe_with_inputs_matches_smoother():
    M = 15
    rng = np.random.default_rng(9)
    us = (0.3 * rng.standard_normal((M, 1))).astype(np.float32)
    x, ys = np.zeros(2), []
    for t in range(M):
        x = A.astype(np.float64) @ x + (B.astype(np.float64) @ us[t]).ravel() \
            + rng.normal(0, 0.01, 2)
        ys.append([x[0] + rng.normal(0, 0.05)])
    ys = np.array(ys, np.float32)
    x0, P0 = np.zeros(2, np.float32), np.eye(2, dtype=np.float32) * 0.2
    sm = _smooth(ys, x0, P0, B=_t(B), us=_t(us))
    res = tm.mhe_solve(A, C, Q, R, P0, _t(x0), ys, B=B, us=us)
    np.testing.assert_allclose(res.xs[1:].numpy(), sm.means.numpy(), rtol=5e-3, atol=5e-4)


def test_mhe_state_bounds_bind():
    M = 15
    rng = np.random.default_rng(10)
    x, ys = np.array([0.0, 0.45]), []
    for _ in range(M):
        x = A.astype(np.float64) @ x
        ys.append([x[0] + rng.normal(0, 0.3)])
    ys = np.array(ys, np.float32)
    P0, x_prior = np.eye(2, dtype=np.float32), torch.zeros(2)
    r_un = tm.mhe_solve(A, C, Q, R, P0, x_prior, ys)
    r_c = tm.mhe_solve(A, C, Q, R, P0, x_prior, ys, x_lo=np.array([-10.0, -0.5]),
                       x_hi=np.array([10.0, 0.5]), iters=300)
    assert float(r_c.xs[:, 1].abs().max()) <= 0.5 + 1e-3
    assert float(r_c.primal_residual) < 1e-2
    assert float(r_un.xs[:, 1].abs().max()) > 0.5
    assert float(r_c.objective) >= float(r_un.objective) - 1e-3


def test_osqp_matches_box_admm_when_states_loose():
    _, tqp = _di_qp(T=12)
    x0s = torch.tensor([[1.2, 0.0], [-0.4, 0.5]])
    r_box = tm.solve_mpc_boxqp_admm(tqp, x0s, -0.5, 0.5, iters=200)
    r_osqp = tm.solve_mpc_state_constrained(tqp, x0s, -0.5, 0.5, -1e6, 1e6, iters=400)
    np.testing.assert_allclose(r_osqp.U.numpy(), r_box.U.numpy(), rtol=2e-3, atol=5e-4)
    assert float(r_osqp.primal_residual) < 1e-3


def test_state_constraints_actually_bind():
    _, tqp = _di_qp(T=20, Qd=(10.0, 0.1), R_=0.01, QF_=20.0)
    x0 = torch.tensor([[3.0, 0.0]])
    v_cap = 0.8
    r_un = tm.solve_mpc_boxqp_admm(tqp, x0, -50.0, 50.0, iters=200)
    r_c = tm.solve_mpc_state_constrained(tqp, x0, -50.0, 50.0, np.array([-10.0, -v_cap]),
                                         np.array([10.0, v_cap]), iters=600)
    xs_un = tm.rollout_lti(_t(A), _t(B), x0[0], r_un.U[0].reshape(20, 1))
    xs_c = tm.rollout_lti(_t(A), _t(B), x0[0], r_c.U[0].reshape(20, 1))
    assert float(xs_un[1:, 1].abs().max()) > v_cap + 0.1
    assert float(xs_c[1:, 1].abs().max()) <= v_cap + 0.02
    assert float(r_c.primal_residual) < 5e-3
    assert abs(float(xs_c[-1, 0])) < 3.0


DEVICE_CALLS = {
    "solve_qp_osqp": lambda g: tm.solve_qp_osqp(np.eye(2, dtype=np.float32), g,
                                                np.eye(2, dtype=np.float32), -1.0, 1.0, iters=3),
    "mhe_solve": lambda x0: tm.mhe_solve(A, C, Q, R, np.eye(2, dtype=np.float32), x0,
                                         np.zeros((4, 1), np.float32)),
}


@pytest.mark.parametrize("call", list(DEVICE_CALLS.values()), ids=list(DEVICE_CALLS))
def test_entry_points_default_to_the_card(call):
    """A numpy leading operand goes to the card: without CUDA the call
    raises, because it reaches for it; a CPU tensor keeps the solve there."""
    v = np.array([0.5, -0.2], np.float32)
    if torch.cuda.is_available():
        assert call(v)[0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(v)
    assert call(_t(v))[0].device.type == "cpu"


def test_state_constrained_mpc_follows_the_qp():
    """x0s may be numpy: it goes to the QP's device (here a CPU QP)."""
    _, tqp = _di_qp(T=6)
    res = tm.solve_mpc_state_constrained(tqp, np.array([[0.5, 0.0]], np.float32), -1.0, 1.0,
                                         -2.0, 2.0, iters=5)
    assert res.U.device.type == "cpu" and res.U.shape == (1, 6)
