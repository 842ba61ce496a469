"""The JAX package's route names and zero-length horizons in
numpower_tpu_torch, against the JAX package on the same numpy inputs (CPU).

Route names: each routing site of the port takes the names the JAX package
documents and runs, for each, the route the JAX code runs for it:
  - solve_mpc_boxqp: "pallas" the kernel, "xla" projected gradient (JAX runs
    projected gradient for every name but "pallas" and "fista");
  - solve_mpc_boxqp_admm: "pallas" the kernel, "xla" plain ADMM;
  - riccati_scan_per_scenario: "fused" the fused Riccati kernel, "pallas" the
    batched-solve kernel, "xla" plain;
  - ilqr_solve_batched and al_ilqr_solve_batched (backend="fused"):
    forward="pallas" the line-search kernel, "xla" the plain rollout;
  - the DP solvers of parallel/sharding.py: "pallas" the kernel, "xla" the
    plain scan.
On the CPU the port's kernel routes run the kernels' plain versions; the JAX
side runs its Pallas kernels in interpret mode (riccati_scan_per_scenario's
kernels through functools.partial(interpret=True), as the JAX package's own
CPU tests call them).

Bounds: the box-QP solves in all-fp32 (coarse_iters=0) 1e-5 on U (the same
fp32 iteration, summed in another order), ADMM and the DP solvers 1e-4 (the
bound of tests/test_torch_parallel.py); Riccati gains rtol 1e-3 / atol 1e-4
and P0 rtol 1e-3 / atol 1e-3 (tests/test_torch_lqr.py); the iLQR costs the
JAX package's cross-backend bound rtol 1e-2 / atol 1e-3
(tests/test_kernels.py:176). The zero-length results are exact: empty
tensors of JAX's shapes, and [QF], [x0] and a log-likelihood of 0.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.models.admm import route_mpc_boxqp_admm  # noqa: E402
from numpower_tpu_torch.models.boxqp import route_mpc_boxqp  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402
from numpower_tpu_torch.models.ilqr import _forward_route  # noqa: E402
from numpower_tpu_torch.models.lqr import route_riccati_per_scenario  # noqa: E402

F32 = np.float32
FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
N_X0, T_QP = 4, 3
COST_BOUND = dict(rtol=1e-2, atol=1e-3)


def _system(n=4, m=2, seed=0):
    rng = np.random.default_rng(seed)
    A = (np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(F32)
    B = (0.5 * rng.standard_normal((n, m))).astype(F32)
    return A, B, np.eye(n, dtype=F32), np.eye(m, dtype=F32) * 0.1, np.eye(n, dtype=F32) * 5.0


@pytest.fixture(scope="module")
def qps():
    """The issue's problem: n = 4, m = 2, T = 3, four x0s, box +-1; the
    port's QP is the JAX package's, value for value."""
    A, B, Q, R, QF = _system()
    jqp = jm.condense(*(jnp.asarray(a) for a in (A, B, Q, R, QF)), T_QP)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS}, T=T_QP, n=4,
                             m=2, kappa=float(jqp.kappa), device="cpu")
    x0s = (0.5 * np.random.default_rng(1).standard_normal((N_X0, 4))).astype(F32)
    return jqp, tqp, x0s


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,route", [("pallas", "kernel"), ("xla", "pg")])
def test_solve_mpc_boxqp_takes_jax_names(qps, name, route):
    jqp, tqp, x0s = qps
    assert route_mpc_boxqp("cpu", tqp.H.shape[0], False, 2, name) == route
    want = jm.solve_mpc_boxqp(jqp, jnp.asarray(x0s), -1.0, 1.0, iters=40, method=name,
                              coarse_iters=0)
    got = tm.solve_mpc_boxqp(tqp, torch.from_numpy(x0s), -1.0, 1.0, iters=40, method=name,
                             coarse_iters=0)
    _close(got.U, want.U, 1e-5)
    _close(got.residual, want.residual, 1e-5)


@pytest.mark.parametrize("name,route", [("pallas", "kernel"), ("xla", "plain")])
def test_solve_mpc_boxqp_admm_takes_jax_names(qps, name, route):
    jqp, tqp, x0s = qps
    assert route_mpc_boxqp_admm("cpu", tqp.H.shape[0], False, 2, name) == route
    want = jm.solve_mpc_boxqp_admm(jqp, jnp.asarray(x0s), -1.0, 1.0, iters=30, method=name,
                                   coarse_iters=0)
    got = tm.solve_mpc_boxqp_admm(tqp, torch.from_numpy(x0s), -1.0, 1.0, iters=30,
                                  method=name, coarse_iters=0)
    _close(got.U, want.U, 1e-4)
    _close(got.primal_residual, want.primal_residual, 1e-4)
    _close(got.dual_residual, want.dual_residual, 1e-4)


@pytest.mark.parametrize("name,route", [("pallas", "psd"), ("xla", "plain"),
                                        ("fused", "fused")])
def test_riccati_scan_per_scenario_takes_jax_names(monkeypatch, name, route):
    from numpower_tpu.kernels import cholesky as jchol
    from numpower_tpu.kernels import riccati as jric

    # the JAX package's routes import their kernels when called; on the CPU
    # they run in interpret mode
    monkeypatch.setattr(jchol, "psd_solve_batched",
                        functools.partial(jchol.psd_solve_batched, interpret=True))
    monkeypatch.setattr(jric, "riccati_batched_fused",
                        functools.partial(jric.riccati_batched_fused, interpret=True))
    assert route_riccati_per_scenario("cpu", 4, 2, name) == route
    A, B, Q, R, QF = _system()
    N, T = 5, 6
    rng = np.random.default_rng(2)
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 4, 4))).astype(F32)
    Bs = (np.tile(B, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 4, 2))).astype(F32)
    Ks_j, P0_j = jm.riccati_scan_per_scenario(jnp.asarray(As), jnp.asarray(Bs), Q, R, QF, T,
                                              method=name)
    Ks, P0 = tm.riccati_scan_per_scenario(torch.from_numpy(As), torch.from_numpy(Bs),
                                          *(torch.from_numpy(M) for M in (Q, R, QF)), T,
                                          method=name)
    assert Ks.shape == Ks_j.shape == (N, T, 2, 4) and P0.shape == P0_j.shape == (N, 4, 4)
    _close(Ks, Ks_j, 1e-4, rtol=1e-3)
    _close(P0, P0_j, 1e-3, rtol=1e-3)


ILQR_COSTS = (np.eye(4, dtype=F32), np.eye(1, dtype=F32) * 0.01, np.eye(4, dtype=F32) * 10.0,
              np.zeros(4, F32))
AL_COSTS = (np.diag([1.0, 0.1]).astype(F32), np.eye(1, dtype=F32) * 0.01,
            np.diag([100.0, 10.0]).astype(F32), np.zeros(2, F32))


@pytest.mark.parametrize("solver", ["ilqr", "al_ilqr"])
@pytest.mark.parametrize("name,route", [("pallas", "kernel"), ("xla", "plain")])
def test_ilqr_forward_takes_jax_names(solver, name, route):
    assert _forward_route(name) == route
    if solver == "ilqr":
        x0s = (0.3 * np.random.default_rng(1).standard_normal((3, 4))).astype(F32)
        jf, tf, args, kw = jm.cartpole_step, tm.cartpole_step, (*ILQR_COSTS, 10), dict(iters=3)
        jsolve, tsolve = jm.ilqr_solve_batched, tm.ilqr_solve_batched
    else:
        x0s = np.random.default_rng(1).uniform(-2.0, 2.0, (4, 2)).astype(F32)
        jf, tf, args = jm.pendulum_step, tm.pendulum_step, (*AL_COSTS, 10, -2.0, 2.0)
        kw = dict(al_iters=2, ilqr_iters=2)
        jsolve, tsolve = jm.al_ilqr_solve_batched, tm.al_ilqr_solve_batched
    want = jsolve(jf, jnp.asarray(x0s), *args, backend="fused", interpret=True, forward=name,
                  **kw)
    got = tsolve(tf, torch.from_numpy(x0s), *args, backend="fused", forward=name, **kw)
    assert got.us.shape == want.us.shape
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), **COST_BOUND)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), **COST_BOUND)


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """The default process group of this process at world size 1 (gloo over
    a FileStore: no port is opened)."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("route_names") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("solver", ["fista", "admm"])
@pytest.mark.parametrize("name", ["pallas", "xla"])
def test_dp_solvers_take_jax_names(qps, group1, solver, name):
    from numpower_tpu.parallel import make_mesh as jax_mesh
    from numpower_tpu.parallel import solve_mpc_boxqp_admm_dp as j_admm
    from numpower_tpu.parallel import solve_mpc_boxqp_dp as j_dp
    from numpower_tpu_torch.parallel import make_mesh, solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp

    jqp, tqp, x0s = qps
    jmesh, mesh = jax_mesh((1, 1), devices=jax.devices()[:1]), make_mesh((1, 1))
    if solver == "fista":
        want = j_dp(jqp, jnp.asarray(x0s), -1.0, 1.0, jmesh, 40, method=name, coarse_iters=0)
        got = solve_mpc_boxqp_dp(tqp, torch.from_numpy(x0s), -1.0, 1.0, mesh, 40, method=name,
                                 coarse_iters=0)
        parts = (("U", "U"), ("residual", "residual"))
    else:
        want = j_admm(jqp, jnp.asarray(x0s), -1.0, 1.0, jmesh, iters=30, method=name,
                      coarse_iters=0)
        got = solve_mpc_boxqp_admm_dp(tqp, torch.from_numpy(x0s), -1.0, 1.0, mesh, iters=30,
                                      method=name, coarse_iters=0)
        parts = (("U", "U"), ("primal_residual", "primal_residual"),
                 ("dual_residual", "dual_residual"))
    for g, w in parts:
        _close(getattr(got, g), getattr(want, w), 1e-4)


def _zero_length(pkg, arr, which):
    A, B, Q, R, QF = (arr(M) for M in _system())
    x0 = arr(np.ones(4, F32))
    if which == "riccati_scan":
        return pkg.riccati_scan(A, B, Q, R, QF, 0)
    if which in ("lqr_solve", "lqr_solve_parallel"):
        return pkg.lqr_solve(A, B, Q, R, QF, x0, 0, parallel=which.endswith("parallel"))
    if which == "lqr_solve_batched":
        return pkg.lqr_solve_batched(A, B, Q, R, QF, arr(np.ones((3, 4), F32)), 0)
    if which == "lqt_solve":
        return pkg.lqt_solve(A, B, Q, R, QF, x0, arr(np.zeros((1, 4), F32)), 0)
    C = arr(np.eye(2, 4, dtype=F32))
    return tuple(pkg.kalman_filter(A, C, Q, arr(np.eye(2, dtype=F32)), x0,
                                   arr(np.eye(4, dtype=F32)), arr(np.zeros((0, 2), F32))))


@pytest.mark.parametrize("which", ["riccati_scan", "lqr_solve", "lqr_solve_parallel",
                                   "lqr_solve_batched", "lqt_solve", "kalman_filter"])
def test_zero_length_horizon_matches_jax(which):
    want = _zero_length(jm, jnp.asarray, which)
    got = _zero_length(tm, torch.from_numpy, which)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
