"""models/mppi.py of numpower_tpu_torch against the JAX package, on the same
numpy inputs and the JAX package's own random draws (CPU).

torch cannot reproduce JAX's threefry stream, so each comparison draws the
perturbations with JAX (split(key, iters) per solve; split(key, N), then
split(k, iters) per scenario of a batch) and hands them to the port's private
cores. Bounds: us atol 5e-4, ess rtol 1e-3, cost rtol 1e-4 at iters <= 4, the
JAX package's own bounds between its kernel and XLA routes
(tests/test_kernels.py:503-536): MPPI is chaotic in its rounding over more
rounds (ROADMAP.md, queue 3). The plain K13 against JAX's Pallas kernel is
in tests/test_torch_sampling_kernels.py.
The statistical tests are the port's twins of
tests/test_solvers_extra.py:447-523, drawing from a torch.Generator.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.kernels import mppi as jk  # noqa: E402
from numpower_tpu.models import mppi as jmppi  # noqa: E402
from numpower_tpu_torch.kernels import mppi as tk  # noqa: E402
from numpower_tpu_torch.models import mppi as tmppi  # noqa: E402

# the bench's swing-up cost (bench.py:546-572)
QP = np.diag([1.0, 0.1]).astype(np.float32)
RP = np.eye(1, dtype=np.float32) * 0.01
QFP = np.diag([100.0, 10.0]).astype(np.float32)
GOAL = np.zeros(2, np.float32)
BOUND = dict(us=5e-4, ess=1e-3, cost=1e-4)
T, K, N = 12, 128, 6
US0 = (0.1 * np.random.default_rng(8).standard_normal((T, 1))).astype(np.float32)
CONFIGS = {  # the configurations of test_mppi_pallas_matches_xla, and more options
    "plain": dict(iters=4, m=1),
    "box_sigma_lam": dict(iters=3, m=1, u_lo=-2.0, u_hi=2.0, sigma=0.7, lam=0.5),
    "warm_start": dict(iters=2, us_init=US0),
    "sigma_array": dict(iters=2, m=1, sigma=np.array([0.8], np.float32), lam=2.0),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _costs():
    return (jm.quadratic_mppi_cost(jnp.asarray(QP), jnp.asarray(RP), jnp.asarray(QFP),
                                   jnp.asarray(GOAL)),
            tm.quadratic_mppi_cost(QP, RP, QFP, GOAL))


def _x0s(n=N, seed=8):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (n, 2)).astype(np.float32)


def _sigma_arr(kw, m):
    return jnp.broadcast_to(jnp.asarray(kw.get("sigma", 1.0), jnp.float32), (m,))


def _jax_eps_single(key, iters, m, sigma_arr, samples=K, horizon=T):
    """mppi_solve's draws: split(key, iters), normal((K, T, m)) * sigma."""
    keys = jax.random.split(key, iters)
    return np.stack([np.asarray(jax.random.normal(k, (samples, horizon, m), jnp.float32)
                                * sigma_arr) for k in keys])


def _jax_eps_batched(key, n_scen, iters, m, sigma_arr):
    """mppi_solve_batched's draws in kernel layout (the JAX package's exact
    stream) and in the plain route's (N, iters, K, T, m)."""
    lay = np.asarray(jk.eps_kernel_layout(key, n_scen, iters, T, m, K, sigma_arr))
    return lay, lay.reshape(iters, T, m, n_scen, K).transpose(3, 0, 4, 1, 2)


def _close(got, want):
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=0, atol=BOUND["us"])
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(want.ess), rtol=BOUND["ess"])
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=BOUND["cost"])
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0, atol=1e-3)


def test_quadratic_cost_and_its_rows_match_jax():
    cj, ct = _costs()
    assert hasattr(ct, "rows") and hasattr(ct, "kernel")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 2)).astype(np.float32)
    u = rng.standard_normal((5, 1)).astype(np.float32)
    got = ct(_t(x), _t(u), 0).numpy()
    want = np.array([float(cj(jnp.asarray(x[i]), jnp.asarray(u[i]), 0)) for i in range(5)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got_T = ct(_t(x), None, T).numpy()
    want_T = np.array([float(cj(jnp.asarray(x[i]), None, T)) for i in range(5)])
    np.testing.assert_allclose(got_T, want_T, rtol=1e-6)
    xr, ur = rng.standard_normal((2, 3, 4)).astype(np.float32), \
        rng.standard_normal((1, 3, 4)).astype(np.float32)
    for u_rows in (ur, None):
        want_r = np.asarray(cj.rows([jnp.asarray(r) for r in xr],
                                    None if u_rows is None else [jnp.asarray(r) for r in u_rows],
                                    0))
        got_r = ct.rows([_t(r) for r in xr], None if u_rows is None else [_t(r) for r in u_rows], 0)
        np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-6)
    for a, b in zip(ct.kernel, (QP, RP, QFP, GOAL)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mppi_solve_matches_jax(name):
    kw = dict(CONFIGS[name])
    cj, ct = _costs()
    x0 = _x0s(1)[0]
    key = jax.random.key(3)
    want = jm.mppi_solve(jm.pendulum_step, jnp.asarray(x0), cj, T, key, samples=K, **kw)
    m = kw.pop("m", 1)
    iters = kw.pop("iters")
    eps = _jax_eps_single(key, iters, m, _sigma_arr(kw, m))
    got = tmppi._mppi_core(tm.pendulum_step, _t(x0), ct, _t(eps), **kw)
    assert got.us.shape == (T, 1) and got.xs.shape == (T + 1, 2) and got.cost.shape == ()
    _close(got, want)


def test_mppi_solve_baseline_mix_and_two_inputs_match_jax():
    """baseline_mix > 0 (the first samples explore around zero) on the
    unicycle, m = 2 with a per-input sigma."""
    Q = np.diag([1.0, 1.0, 0.0]).astype(np.float32)
    QF = np.diag([50.0, 50.0, 0.0]).astype(np.float32)
    goal = np.array([1.0, 1.0, 0.0], np.float32)
    R = np.eye(2, dtype=np.float32) * 0.01
    cj = jm.quadratic_mppi_cost(jnp.asarray(Q), jnp.asarray(R), jnp.asarray(QF), jnp.asarray(goal))
    ct = tm.quadratic_mppi_cost(Q, R, QF, goal)
    x0 = np.zeros(3, np.float32)
    sigma = np.array([1.0, 0.5], np.float32)
    kw = dict(lam=0.5, sigma=sigma, baseline_mix=0.25)
    key = jax.random.key(4)
    want = jm.mppi_solve(jm.unicycle_step, jnp.asarray(x0), cj, T, key, samples=K, iters=3, m=2,
                         **kw)
    eps = _jax_eps_single(key, 3, 2, jnp.asarray(sigma))
    got = tmppi._mppi_core(tm.unicycle_step, _t(x0), ct, _t(eps), **kw)
    _close(got, want)


@pytest.mark.parametrize("name", ["plain", "box_sigma_lam", "warm_start"])
def test_mppi_solve_batched_xla_matches_jax(name):
    kw = dict(CONFIGS[name])
    cj, ct = _costs()
    x0s = _x0s()
    key = jax.random.key(3)
    want = jm.mppi_solve_batched(jm.pendulum_step, jnp.asarray(x0s), cj, T, key, method="xla",
                                 samples=K, **kw)
    m = kw.pop("m", 1)
    _, eps = _jax_eps_batched(key, N, kw.pop("iters"), m, _sigma_arr(kw, m))
    got = tmppi._mppi_core(tm.pendulum_step, _t(x0s), ct, _t(eps), **kw)
    assert got.us.shape == (N, T, 1) and got.cost.shape == (N,) and got.ess.shape == (N,)
    _close(got, want)


def test_mppi_step_matches_jax():
    cj, ct = _costs()
    us_prev = (0.2 * np.random.default_rng(5).standard_normal((T, 1))).astype(np.float32)
    x_now = np.array([0.3, 0.0], np.float32)
    key = jax.random.key(6)
    u0_j, want = jm.mppi_step(jm.pendulum_step, jnp.asarray(us_prev), jnp.asarray(x_now), cj, key,
                              samples=K, iters=3)
    eps = _jax_eps_single(key, 3, 1, _sigma_arr({}, 1))
    shifted = np.concatenate([us_prev[1:], us_prev[-1:]])
    got = tmppi._mppi_core(tm.pendulum_step, _t(x_now), ct, _t(eps), us_init=_t(shifted))
    _close(got, want)
    np.testing.assert_allclose(got.us[0].numpy(), np.asarray(u0_j), atol=BOUND["us"])
    # the public tick shifts the plan and returns its first control
    u0, res = tm.mppi_step(tm.pendulum_step, _t(us_prev), _t(x_now), ct, samples=K, iters=3)
    assert u0.shape == (1,) and res.us.shape == (T, 1) and torch.equal(u0, res.us[0])


def test_kernel_and_plain_routes_agree_from_one_generator_seed():
    """eps_stream="exact": the kernel route consumes the plain route's very
    draw, transposed; on the CPU both routes are plain PyTorch."""
    _, ct = _costs()
    x0s = _t(_x0s())
    kw = dict(samples=K, iters=3, m=1, u_lo=-2.0, u_hi=2.0)
    a = tm.mppi_solve_batched(tm.pendulum_step, x0s, ct, T, torch.Generator().manual_seed(1),
                              method="xla", **kw)
    b = tm.mppi_solve_batched(tm.pendulum_step, x0s, ct, T, torch.Generator().manual_seed(1),
                              method="pallas", **kw)
    np.testing.assert_allclose(b.us.numpy(), a.us.numpy(), rtol=0, atol=BOUND["us"])
    np.testing.assert_allclose(b.ess.numpy(), a.ess.numpy(), rtol=BOUND["ess"])
    np.testing.assert_allclose(b.cost.numpy(), a.cost.numpy(), rtol=BOUND["cost"])
    c = tm.mppi_solve_batched(tm.pendulum_step, x0s, ct, T, torch.Generator().manual_seed(1),
                              method="pallas", eps_stream="direct", **kw)
    assert c.us.shape == a.us.shape and bool(torch.isfinite(c.cost).all())
    assert not torch.allclose(c.us, a.us)


def test_routes():
    _, ct = _costs()
    route = tmppi.route_mppi
    assert route("cuda", torch.float32, ct, 256, 40, 1, 0.0) == "pallas"
    assert route("cpu", torch.float32, ct, 256, 40, 1, 0.0) == "xla"
    assert route("cuda", torch.float64, ct, 256, 40, 1, 0.0) == "xla"
    # past the narrow K13's K = 1024 and T m = 1024 the wide K13 takes the route
    assert route("cuda", torch.float32, ct, 2048, 40, 1, 0.0) == "pallas"
    assert route("cuda", torch.float32, ct, 256, 513, 2, 0.0) == "pallas"  # T m = 1026
    assert route("cuda", torch.float32, ct, 1024, 512, 2, 0.0) == "pallas"
    assert route("cuda", torch.float32, ct, 256, 16385, 2, 0.0) == "xla"  # T m > 32768
    assert route("cuda", torch.float32, ct, 256, 40, 1, 0.1) == "xla"
    assert route("cuda", torch.float32, lambda x, u, t: x.sum(-1), 256, 40, 1, 0.0) == "xla"
    assert route("cpu", torch.float32, ct, 2048, 40, 1, 0.0, method="pallas") == "pallas"
    with pytest.raises(ValueError, match="kernel route"):
        route("cpu", torch.float32, ct, 2048, 16385, 2, 0.0, method="pallas")
    with pytest.raises(ValueError, match="unknown method"):
        route("cpu", torch.float32, ct, 256, 40, 1, 0.0, method="triton")
    with pytest.raises(ValueError, match="eps_stream"):
        tm.mppi_solve_batched(tm.pendulum_step, _t(_x0s()), ct, T, m=1, eps_stream="philox")


@pytest.mark.parametrize("samples", [64, 200])
def test_kernel_route_needs_samples_a_multiple_of_128_as_jax(samples):
    """The JAX route takes its kernel only where samples % 128 == 0
    (numpower_tpu/models/mppi.py:196-212): "auto" on the card takes "xla"
    off that grid, an explicit "pallas" raises in both packages, and the
    JAX-named kernel raises for K % 128 != 0 as the JAX kernel does."""
    cj, ct = _costs()
    assert tmppi.route_mppi("cuda", torch.float32, ct, samples, T, 1, 0.0) == "xla"
    with pytest.raises(ValueError, match="samples % 128 == 0"):
        tmppi.route_mppi("cuda", torch.float32, ct, samples, T, 1, 0.0, method="pallas")
    x0s, kw = _x0s(), dict(samples=samples, iters=1, m=1)
    with pytest.raises(ValueError, match="samples % 128 == 0"):
        tm.mppi_solve_batched(tm.pendulum_step, _t(x0s), ct, T, method="pallas", **kw)
    with pytest.raises(ValueError, match="samples % 128 == 0"):
        jm.mppi_solve_batched(jm.pendulum_step, jnp.asarray(x0s), cj, T, jax.random.key(0),
                              method="pallas", **kw)
    kern = dict(T=T, iters=1, m=1, lam=1.0, sigma=(1.0,), u_lo=None, u_hi=None)
    with pytest.raises(ValueError, match="K % 128 == 0"):
        tk.mppi_pallas(tm.pendulum_step, ct.rows, _t(x0s), torch.zeros(T, N, samples),
                       torch.zeros(T), **kern)
    with pytest.raises(ValueError, match="K % 128 == 0"):
        jk.mppi_pallas(jm.pendulum_step, cj.rows, jnp.asarray(x0s), jnp.zeros((T, N, samples)),
                       jnp.zeros(T), **kern, interpret=True)


# -- the port's twins of the JAX package's statistical tests -------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_mppi_improves_pendulum_swingup():
    x0 = torch.tensor([np.pi, 0.0])
    cost_fn = tm.quadratic_mppi_cost(np.diag([1.0, 0.1]), np.eye(1) * 0.01,
                                     np.diag([100.0, 10.0]), np.zeros(2))
    res = tm.mppi_solve(tm.pendulum_step, x0, cost_fn, 60, _gen(0), samples=512, iters=12,
                        lam=2.0, sigma=1.5, m=1)
    zero = torch.zeros((60, 1))
    cost0 = float(tmppi._trajectory_cost(cost_fn, tm.rollout_nonlinear(tm.pendulum_step, x0, zero),
                                         zero))
    assert float(res.cost) < 0.8 * cost0
    assert 1.0 <= float(res.ess) <= 512.0


def test_mppi_respects_box():
    cost_fn = tm.quadratic_mppi_cost(np.eye(2), np.eye(1) * 0.01, np.eye(2) * 50.0, np.zeros(2))
    res = tm.mppi_solve(tm.pendulum_step, torch.tensor([np.pi, 0.0]), cost_fn, 40, _gen(1),
                        samples=256, iters=6, sigma=1.0, m=1, u_lo=-2.0, u_hi=2.0)
    assert float(res.us.abs().max()) <= 2.0 + 1e-6


def test_mppi_reproducible_and_seed_sensitive():
    cost_fn = tm.quadratic_mppi_cost(np.eye(2), np.eye(1) * 0.1, np.eye(2) * 10.0, np.zeros(2))

    def run(seed):
        return tm.mppi_solve(tm.pendulum_step, torch.tensor([0.5, 0.0]), cost_fn, 30, _gen(seed),
                             samples=128, iters=4, m=1).us

    assert torch.equal(run(7), run(7))
    assert not torch.allclose(run(7), run(8))
    # the default generator is seeded 0
    default = tm.mppi_solve(tm.pendulum_step, torch.tensor([0.5, 0.0]), cost_fn, 30, samples=128,
                            iters=4, m=1).us
    assert torch.equal(default, run(0))


def test_mppi_batched_scenarios():
    cost_fn = tm.quadratic_mppi_cost(np.eye(2), np.eye(1) * 0.1, np.eye(2) * 10.0, np.zeros(2))
    x0s = torch.tensor([[0.5, 0.0], [np.pi / 2, 0.0]])
    res = tm.mppi_solve_batched(tm.pendulum_step, x0s, cost_fn, 30, _gen(2), samples=128, iters=4,
                                m=1)
    assert res.us.shape == (2, 30, 1) and res.xs.shape == (2, 31, 2) and res.cost.shape == (2,)


def test_mppi_unicycle_reaches_goal():
    cost_fn = tm.quadratic_mppi_cost(np.diag([1.0, 1.0, 0.0]), np.eye(2) * 0.01,
                                     np.diag([50.0, 50.0, 0.0]), np.array([1.0, 1.0, 0.0]))
    res = tm.mppi_solve(tm.unicycle_step, torch.zeros(3), cost_fn, 30, _gen(4), samples=512,
                        iters=15, lam=0.5, sigma=1.0, m=2)
    assert float(torch.linalg.vector_norm(res.xs[-1, :2] - torch.tensor([1.0, 1.0]))) < 0.3


DEVICE_CALLS = {
    "mppi_solve": lambda x0, c: tm.mppi_solve(tm.pendulum_step, x0, c, 5, samples=8, iters=1, m=1),
    "mppi_solve_batched": lambda x0, c: tm.mppi_solve_batched(
        tm.pendulum_step, x0[None] if isinstance(x0, torch.Tensor) else x0[None], c, 5,
        samples=8, iters=1, m=1),
    "mppi_step": lambda x0, c: tm.mppi_step(tm.pendulum_step, np.zeros((5, 1), np.float32), x0, c,
                                            samples=8, iters=1)[1],
}


@pytest.mark.parametrize("call", list(DEVICE_CALLS.values()), ids=list(DEVICE_CALLS))
def test_entry_points_default_to_the_card(call):
    """A numpy state goes to the card: without CUDA the call raises, because
    it reaches for it; a CPU tensor keeps the solve on the CPU."""
    _, ct = _costs()
    x0 = np.array([0.5, 0.0], np.float32)
    if torch.cuda.is_available():
        assert call(x0, ct).us.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(x0, ct)
    assert call(_t(x0), ct).us.device.type == "cpu"
