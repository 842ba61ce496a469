"""models/particle.py of numpower_tpu_torch against the JAX package, on the
same numpy inputs and the JAX package's own random draws (CPU).

torch cannot reproduce JAX's threefry stream, so each comparison draws with
JAX as particle_filter does (key, k_init = split(key); normal(k_init, (N,
n)); then per step key, k_prop, k_res = split(key, 3), normal(k_prop, (N,
n)) and uniform(k_res, ()); a batch splits its key per trajectory first) and
hands the draws to the port's private core. Bounds: means and covariances
atol 1e-4, the log-likelihood rtol 1e-4.

The slot boundaries of systematic resampling come from an fp32 cumsum, which
torch and XLA sum in different orders: where N cum_j - u0 lies within an ulp
of an integer, one slot moves to the neighbouring particle and the two
filters part from that step on (the PF-index class of ROADMAP.md, queue 3;
with key 0 and threshold 1.0 on the LTI data below, at step 5). The keys
here are ones whose runs hold no such tie. The statistical tests are the port's
twins of tests/test_estimation.py:487-560 and 624-750, drawing from a
torch.Generator.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.models import particle as jpart  # noqa: E402
from numpower_tpu_torch.kernels import pf_resample  # noqa: E402
from numpower_tpu_torch.models import particle as tpart  # noqa: E402

A = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)  # double_integrator(0.1)
C = np.array([[1.0, 0.0]], np.float32)
Q = np.eye(2, dtype=np.float32) * 1e-3
R = np.eye(1, dtype=np.float32) * 1e-2
P0 = np.eye(2, dtype=np.float32) * 0.1
X0 = np.array([1.0, 0.0], np.float32)
BOUND = dict(mean=1e-4, ll=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lti_ys(T=50, seed=0):
    """tests/test_estimation.py's lti_data measurements."""
    rng = np.random.default_rng(seed)
    x, ys = np.array([1.0, 0.0]), []
    An = A.astype(np.float64)
    for _ in range(T):
        x = An @ x + rng.multivariate_normal(np.zeros(2), Q.astype(np.float64))
        ys.append(x[0] + rng.normal(0, 0.1))
    return np.array(ys, np.float32).reshape(T, 1)


def _jax_lin():
    A_j = jnp.asarray(A)
    return (lambda x, u: A_j @ x), (lambda x: x[:1])


def _torch_lin():
    A_t = _t(A)
    return (lambda x, u: x @ A_t.T), (lambda x: x[..., :1])


def _jax_draws(key, N, n, T):
    """particle_filter's draws from key: noise0 (N, n), prop (T, N, n), u0s (T,)."""
    key, k_init = jax.random.split(key)
    noise0 = jax.random.normal(k_init, (N, n), jnp.float32)
    prop, u0s = [], []
    for _ in range(T):
        key, k_prop, k_res = jax.random.split(key, 3)
        prop.append(jax.random.normal(k_prop, (N, n), jnp.float32))
        u0s.append(jax.random.uniform(k_res, (), jnp.float32))
    return np.asarray(noise0), np.stack([np.asarray(p) for p in prop]), np.array(u0s, np.float32)


def _jax_draws_batched(key, B, N, n, T):
    """particle_filter_batched's draws: split(key, B), then each trajectory's."""
    per = [_jax_draws(k, N, n, T) for k in jax.random.split(key, B)]
    return (np.stack([d[0] for d in per]), np.stack([d[1] for d in per], axis=1),
            np.stack([d[2] for d in per], axis=1))


def _close(got, want):
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=0,
                               atol=BOUND["mean"])
    np.testing.assert_allclose(got.covs.numpy(), np.asarray(want.covs), rtol=0,
                               atol=BOUND["mean"])
    np.testing.assert_allclose(got.log_likelihood.numpy(), np.asarray(want.log_likelihood),
                               rtol=BOUND["ll"])
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(want.ess), rtol=1e-3)


@pytest.mark.parametrize("N", [64, 257, 1024])
def test_resample_slots_match_jax(N):
    rng = np.random.default_rng(12)
    logw = (2.0 * rng.standard_normal((3, N))).astype(np.float32)
    u0 = rng.uniform(size=3).astype(np.float32)
    got = tpart._resample_slots(_t(u0), _t(logw), N)
    assert got.dtype == torch.int32
    for b in range(3):
        key = jax.random.key(b)
        u0_j = float(jax.random.uniform(key, (), jnp.float32))
        want = jpart._resample_slots(key, jnp.asarray(logw[b]), N)
        one = tpart._resample_slots(torch.tensor(u0_j), _t(logw[b]), N)
        np.testing.assert_array_equal(one.numpy(), np.asarray(want))
    assert bool((got[:, -1] == N).all()) and bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
def test_particle_filter_matches_jax(threshold):
    ys = _lti_ys()
    T, N = ys.shape[0], 256
    us = np.zeros((T, 1), np.float32)
    key = jax.random.key(1)
    fj, hj = _jax_lin()
    want = jm.particle_filter(fj, hj, Q, R, jnp.asarray(X0), P0, jnp.asarray(ys), jnp.asarray(us),
                              key, n_particles=N, resample_threshold=threshold,
                              resample_method="gather")
    noise0, prop, u0s = _jax_draws(key, N, 2, T)
    ft, ht = _torch_lin()
    got = tpart._particle_filter_core(ft, ht, _t(Q), _t(R), _t(X0), _t(P0), _t(ys), _t(us),
                                      _t(noise0), _t(prop), _t(u0s), threshold, "auto")
    assert got.means.shape == (T, 2) and got.covs.shape == (T, 2, 2) and got.ess.shape == (T,)
    assert got.particles.shape == (N, 2) and got.log_weights.shape == (N,)
    _close(got, want)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
def test_particle_filter_batched_matches_jax(threshold):
    """The pendulum with noisy angle measurements, three trajectories, inputs."""
    B, T, N = 3, 20, 128
    rng = np.random.default_rng(3)
    x0s = (0.3 * rng.standard_normal((B, 2))).astype(np.float32)
    uss = (0.5 * rng.standard_normal((B, T, 1))).astype(np.float32)
    xs = tm.rollout_nonlinear(tm.pendulum_step, _t(x0s), _t(uss)).numpy()
    yss = (xs[:, 1:, :1] + 0.05 * rng.standard_normal((B, T, 1))).astype(np.float32)
    Qp, Rp, P0p = np.eye(2, dtype=np.float32) * 1e-4, np.eye(1, dtype=np.float32) * 2.5e-3, \
        np.eye(2, dtype=np.float32) * 0.1
    key = jax.random.key(2)
    want = jm.particle_filter_batched(jm.pendulum_step, lambda x: x[:1], Qp, Rp, jnp.asarray(x0s),
                                      P0p, jnp.asarray(yss), jnp.asarray(uss), key,
                                      n_particles=N, resample_threshold=threshold)
    noise0, prop, u0s = _jax_draws_batched(key, B, N, 2, T)
    got = tpart._particle_filter_core(tm.pendulum_step, tm.first_components, _t(Qp), _t(Rp),
                                      _t(x0s), _t(P0p), _t(yss), _t(uss), _t(noise0), _t(prop),
                                      _t(u0s), threshold, "auto")
    assert got.means.shape == (B, T, 2) and got.log_likelihood.shape == (B,)
    _close(got, want)


@pytest.mark.parametrize("N", [64, 257, 1024])
def test_resample_constructions_are_identical(N):
    """gather, onehot and K14's plain version (pallas on a CPU tensor) give
    the same cloud, element for element, as the JAX package's gather."""
    rng = np.random.default_rng(12)
    parts = rng.standard_normal((2, N, 3)).astype(np.float32)
    logw = (2.0 * rng.standard_normal((2, N))).astype(np.float32)
    u0 = rng.uniform(size=2).astype(np.float32)
    outs = {m: tpart._systematic_resample(_t(u0), _t(parts), _t(logw), m)
            for m in ("gather", "onehot", "pallas", "auto")}
    before = pf_resample.resample_systematic.launches
    for m, (cloud, lw) in outs.items():
        assert torch.equal(cloud, outs["gather"][0]), m
        assert torch.equal(lw, outs["gather"][1]), m
    assert pf_resample.resample_systematic.launches == before
    for b in range(2):
        key = jax.random.key(b)
        u0_j = float(jax.random.uniform(key, (), jnp.float32))
        want, w_j = jpart._systematic_resample(key, jnp.asarray(parts[b]), jnp.asarray(logw[b]),
                                               method="gather")
        got, w_t = tpart._systematic_resample(torch.tensor(u0_j), _t(parts[b]), _t(logw[b]),
                                              "pallas")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


def test_routes():
    route = tpart.route_resample
    assert route("cuda", torch.float32) == "pallas"
    assert route("cpu", torch.float32) == "gather"
    assert route("cuda", torch.float64) == "gather"
    for m in ("onehot", "gather", "pallas"):
        assert route("cuda", torch.float32, m) == m
    with pytest.raises(ValueError, match="resample_method"):
        route("cpu", torch.float32, "searchsorted")


# -- the port's twins of the JAX package's statistical tests -------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _kf(ys):
    return tm.kalman_filter(*(_t(a) for a in (A, C, Q, R, X0, P0)), _t(ys))


def test_particle_filter_matches_kf_on_linear_gaussian():
    ys = _lti_ys()
    T = ys.shape[0]
    ref = _kf(ys)
    ft, ht = _torch_lin()
    res = tm.particle_filter(ft, ht, Q, R, _t(X0), P0, ys, np.zeros((T, 1), np.float32), _gen(0),
                             n_particles=4096)
    err = float((res.means - ref.means).abs().mean())
    scale = float(ref.means.abs().mean())
    assert err < 0.05 * max(scale, 1.0)
    assert abs(float(res.log_likelihood) - float(ref.log_likelihood)) < max(
        0.02 * abs(float(ref.log_likelihood)), 2.0)
    assert bool((res.ess >= 1.0).all())


def test_particle_filter_resampling_keeps_ess_healthy():
    ys = _lti_ys()
    us = np.zeros((ys.shape[0], 1), np.float32)
    ft, ht = _torch_lin()
    N = 512
    on = tm.particle_filter(ft, ht, Q, R, _t(X0), P0, ys, us, _gen(1), n_particles=N,
                            resample_threshold=0.5)
    off = tm.particle_filter(ft, ht, Q, R, _t(X0), P0, ys, us, _gen(1), n_particles=N,
                             resample_threshold=0.0)
    assert float(on.ess.min()) > 0.05 * N
    assert float(off.ess.min()) < float(on.ess.min())


def test_particle_filter_nonlinear_tracks_and_is_reproducible():
    rng = np.random.default_rng(3)
    T = 60
    us = torch.tensor(0.5 * np.sin(0.3 * np.arange(T)), dtype=torch.float32).reshape(T, 1)
    xs_true = tm.rollout_nonlinear(tm.pendulum_step, torch.tensor([0.5, 0.0]), us)
    ys = xs_true[1:, :1] + torch.from_numpy(0.05 * rng.standard_normal((T, 1)).astype(np.float32))
    Qp, Rp = np.eye(2, dtype=np.float32) * 1e-4, np.eye(1, dtype=np.float32) * 2.5e-3
    x0, P0p = torch.zeros(2), np.eye(2, dtype=np.float32)
    res = tm.particle_filter(tm.pendulum_step, tm.first_components, Qp, Rp, x0, P0p, ys, us,
                             _gen(7), n_particles=2048)
    err_pf = float((res.means[:, 0] - xs_true[1:, 0]).abs().mean())
    dead = tm.rollout_nonlinear(tm.pendulum_step, x0, us)
    err_dead = float((dead[1:, 0] - xs_true[1:, 0]).abs().mean())
    assert err_pf < 0.5 * err_dead and err_pf < 0.08
    res2 = tm.particle_filter(tm.pendulum_step, tm.first_components, Qp, Rp, x0, P0p, ys, us,
                              _gen(7), n_particles=2048)
    assert torch.equal(res.means, res2.means)
    other = tm.particle_filter(tm.pendulum_step, tm.first_components, Qp, Rp, x0, P0p, ys, us,
                               _gen(8), n_particles=2048)
    assert not torch.equal(res.means, other.means)
    bres = tm.particle_filter_batched(tm.pendulum_step, tm.first_components, Qp, Rp,
                                      torch.stack([x0, x0]), P0p, torch.stack([ys, ys]),
                                      torch.stack([us, us]), _gen(9), n_particles=256)
    assert bres.means.shape == (2, T, 2) and bool(torch.isfinite(bres.log_likelihood).all())
    # independent draws per trajectory
    assert not torch.equal(bres.means[0], bres.means[1])


def test_particle_filter_accepts_psd_singular_noise():
    Qs = np.diag([0.0, 1e-3]).astype(np.float32)  # noise only on the velocity
    ys = np.random.default_rng(12).standard_normal((30, 1)).astype(np.float32)
    ft, ht = _torch_lin()
    pf = tm.particle_filter(ft, ht, Qs, R, _t(X0), P0, ys, np.zeros((30, 1), np.float32), _gen(2),
                            n_particles=512)
    assert bool(torch.isfinite(pf.means).all()) and bool(torch.isfinite(pf.log_likelihood))


def test_particle_filter_resample_methods_end_to_end():
    ys = _lti_ys()
    us = np.zeros((ys.shape[0], 1), np.float32)
    ft, ht = _torch_lin()
    runs = {m: tm.particle_filter(ft, ht, Q, R, _t(X0), P0, ys, us, _gen(3), n_particles=512,
                                  resample_method=m) for m in ("onehot", "gather", "pallas")}
    for m, r in runs.items():
        np.testing.assert_allclose(r.means.numpy(), runs["gather"].means.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(r.log_likelihood), float(runs["gather"].log_likelihood),
                                   rtol=1e-6)


DEVICE_CALLS = {
    "particle_filter": lambda x0, ys: tm.particle_filter(
        tm.pendulum_step, tm.first_components, Q, R, x0, P0, ys, np.zeros((4, 1), np.float32),
        n_particles=16),
    "particle_filter_batched": lambda x0, ys: tm.particle_filter_batched(
        tm.pendulum_step, tm.first_components, Q, R, x0[None], P0, ys[None],
        np.zeros((1, 4, 1), np.float32), n_particles=16),
}


@pytest.mark.parametrize("call", list(DEVICE_CALLS.values()), ids=list(DEVICE_CALLS))
def test_entry_points_default_to_the_card(call):
    """A numpy state goes to the card: without CUDA the call raises, because
    it reaches for it; a CPU tensor keeps the filter on the CPU."""
    ys = np.zeros((4, 1), np.float32)
    if torch.cuda.is_available():
        assert call(X0, ys).means.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(X0, ys)
    assert call(_t(X0), ys).means.device.type == "cpu"
