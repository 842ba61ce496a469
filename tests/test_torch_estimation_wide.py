"""The estimation kernels past the narrow forms' envelopes, on the CPU: the
batched Kalman filters and smoother of numpower_tpu_torch with an explicit
method="pallas" past K9's narrow (n <= 16, p <= 8) and K10's narrow
(n <= 16) envelope, where the JAX package's routes take their Pallas kernels
with no size check; the EKF and UKF kernels' route on the planar quadrotor
measured by its first 5 and 6 components; the routes of the wide forms.

Inputs are made from a seed with numpy and go to both packages. On the CPU
the port's wrappers run their plain PyTorch versions. The JAX kernels in
interpret mode are slow on the CPU past n = 16 (K9 at (17, 9), T = 3: about
70 s), so the filters are held against the JAX package's "xla" route, the
same algebra, which the JAX package's own tests hold equal to its kernels;
one K10 case runs JAX's rts_mean_pass_pallas in interpret mode. Tolerances
are the JAX package's for its kernels (tests/test_kernels.py:310-500): K9
means 2e-5, log-likelihood rtol 2e-4 / atol 2e-3; K10 2e-5; K11/K12 means
1e-4, covariances 1e-5, log-likelihood rtol 1e-3 / atol 5e-3.

The wide kernels themselves are held against these plain versions on the
card by tests/test_torch_estimation_cuda.py and chip_smoke.py (phase 30).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
from numpower_tpu.kernels.rts_batched import rts_mean_pass_pallas as jax_rts_mean_pass  # noqa: E402
from numpower_tpu.models import estimation as je  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.kernels import ekf, kalman_mean, rts_mean, ukf  # noqa: E402
from numpower_tpu_torch.kernels.rts_batched import rts_mean_pass_pallas  # noqa: E402
from numpower_tpu_torch.models import estimation as te  # noqa: E402

F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def formation(k: int, N: int, T: int, seed: int = 0) -> dict:
    """k quadrotor12(0.02) plants as one system (n = 12 k, m = 4 k), each
    vehicle's position (states 0-2) and attitude (6-8) measured (p = 6 k);
    Q = 1e-4 I, R = 1e-2 I, P0 = 0.1 I; N trajectories of T steps simulated
    through A with process noise from x0s = 0.3 N(0, 1) under inputs
    uss = 0.1 N(0, 1), yss = C x + noise. numpy float32."""
    Aq, Bq = jm.quadrotor12(0.02)
    A, B = np.kron(np.eye(k), Aq), np.kron(np.eye(k), Bq)
    C = np.kron(np.eye(k), np.eye(12)[[0, 1, 2, 6, 7, 8]])
    n, m, p = A.shape[0], B.shape[1], C.shape[0]
    rng = np.random.default_rng(seed)
    x0s = 0.3 * rng.standard_normal((N, n))
    uss = 0.1 * rng.standard_normal((N, T, m))
    x, ys = x0s, []
    for t in range(T):
        x = x @ A.T + uss[:, t] @ B.T + 1e-2 * rng.standard_normal((N, n))
        ys.append(x @ C.T + 0.1 * rng.standard_normal((N, p)))
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(A=f32(A), B=f32(B), C=f32(C), Q=f32(1e-4 * np.eye(n)), R=f32(1e-2 * np.eye(p)),
                P0=f32(0.1 * np.eye(n)), x0s=f32(x0s), yss=f32(np.stack(ys, 1)), uss=f32(uss))


def random_system(n: int, p: int, N: int, T: int, seed: int) -> dict:
    """A stable random (n, p) system with m = 3 inputs and random data of
    order one: A's spectral radius about 0.95, C and B N(0, 1) / sqrt(n), so
    that the innovations stay of order one at any width (the regime the
    bounds were set for)."""
    rng = np.random.default_rng(seed)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(A=f32(0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)),
                B=f32(rng.standard_normal((n, 3)) / np.sqrt(n)),
                C=f32(rng.standard_normal((p, n)) / np.sqrt(n)),
                Q=f32(0.01 * np.eye(n)), R=f32(0.1 * np.eye(p)), P0=f32(0.5 * np.eye(n)),
                x0s=f32(rng.standard_normal((N, n))), yss=f32(rng.standard_normal((N, T, p))),
                uss=f32(rng.standard_normal((N, T, 3))))


@pytest.fixture(scope="module")
def quads():
    """The four-quadrotor formation (n = 48, p = 24, m = 16) at N = 8,
    T = 10, and the JAX package's "xla" filter, with and without inputs."""
    d = formation(4, 8, 10)
    kf = [jnp.asarray(d[k]) for k in ("A", "C", "Q", "R", "x0s", "P0", "yss")]
    d["jax"] = {inputs: je.kalman_filter_batched(
        *kf, **(dict(B=jnp.asarray(d["B"]), uss=jnp.asarray(d["uss"])) if inputs else {}),
        method="xla") for inputs in (False, True)}
    return d


def _port_args(d, inputs):
    kf = [_t(d[k]) for k in ("A", "C", "Q", "R", "x0s", "P0", "yss")]
    return kf, (dict(B=_t(d["B"]), uss=_t(d["uss"])) if inputs else {})


def _assert_filter_close(got, want):
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.pred_means.numpy(), np.asarray(want.pred_means), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got.log_likelihood.numpy(), np.asarray(want.log_likelihood),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
@pytest.mark.parametrize("method", ["pallas", "auto"])
def test_batched_filter_past_the_narrow_envelope_matches_jax(quads, method, inputs):
    """kalman_filter_batched at the formation (n = 48, p = 24): an explicit
    "pallas" raised past K9's narrow envelope, where the JAX package runs
    its kernel; now it takes the kernel route (on the CPU its plain
    version) and agrees with the JAX package."""
    kf, kw = _port_args(quads, inputs)
    got = te.kalman_filter_batched(*kf, **kw, method=method)
    assert got.means.shape == (8, 10, 48) and got.log_likelihood.shape == (8,)
    _assert_filter_close(got, quads["jax"][inputs])


def test_sqrt_filter_past_the_narrow_envelope_matches_jax(quads):
    kf, kw = _port_args(quads, True)
    got = te.kalman_filter_sqrt_batched(*kf, **kw, method="pallas")
    want = je.kalman_filter_sqrt_batched(*(jnp.asarray(quads[k]) for k in (
        "A", "C", "Q", "R", "x0s", "P0", "yss")), B=jnp.asarray(quads["B"]),
        uss=jnp.asarray(quads["uss"]), method="xla")
    _assert_filter_close(got, want)
    np.testing.assert_allclose(got.chol_covs.numpy(), np.asarray(want.chol_covs), rtol=0,
                               atol=1e-5)


def test_smoother_past_the_narrow_envelope_matches_jax(quads):
    """kalman_smoother_batched at n = 48 with an explicit "pallas" (K10's
    route) on the port's filter, against the JAX package's "xla" smoother on
    its own filter."""
    kf, kw = _port_args(quads, True)
    filt = te.kalman_filter_batched(*kf, **kw, method="pallas")
    got = te.kalman_smoother_batched(_t(quads["A"]), filt, method="pallas")
    want = je.kalman_smoother_batched(jnp.asarray(quads["A"]), quads["jax"][True], method="xla")
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.covs.numpy(), np.asarray(want.covs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,p", [(17, 9), (33, 17)])
def test_filter_at_the_wide_edges_matches_jax(n, p):
    """(17, 9) just past both narrow bounds, (33, 17) past a 32-wide tile's
    rows: the filter with inputs, an explicit "pallas"."""
    d = random_system(n, p, 8, 6, seed=n + p)
    kf, kw = _port_args(d, True)
    got = te.kalman_filter_batched(*kf, **kw, method="pallas")
    want = je.kalman_filter_batched(*(jnp.asarray(d[k]) for k in (
        "A", "C", "Q", "R", "x0s", "P0", "yss")), B=jnp.asarray(d["B"]),
        uss=jnp.asarray(d["uss"]), method="xla")
    _assert_filter_close(got, want)


def test_rts_mean_pass_past_the_narrow_envelope_matches_jax_kernel():
    """K10 at n = 17 through the port's JAX name against the JAX kernel in
    interpret mode (T = 3)."""
    rng = np.random.default_rng(17)
    n, N, T = 17, 9, 3
    G = (0.5 * rng.standard_normal((T - 1, n, n)) / np.sqrt(n)).astype(np.float32)
    es = rng.standard_normal((T - 1, N, n)).astype(np.float32)
    x_last = rng.standard_normal((N, n)).astype(np.float32)
    want = jax_rts_mean_pass(jnp.asarray(G), jnp.asarray(es), jnp.asarray(x_last),
                             interpret=True)
    before = rts_mean.rts_mean_pass.launches
    got = rts_mean_pass_pallas(_t(G), _t(es), _t(x_last))
    assert got.shape == (T, N, n) and rts_mean.rts_mean_pass.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.fixture(scope="module", params=[5, 6])
def quad_measured(request):
    """The planar quadrotor (n = 6, m = 2) measured by its first p = 5 or 6
    components, B = 4 trajectories over T = 3 steps about the hover."""
    p = request.param
    rng = np.random.default_rng(p)
    B, T, n = 4, 3, 6
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return dict(p=p, Q=f32(np.eye(n) * 1e-3), R=f32(np.eye(p) * 1e-2), P0=f32(np.eye(n) * 0.1),
                x0s=f32(0.3 * rng.standard_normal((B, n))),
                ys=f32(0.3 * rng.standard_normal((B, T, p))),
                us=f32(0.1 * rng.standard_normal((B, T, 2)) + 0.5 * 9.81))


@pytest.mark.parametrize("which", ["ekf", "ukf"])
def test_whole_filters_at_every_measurement_width_match_jax(quad_measured, which):
    """ekf_filter_batched / ukf_filter_batched with method="pallas" on the
    planar quadrotor at p = 5 and 6: the port raised past p = 4, where the
    JAX package's explicit "pallas" runs; now the kernel route (on the CPU
    its plain version) agrees with the JAX package's "xla" route."""
    d = quad_measured
    p = d["p"]
    args = (d["Q"], d["R"], d["x0s"], d["P0"], d["ys"], d["us"])
    port = te.ekf_filter_batched if which == "ekf" else te.ukf_filter_batched
    jax_entry = je.ekf_filter_batched if which == "ekf" else je.ukf_filter_batched
    want = jax_entry(jm.planar_quadrotor_step, lambda x: x[..., :p],
                     *(jnp.asarray(a) for a in args), method="xla")
    got = port(tm.planar_quadrotor_step, functools.partial(tm.first_components, k=p),
               *(_t(a) for a in args), method="pallas")
    for g, w, atol in ((got.means, want.means, 1e-4), (got.covs, want.covs, 1e-5),
                       (got.pred_means, want.pred_means, 1e-4),
                       (got.pred_covs, want.pred_covs, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    np.testing.assert_allclose(got.log_likelihood.numpy(), np.asarray(want.log_likelihood),
                               rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("dims", [{"n": 17, "p": 1}, {"n": 16, "p": 9}, {"n": 48, "p": 24},
                                  {"n": 300, "p": 40}])
def test_auto_takes_the_wide_kernels_on_the_card(dims):
    assert te.route_batched("K9", "cuda", F32, dims) == "pallas"
    assert te.route_batched("K10", "cuda", F32, {"n": dims["n"]}) == "pallas"
    assert te.route_batched("K9", "cuda", torch.float64, dims) == "xla"


@pytest.mark.parametrize("kernel", ["K11", "K12"])
def test_whole_filter_routes_past_the_auto_envelope(kernel):
    """"auto" holds to the JAX package's ok_dims (p <= 4); an explicit
    "pallas" takes what the kernel takes, p <= n."""
    assert te.route_batched(kernel, "cuda", F32, {"n": 6, "p": 5, "m": 2}) == "xla"
    assert te.route_batched(kernel, "cuda", F32, {"n": 6, "p": 6, "m": 2}, "pallas") == "pallas"
    assert ekf.MAX_P == ekf.MAX_N and kalman_mean.MAX_P == 8 and ukf.ukf_batched.launches >= 0
