"""The state estimators of numpower_tpu_torch (models/estimation.py) against
the JAX package's, on the CPU, on the same numpy inputs.

Every public function of the module, with and without known inputs, the
chunked mean pass (mean_chunk) and the unpivoted associative combine
(nopivot). The batched filters run both routes; on the CPU the kernel route
("pallas") is the kernels' plain versions. Tolerances are the JAX package's
own for the nearest comparison it makes (tests/test_estimation.py,
tests/test_kernels.py), named at each use.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
from numpower_tpu.models import estimation as je  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.models import estimation as te  # noqa: E402

# two implementations of the same filter (test_batched_fast_path_matches_vmap)
SAME = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    for field in want._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   err_msg=field, **tol)


@pytest.fixture(scope="module")
def lti():
    """test_batched_fast_path_matches_vmap's system: n = 3, p = 2, m = 2."""
    rng = np.random.default_rng(3)
    n, p, m, N, T = 3, 2, 2, 9, 17
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(A=f32(np.eye(n) + 0.05 * rng.standard_normal((n, n))),
                C=f32(rng.standard_normal((p, n))), B=f32(rng.standard_normal((n, m))),
                Q=f32(np.eye(n) * 0.01), R=f32(np.eye(p) * 0.1), P0=f32(np.eye(n) * 0.5),
                x0s=f32(rng.standard_normal((N, n))), yss=f32(rng.standard_normal((N, T, p))),
                uss=f32(0.3 * rng.standard_normal((N, T, m))))


def _kw(d, inputs, batched):
    if not inputs:
        return {}, {}
    key = "uss" if batched else "us"
    us = d["uss"] if batched else d["uss"][0]
    return {"B": d["B"], key: us}, {"B": _t(d["B"]), key: _t(us)}


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
def test_kalman_filter_and_its_batch_match_jax(lti, inputs):
    d = lti
    mats = (d["A"], d["C"], d["Q"], d["R"])
    jkw, tkw = _kw(d, inputs, batched=False)
    want = je.kalman_filter(*mats, d["x0s"][0], d["P0"], d["yss"][0], **jkw)
    got = te.kalman_filter(*mats, _t(d["x0s"][0]), d["P0"], _t(d["yss"][0]), **tkw)
    _close(got, want, **SAME)
    # leading batch dims: the JAX package's vmap of the same filter
    jkw, tkw = _kw(d, inputs, batched=True)
    tkw = {"B": tkw["B"], "us": tkw["uss"]} if inputs else {}
    want_b = je._kalman_filter_batched_vmap(*mats, d["x0s"], d["P0"], d["yss"], **jkw)
    got_b = te.kalman_filter(*mats, _t(d["x0s"]), d["P0"], _t(d["yss"]), **tkw)
    _close(got_b, want_b, **SAME)


@pytest.mark.parametrize("method", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
def test_kalman_filter_batched_matches_jax(lti, method, inputs):
    d = lti
    mats = (d["A"], d["C"], d["Q"], d["R"])
    jkw, tkw = _kw(d, inputs, batched=True)
    want = je.kalman_filter_batched(*mats, d["x0s"], d["P0"], d["yss"], method="xla", **jkw)
    got = te.kalman_filter_batched(*mats, _t(d["x0s"]), d["P0"], _t(d["yss"]), method=method,
                                   **tkw)
    _close(got, want, **SAME)
    assert got.means.device.type == "cpu"


@pytest.mark.parametrize("L", [4, 8, 16])
def test_mean_chunk_matches_jax(L):
    """test_batched_mean_chunked_matches_sequential's setting and bounds
    (rtol 1e-4, atol 1e-4; ll atol 1e-2)."""
    rng = np.random.default_rng(0)
    A = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)
    C = np.array([[1.0, 0.0]], np.float32)
    Q, R, P0 = (np.eye(2, dtype=np.float32) * 1e-3, np.eye(1, dtype=np.float32) * 1e-2,
                np.eye(2, dtype=np.float32) * 0.1)
    N, T = 16, 30
    yss = rng.standard_normal((N, T, 1)).astype(np.float32)
    x0s = rng.standard_normal((N, 2)).astype(np.float32)
    B = np.array([[0.005], [0.1]], np.float32)
    uss = rng.standard_normal((N, T, 1)).astype(np.float32)
    want = je.kalman_filter_batched(A, C, Q, R, x0s, P0, yss, B=B, uss=uss, mean_chunk=L)
    got = te.kalman_filter_batched(A, C, Q, R, _t(x0s), P0, _t(yss), B=_t(B), uss=_t(uss),
                                   mean_chunk=L)
    for field in ("means", "pred_means"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.log_likelihood.numpy(), np.asarray(want.log_likelihood),
                               rtol=1e-4, atol=1e-2)


def test_mean_chunk_outside_its_envelope_raises(lti):
    d = lti
    with pytest.raises(ValueError, match="mean_chunk"):
        te.kalman_filter_batched(d["A"], d["C"], d["Q"], d["R"], _t(d["x0s"]), d["P0"],
                                 _t(d["yss"]), mean_chunk=17)


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_smoothers_match_jax(lti, method):
    """kalman_smoother (one trajectory and a batch) and
    kalman_smoother_batched against the JAX package
    (test_smoother_batched_matches_vmap: rtol 1e-5, atol 1e-4)."""
    d = lti
    mats = (d["A"], d["C"], d["Q"], d["R"])
    jkw, tkw = _kw(d, True, batched=True)
    jf = je.kalman_filter_batched(*mats, d["x0s"], d["P0"], d["yss"], **jkw)
    tf = te.kalman_filter_batched(*mats, _t(d["x0s"]), d["P0"], _t(d["yss"]), **tkw)
    want = je.kalman_smoother_batched(d["A"], jf, method="xla")
    _close(te.kalman_smoother_batched(d["A"], tf, method=method), want, **SAME)
    # the vmapped form: kalman_smoother on the batch
    _close(te.kalman_smoother(d["A"], tf), want, **SAME)
    one = te.kalman_smoother(d["A"], te.KalmanResult(*(f[0] for f in tf[:4]),
                                                     tf.log_likelihood[0]))
    _close(one, jax.tree.map(lambda a: a[0], want), **SAME)


def test_smoother_batched_t1_passthrough():
    A = np.eye(2, dtype=np.float32)
    filt = te.kalman_filter_batched(A, A[:1], np.eye(2, dtype=np.float32) * 0.01,
                                    np.eye(1, dtype=np.float32) * 0.1, torch.zeros((4, 2)),
                                    A, torch.zeros((4, 1, 1)))
    sm = te.kalman_smoother_batched(A, filt)
    assert torch.equal(sm.means, filt.means)


@pytest.fixture(scope="module")
def di():
    """tests/test_estimation.py's lti_data system, T = 40."""
    A, B = jm.double_integrator(0.1)
    rng = np.random.default_rng(0)
    T = 40
    return dict(A=np.asarray(A), B=np.asarray(B), C=np.array([[1.0, 0.0]], np.float32),
                Q=np.eye(2, dtype=np.float32) * 1e-3, R=np.eye(1, dtype=np.float32) * 1e-2,
                P0=np.eye(2, dtype=np.float32) * 0.1, x0=np.array([1.0, 0.0], np.float32),
                ys=rng.standard_normal((T, 1)).astype(np.float32),
                us=(0.4 * rng.standard_normal((T, 1))).astype(np.float32))


@pytest.mark.parametrize("nopivot,inputs", [(False, False), (True, False), (False, True)],
                         ids=["pivot", "nopivot", "pivot_inputs"])
def test_kalman_filter_associative_matches_jax(di, nopivot, inputs):
    """The associative filter against the JAX package's (T = 16: the JAX
    side runs eagerly), at its bound against the sequential filter
    (test_kalman_associative_matches_sequential: rtol 1e-3, atol 1e-4 on
    means, 1e-5 on covariances)."""
    d = di
    mats = (d["A"], d["C"], d["Q"], d["R"])
    ys = d["ys"][:16]
    kw = dict(B=d["B"], us=d["us"][:16]) if inputs else {}
    want = je.kalman_filter_associative(*mats, d["x0"], d["P0"], ys, nopivot=nopivot, **kw)
    got = te.kalman_filter_associative(*mats, _t(d["x0"]), d["P0"], _t(ys),
                                       nopivot=nopivot, **{k: _t(v) for k, v in kw.items()})
    for field, atol in (("means", 1e-4), ("covs", 1e-5), ("pred_means", 1e-4),
                        ("pred_covs", 1e-5)):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-3, atol=atol, err_msg=field)
    np.testing.assert_allclose(float(got.log_likelihood), float(want.log_likelihood), rtol=1e-3)


def test_kalman_smoother_associative_matches_jax(di):
    """test_smoother_associative_matches_sequential's bound (atol 2e-5)."""
    d = di
    mats = (d["A"], d["C"], d["Q"], d["R"])
    jf = je.kalman_filter(*mats, d["x0"], d["P0"], d["ys"][:16])
    tf = te.kalman_filter(*mats, _t(d["x0"]), d["P0"], _t(d["ys"][:16]))
    want = je.kalman_smoother_associative(d["A"], jf)
    got = te.kalman_smoother_associative(d["A"], tf)
    _close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
def test_kalman_filter_sqrt_matches_jax(di, inputs):
    """test_sqrt_kalman_matches_standard's bounds: means and factors atol
    1e-5, log-likelihood rtol 1e-4."""
    d = di
    mats = (d["A"], d["C"], d["Q"], d["R"])
    kw = dict(B=d["B"], us=d["us"]) if inputs else {}
    want = je.kalman_filter_sqrt(*mats, d["x0"], d["P0"], d["ys"], **kw)
    got = te.kalman_filter_sqrt(*mats, _t(d["x0"]), d["P0"], _t(d["ys"]),
                                **{k: _t(v) for k, v in kw.items()})
    for field in want._fields[:4]:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-5, err_msg=field)
    np.testing.assert_allclose(float(got.log_likelihood), float(want.log_likelihood), rtol=1e-4)


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_kalman_filter_sqrt_batched_matches_jax(di, method):
    """test_sqrt_batched_matches_vmapped_sqrt's bounds: means atol 2e-5, ll
    rtol 2e-4 atol 2e-3, factors atol 1e-6; with known inputs, against the
    JAX package's batched filter and the port's own sqrt filter on the batch."""
    d = di
    rng = np.random.default_rng(6)
    N, T = 8, d["ys"].shape[0]
    yss = rng.standard_normal((N, T, 1)).astype(np.float32)
    x0s = rng.standard_normal((N, 2)).astype(np.float32)
    uss = rng.standard_normal((N, T, 1)).astype(np.float32)
    Bm = np.array([[0.005], [0.1]], np.float32)
    mats = (d["A"], d["C"], d["Q"], d["R"])
    want = je.kalman_filter_sqrt_batched(*mats, x0s, d["P0"], yss, B=Bm, uss=uss, method="xla")
    got = te.kalman_filter_sqrt_batched(*mats, _t(x0s), d["P0"], _t(yss), B=_t(Bm), uss=_t(uss),
                                        method=method)
    per = te.kalman_filter_sqrt(*mats, _t(x0s), d["P0"], _t(yss), B=_t(Bm), us=_t(uss))
    for ref in (want, per):
        np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means), atol=2e-5)
        np.testing.assert_allclose(got.log_likelihood.numpy(), np.asarray(ref.log_likelihood),
                                   rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(got.chol_covs.numpy(), np.asarray(ref.chol_covs), atol=1e-6)


def test_sqrt_filter_accepts_psd_singular_noise(di):
    """test_sqrt_kalman_and_pf_accept_psd_singular_noise: Q driving only the
    velocity; the sqrt filter stays finite and matches kalman_filter (1e-5)."""
    d = di
    Q = np.diag([0.0, 1e-3]).astype(np.float32)
    ref = te.kalman_filter(d["A"], d["C"], Q, d["R"], _t(d["x0"]), d["P0"], _t(d["ys"]))
    sq = te.kalman_filter_sqrt(d["A"], d["C"], Q, d["R"], _t(d["x0"]), d["P0"], _t(d["ys"]))
    assert bool(torch.isfinite(sq.means).all())
    np.testing.assert_allclose(sq.means.numpy(), ref.means.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def pendulum():
    """tests/test_estimation.py's EKF/UKF pendulum (T = 30), with the
    registered plant and measurement on the port's side."""
    rng = np.random.default_rng(3)
    T = 30
    us = (0.5 * np.sin(0.3 * np.arange(T))).astype(np.float32).reshape(T, 1)
    xs = jm.rollout_nonlinear(jm.pendulum_step, jnp.array([0.5, 0.0]), jnp.asarray(us))
    ys = (np.asarray(xs[1:, 0]).reshape(T, 1)
          + 0.05 * rng.standard_normal((T, 1))).astype(np.float32)
    return dict(us=us, ys=ys, Q=np.eye(2, dtype=np.float32) * 1e-4,
                R=np.eye(1, dtype=np.float32) * 2.5e-3, x0=np.zeros(2, np.float32),
                P0=np.eye(2, dtype=np.float32))


@pytest.mark.parametrize("name", ["ekf_filter", "ukf_filter"])
def test_nonlinear_filters_match_jax(pendulum, name):
    """One trajectory and a batch of two, at the JAX package's kernel-vs-vmap
    bounds (test_ekf_pallas_matches_vmap: means 1e-4, covariances 1e-5, ll
    rtol 1e-3, atol 5e-3)."""
    d = pendulum
    want = getattr(je, name)(jm.pendulum_step, lambda x: x[:1], d["Q"], d["R"], d["x0"],
                             d["P0"], d["ys"], d["us"])
    fn = getattr(te, name)
    args = (tm.pendulum_step, tm.first_components, d["Q"], d["R"])
    got = fn(*args, _t(d["x0"]), d["P0"], _t(d["ys"]), _t(d["us"]))
    bounds = dict(means=1e-4, covs=1e-5, pred_means=1e-4, pred_covs=1e-5)
    for field, atol in bounds.items():
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=atol, err_msg=field)
    np.testing.assert_allclose(float(got.log_likelihood), float(want.log_likelihood), rtol=1e-3,
                               atol=5e-3)
    stack = lambda a: torch.stack([_t(a), _t(a)])  # noqa: E731
    got_b = fn(*args, torch.tensor([[0.0, 0.0], [0.1, 0.0]]), d["P0"], stack(d["ys"]),
               stack(d["us"]))
    assert got_b.means.shape == (2, 30, 2) and got_b.covs.shape == (2, 30, 2, 2)
    np.testing.assert_allclose(got_b.means[0].numpy(), got.means.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", ["ekf_filter_batched", "ukf_filter_batched"])
@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_nonlinear_batched_filters_match_jax(name, method):
    """test_ukf_pallas_multi_obs_dims' shape (B = 6, T = 15) on the registered
    unicycle (n = 3, m = 2) measuring p = 2, against the JAX package's vmapped
    filter, at test_ekf_pallas_matches_vmap's bounds."""
    rng = np.random.default_rng(10)
    B, T, n, m, p = 6, 15, 3, 2, 2
    Q, R, P0 = (np.eye(n, dtype=np.float32) * 1e-3, np.eye(p, dtype=np.float32) * 1e-2,
                np.eye(n, dtype=np.float32) * 0.2)
    ys = rng.standard_normal((B, T, p)).astype(np.float32)
    us = (0.1 * rng.standard_normal((B, T, m))).astype(np.float32)
    x0s = (0.3 * rng.standard_normal((B, n))).astype(np.float32)
    want = getattr(je, name)(jm.unicycle_step, lambda x: x[:2], Q, R, x0s, P0, ys, us,
                             method="xla")
    got = getattr(te, name)(tm.unicycle_step, functools.partial(tm.first_components, k=2), Q, R,
                            _t(x0s), P0, _t(ys), _t(us), method=method)
    for field, atol in (("means", 1e-4), ("covs", 1e-5), ("pred_means", 1e-4)):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=atol, err_msg=field)
    np.testing.assert_allclose(got.log_likelihood.numpy(), np.asarray(want.log_likelihood),
                               rtol=1e-3, atol=5e-3)


def test_ukf_equals_kf_on_a_linear_system(di):
    """test_ukf_equals_kf_on_linear_system's bounds: the unscented transform
    is exact for linear f and h (means rtol 2e-3 atol 2e-4)."""
    d = di
    A, B, C = (torch.from_numpy(d[k]) for k in ("A", "B", "C"))
    T = 30
    kf = te.kalman_filter(A, C, d["Q"], d["R"], _t(d["x0"]), d["P0"], _t(d["ys"][:T]))
    uk = te.ukf_filter(lambda x, u: x @ A.T + u @ B.T, lambda x: x @ C.T, d["Q"], d["R"],
                       _t(d["x0"]), d["P0"], _t(d["ys"][:T]), torch.zeros((T, 1)))
    np.testing.assert_allclose(uk.means.numpy(), kf.means.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(uk.covs.numpy(), kf.covs.numpy(), rtol=5e-3, atol=5e-5)
    np.testing.assert_allclose(float(uk.log_likelihood), float(kf.log_likelihood), rtol=1e-3)


def test_inputs_require_b(lti):
    d = lti
    with pytest.raises(ValueError, match="requires B"):
        te.kalman_filter(d["A"], d["C"], d["Q"], d["R"], _t(d["x0s"][0]), d["P0"],
                         _t(d["yss"][0]), us=_t(d["uss"][0]))
    with pytest.raises(ValueError, match="requires B"):
        te.kalman_filter_batched(d["A"], d["C"], d["Q"], d["R"], _t(d["x0s"]), d["P0"],
                                 _t(d["yss"]), uss=_t(d["uss"]))
