"""The estimation kernels of numpower_tpu_torch (K9 kalman_mean_pass, K10
rts_mean_pass, K11 ekf_batched, K12 ukf_batched) against the JAX package's
Pallas kernels, on the CPU; the routes of the batched filters; the
measurement registry.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs kalman_mean_pass_pallas, rts_mean_pass_pallas, ekf_pallas and ukf_pallas
in interpret mode, as tests/test_kernels.py does, on the same numpy inputs,
at the JAX package's small shapes (B = 7, T = 20, ragged for every tile).
Tolerances are the JAX package's for its kernels (tests/test_kernels.py:
310-500): K9 means 2e-5, log-likelihood rtol 2e-4 / atol 2e-3; K10 2e-5;
K11/K12 means 1e-4, covariances 1e-5, log-likelihood rtol 1e-3 / atol 5e-3.

The kernels themselves are held against these plain versions on the card by
tests/test_torch_estimation_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
from numpower_tpu.kernels.ekf import ekf_pallas  # noqa: E402
from numpower_tpu.kernels.kalman_batched import kalman_mean_pass_pallas  # noqa: E402
from numpower_tpu.kernels.rts_batched import rts_mean_pass_pallas  # noqa: E402
from numpower_tpu.kernels.ukf import ukf_pallas  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.kernels import ekf, kalman_mean, rts_mean, ukf  # noqa: E402
from numpower_tpu_torch.models import estimation as te  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def gains():
    """The covariance pass of a random (n, p) = (3, 2) system (the port's,
    float32) and mean-pass data of 7 trajectories over 20 steps."""
    rng = np.random.default_rng(4)
    n, p, N, T = 3, 2, 7, 20
    A = (np.eye(n) + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
    C = rng.standard_normal((p, n)).astype(np.float32)
    Q, R, P0 = (np.eye(n, dtype=np.float32) * 0.01, np.eye(p, dtype=np.float32) * 0.1,
                np.eye(n, dtype=np.float32) * 0.5)
    ys = rng.standard_normal((N, T, p)).astype(np.float32)
    x0s = rng.standard_normal((N, n)).astype(np.float32)
    us = (0.3 * rng.standard_normal((T, N, n))).astype(np.float32)
    filt = te.kalman_filter_batched(A, C, Q, R, _t(x0s), P0, _t(ys), method="xla")
    # gains as kalman_filter_batched forms them: W = S^-1 C P_p, invL = chol(S)^-1
    P_p, C_t = filt.pred_covs[0], torch.from_numpy(C)
    S = C_t @ P_p @ C_t.T + torch.from_numpy(R)
    L = torch.linalg.cholesky(0.5 * (S + S.transpose(1, 2)))
    Ws = torch.cholesky_solve(C_t @ P_p, L)
    invLs = torch.linalg.solve_triangular(L, torch.eye(p).expand(T, p, p), upper=False)
    logdets = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    return dict(A=A, C=C, Ws=Ws.numpy(), invLs=invLs.numpy(), logdets=logdets.numpy(),
                x0s=x0s, ys_t=ys.transpose(1, 0, 2).copy(), us_t=us, filt=filt)


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
def test_kalman_mean_plain_matches_pallas(gains, inputs):
    g = gains
    args = [g[k] for k in ("A", "C", "Ws", "invLs", "logdets", "x0s", "ys_t")]
    us_t = g["us_t"] if inputs else None
    xf_j, xp_j, ll_j = kalman_mean_pass_pallas(
        *(jnp.asarray(a) for a in args), None if us_t is None else jnp.asarray(us_t),
        tile_b=1024, interpret=True)
    xf, xp, ll = kalman_mean.kalman_mean_pass(*(_t(a) for a in args),
                                              None if us_t is None else _t(us_t))
    assert xf.shape == (20, 7, 3) and ll.shape == (7,)
    np.testing.assert_allclose(xf.numpy(), np.asarray(xf_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xp_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=2e-4, atol=2e-3)


def test_rts_mean_plain_matches_pallas(gains):
    filt = gains["filt"]
    A = torch.from_numpy(gains["A"])
    P_f, P_p = filt.covs[0], filt.pred_covs[0]
    G_Ts = torch.linalg.solve(P_p[1:], A @ P_f[:-1])          # G_t' = P_p^-1 A P_f
    xs_f_t, xs_p_t = filt.means.transpose(0, 1), filt.pred_means.transpose(0, 1)
    es_t = xs_f_t[:-1] - torch.einsum("tnj,tjk->tnk", xs_p_t[1:], G_Ts)
    want = rts_mean_pass_pallas(jnp.asarray(G_Ts.numpy()), jnp.asarray(es_t.numpy()),
                                jnp.asarray(xs_f_t[-1].numpy()), tile_b=1024, interpret=True)
    got = rts_mean.rts_mean_pass(G_Ts, es_t.contiguous(), xs_f_t[-1].contiguous())
    assert got.shape == (20, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


PLANTS = {  # name: (n, m, p measured)
    "pendulum_step": (2, 1, 1), "unicycle_step": (3, 2, 2),
}


@pytest.fixture(scope="module", params=list(PLANTS))
def nonlinear(request):
    name = request.param
    n, m, p = PLANTS[name]
    rng = np.random.default_rng(2)
    B, T = 7, 20
    return dict(name=name, n=n, p=p,
                Q=np.eye(n, dtype=np.float32) * 1e-3, R=np.eye(p, dtype=np.float32) * 1e-2,
                P0=np.eye(n, dtype=np.float32) * 0.1,
                ys=rng.standard_normal((B, T, p)).astype(np.float32),
                us=(0.1 * rng.standard_normal((B, T, m))).astype(np.float32),
                x0s=(0.3 * rng.standard_normal((B, n))).astype(np.float32))


@pytest.mark.parametrize("which", ["ekf", "ukf"])
def test_whole_filter_plain_matches_pallas(nonlinear, which):
    d = nonlinear
    p = d["p"]
    args = (d["Q"], d["R"], d["x0s"], d["P0"], d["ys"], d["us"])
    jax_kernel = ekf_pallas if which == "ekf" else ukf_pallas
    want = jax_kernel(getattr(jm, d["name"]), lambda x: x[:p], *(jnp.asarray(a) for a in args),
                      interpret=True)
    port = ekf.ekf_batched if which == "ekf" else ukf.ukf_batched
    got = port(getattr(tm, d["name"]), functools.partial(tm.first_components, k=p),
               *(_t(a) for a in args))
    for k, atol in enumerate((1e-4, 1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-3, atol=5e-3)


def test_plain_versions_follow_the_kernels_symmetry(nonlinear):
    """The plain K11/K12 keep a covariance symmetric the kernels' way (the
    upper triangle mirrored): their covariances are exactly symmetric."""
    d = nonlinear
    args = (d["Q"], d["R"], _t(d["x0s"]), d["P0"], _t(d["ys"]), _t(d["us"]))
    h = functools.partial(tm.first_components, k=d["p"])
    for port in (ekf.ekf_batched, ukf.ukf_batched):
        out = port(getattr(tm, d["name"]), h, *args)
        for P in (out[1], out[3]):
            assert torch.equal(P, P.transpose(-1, -2))


def test_wrappers_on_cpu_take_the_plain_version(gains, nonlinear):
    g, d = gains, nonlinear
    before = (kalman_mean.kalman_mean_pass.launches, rts_mean.rts_mean_pass.launches,
              ekf.ekf_batched.launches, ukf.ukf_batched.launches)
    args = [_t(g[k]) for k in ("A", "C", "Ws", "invLs", "logdets", "x0s", "ys_t")]
    for a, b in zip(kalman_mean.kalman_mean_pass(*args),
                    kalman_mean.kalman_mean_pass_reference(*args)):
        assert torch.equal(a, b)
    G = torch.eye(3).expand(19, 3, 3)
    es = torch.ones((19, 7, 3))
    assert torch.equal(rts_mean.rts_mean_pass(G, es, args[5]),
                       rts_mean.rts_mean_pass_reference(G, es, args[5]))
    # any torch plant and measurement run on the CPU, registered or not
    f = getattr(tm, d["name"])
    nl = (d["Q"], d["R"], _t(d["x0s"]), d["P0"], _t(d["ys"]), _t(d["us"]))
    h = functools.partial(tm.first_components, k=d["p"])
    for plant, meas in ((f, h), (lambda x, u: f(x, u), lambda x: h(x))):
        for port, ref in ((ekf.ekf_batched, ekf.ekf_reference),
                          (ukf.ukf_batched, ukf.ukf_reference)):
            assert all(torch.equal(a, b) for a, b in zip(port(plant, meas, *nl),
                                                         ref(plant, meas, *nl)))
    assert (kalman_mean.kalman_mean_pass.launches, rts_mean.rts_mean_pass.launches,
            ekf.ekf_batched.launches, ukf.ukf_batched.launches) == before


F32, F64 = torch.float32, torch.float64
KF, NL = {"n": 2, "p": 1}, {"n": 2, "p": 1, "m": 1}   # the bench's filter and pendulum


# Past the narrow forms' envelope (MAX_N, MAX_P) "auto" takes the wide form:
# these cases keep the ids they had when it took the plain route there.
@pytest.mark.parametrize("args,want", [
    (("cuda", F32, KF), "pallas"),                      # the bench's shape
    (("cuda", F32, {"n": kalman_mean.MAX_N, "p": kalman_mean.MAX_P}), "pallas"),
    pytest.param(("cuda", F32, {"n": kalman_mean.MAX_N + 1, "p": 1}), "pallas", id="args2-xla"),
    pytest.param(("cuda", F32, {"n": 2, "p": kalman_mean.MAX_P + 1}), "pallas", id="args3-xla"),
    (("cuda", F64, KF), "xla"),                         # the kernel takes float32
    (("cpu", F32, KF), "xla"),
    (("cpu", F32, KF, "pallas"), "pallas"),             # the plain version on the CPU
    (("cpu", F64, KF, "pallas"), "pallas"),
    (("cuda", F32, KF, "xla"), "xla"),
    (("cuda", F64, KF, "xla"), "xla"),
])
def test_route_kalman_batched(args, want):
    assert te.route_batched("K9", *args) == want


@pytest.mark.parametrize("args,want", [
    (("cuda", F32, {"n": 2}), "pallas"), (("cuda", F32, {"n": rts_mean.MAX_N}), "pallas"),
    pytest.param(("cuda", F32, {"n": rts_mean.MAX_N + 1}), "pallas", id="args2-xla"),
    (("cpu", F32, {"n": 2}), "xla"),
    (("cpu", F32, {"n": 2}, "pallas"), "pallas"), (("cuda", F32, {"n": 2}, "xla"), "xla"),
    (("cuda", F64, {"n": 2}), "xla"),
])
def test_route_smoother_batched(args, want):
    assert te.route_batched("K10", *args) == want


@pytest.mark.parametrize("kernel", ["K11", "K12"])
@pytest.mark.parametrize("args,want", [
    (("cuda", F32, NL), "pallas"),                      # the bench's pendulum, any f and h
    (("cuda", F32, {"n": 8, "p": 4, "m": 4}), "pallas"),  # the JAX ok_dims' corner
    (("cuda", F32, {"n": 9, "p": 1, "m": 1}), "xla"),
    (("cuda", F32, {"n": 2, "p": 5, "m": 1}), "xla"),
    (("cuda", F32, {"n": 2, "p": 1, "m": 5}), "xla"),
    (("cuda", F64, NL), "xla"),
    (("cpu", F32, NL), "xla"),
    (("cpu", F32, NL, "pallas"), "pallas"),
    (("cuda", F32, NL, "xla"), "xla"),
])
def test_route_whole_filters(kernel, args, want):
    assert te.route_batched(kernel, *args) == want


@pytest.mark.parametrize("call", [
    lambda: te.route_batched("K11", "cuda", F32, {"n": 6, "p": 7, "m": 2}, "pallas"),  # p > n
    lambda: te.route_batched("K9", "cpu", F32, KF, "fused"),
    lambda: te.route_batched("K12", "cpu", F32, {"n": 6, "p": 2, "m": 5}, "pallas"),
    lambda: te.route_batched("K10", "cpu", F32, {"n": 2}, "plain"),
    lambda: te.route_batched("K11", "cpu", F32, {"n": 9, "p": 1, "m": 1}, "pallas"),
    lambda: te.route_batched("K12", "cuda", F32, {"n": 2, "p": 5, "m": 1}, "pallas"),
    lambda: te.route_batched("K12", "cuda", F32, NL, "vmap"),
])
def test_routes_reject_what_they_do_not_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("kernel,dims", [("K9", {"n": kalman_mean.MAX_N + 1, "p": 1}),
                                         ("K10", {"n": rts_mean.MAX_N + 1})])
def test_explicit_pallas_past_the_narrow_forms_takes_the_kernel_route(kernel, dims):
    """An explicit "pallas" past the narrow forms' envelope takes the kernel
    route, as the JAX package's routes (no size check): on the card the wide
    form, on the CPU the plain version, which the entry point runs."""
    assert te.route_batched(kernel, "cuda", F32, dims, "pallas") == "pallas"
    assert te.route_batched(kernel, "cpu", F32, dims, "pallas") == "pallas"
    n, p, N, T = dims["n"], dims.get("p", 1), 3, 4
    rng = np.random.default_rng(n)
    A = _t(0.9 * np.eye(n, dtype=np.float32))
    C = _t(rng.standard_normal((p, n)).astype(np.float32))
    kf = (A, C, 0.01 * torch.eye(n), 0.1 * torch.eye(p), _t(rng.standard_normal((N, n))).float(),
          0.5 * torch.eye(n), _t(rng.standard_normal((N, T, p))).float())
    before = (kalman_mean.kalman_mean_pass.launches, rts_mean.rts_mean_pass.launches)
    got = te.kalman_filter_batched(*kf, method="pallas")
    want = te.kalman_filter_batched(*kf, method="xla")
    if kernel == "K10":
        got, want = (te.kalman_smoother_batched(A, want, method=m) for m in ("pallas", "xla"))
    assert torch.equal(got.means, want.means)
    assert (kalman_mean.kalman_mean_pass.launches, rts_mean.rts_mean_pass.launches) == before


@pytest.mark.parametrize("method", ["auto", "pallas", "xla"])
def test_mean_chunk_takes_the_chunked_pass_whatever_the_method(gains, method):
    """As in the JAX package, mean_chunk > 1 takes the chunk-parallel
    recovery for any method (here "pallas" too launches nothing)."""
    g = gains
    args = (g["A"], g["C"], np.eye(3, dtype=np.float32) * 0.01, np.eye(2, dtype=np.float32) * 0.1,
            _t(g["x0s"]), np.eye(3, dtype=np.float32) * 0.5, _t(g["ys_t"].transpose(1, 0, 2)))
    before = kalman_mean.kalman_mean_pass.launches
    got = te.kalman_filter_batched(*args, mean_chunk=4, method=method)
    want = te.kalman_filter_batched(*args, method="xla")
    assert kalman_mean.kalman_mean_pass.launches == before
    # test_batched_mean_chunked_matches_sequential's bound (tests/test_estimation.py)
    np.testing.assert_allclose(got.means.numpy(), want.means.numpy(), rtol=1e-4, atol=1e-4)


def test_measurement_registry():
    assert tm.kernel_measurement(tm.first_components) == (0, 1)
    assert tm.kernel_measurement(functools.partial(tm.first_components, k=3)) == (0, 3)
    assert tm.kernel_measurement(lambda x: x[..., :1]) is None
    assert tm.kernel_measurement(functools.partial(tm.first_components, torch.zeros(2))) is None
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(tm.first_components(x, k=2), x[:, :2])


def test_unregistered_plant_or_measurement_on_the_kernel_route_raises(nonlinear):
    """The kernel's operand check (run by the wrappers for a CUDA tensor)
    names the registry; here on CPU tensors, where it can be called alone."""
    d = nonlinear
    args = (d["Q"], d["R"], _t(d["x0s"]), d["P0"], _t(d["ys"]), _t(d["us"]))
    f, h = getattr(tm, d["name"]), functools.partial(tm.first_components, k=d["p"])
    with pytest.raises(ValueError, match="kernel_plant"):
        ekf.kernel_operands(lambda x, u: f(x, u), h, *args, what="EKF")
    with pytest.raises(ValueError, match="kernel_measurement"):
        ekf.kernel_operands(f, lambda x: x[..., :1], *args, what="UKF")
    with pytest.raises(ValueError, match="measured"):
        ekf.kernel_operands(f, functools.partial(tm.first_components, k=d["p"] + 1), *args,
                            what="EKF")
    plant, meas, ins, outs = ekf.kernel_operands(f, h, *args, what="EKF")
    assert (plant.n, meas.p) == (d["n"], d["p"]) and outs[1].shape == (7, 20, d["n"], d["n"])
