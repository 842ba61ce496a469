"""The estimation CUDA kernels of numpower_tpu_torch (K9 kalman_mean_pass,
K10 rts_mean_pass, K11 ekf_batched, K12 ukf_batched) against their plain
PyTorch versions, on the card; the dual-number Jacobians of K11 against
torch.func.jacfwd; the batched filters' launches.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest:

    python -m pytest --noconftest tests/test_torch_estimation_cuda.py -q

Tolerances: the JAX package's for its kernels (tests/test_kernels.py:
310-500): K9 means 2e-5, log-likelihood rtol 2e-4 / atol 2e-3; K10 2e-5;
K11/K12 means 1e-4, covariances 1e-5, log-likelihood rtol 1e-3 / atol 5e-3
(the kernels' rsqrtf pivots are within 2 ulp, CUDA's bound). Those bounds
were set on data of order one; the test problems here stay there: stable
random LTI systems, and measurements of each plant's own rollout over a
horizon short enough that the unstable cartpole and the barely observed
planar quadrotor keep their covariances under one. N = 1003 and B = 257 are
ragged for every block (32 trajectories, or 32 / G). K11 and K12 are also
checked on every plant x measurement width (p = 1 .. n) x B in {1, 3, 1003,
1024} x T in {1, 2, 50, 67} (their 16-step input chunks) and on misaligned
operands, and K9 on N in {1, 63, 1003, 4096} x T in {1, 2, 50, 130} x
(n, p) in {(2, 1), (4, 4), (16, 8), (48, 24)}, with and without inputs, and
on misaligned operands; K10 at every bucket and past it (n = 17, 48, 130,
300) x N in {1, 31, 33, 4096} x T on its chunk edges {2, 17, 18, 33, 50,
130}, and on misaligned e_t and x_last. The wide K9 and K10 (past n = 16 or
p = 8, csrc/kalman_wide.cu) are also held to float64 in each of their three
forms, up to (n, p) = (4000, 3); past the narrow forms C and B are N(0, 1) /
sqrt(n), which keeps the innovations of order one at any width. The wide
K9's form 0 (its products on the tensor cores) is held to float64 at the
four-quadrotor formation and at chip_smoke.KALMAN_WIDE_EDGES; its forms 1
and 2 and the wide K10 to the SHA-256 digests of the kernels before (the
file imports chip_smoke, so run it from the repository's root). Past
those horizons the data keep to a regime of order one (X_NOM): from 0.3
N(0, 1) with only the cart position (or px) measured, the cartpole's and
the planar quadrotor's unmeasured covariances grow to 13-156 by T = 50-67,
where the float32 plain version alone is 1e-4 to 2e-3 off float64, so an
absolute bound of 1e-5 would measure the data, not the kernel (the first
port's kernel gave the same numbers there, bit for bit).
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (
    K9_WIDE_DIGESTS, KALMAN_WIDE_EDGES, N_FORMATION, T_KF_EDGE, held_against, kalman_mean_operands,
    kalman_wide_checksums, quad_estimation, random_estimation,
)
from numpower_tpu_torch.kernels import ekf, kalman_mean, rts_mean, ukf
from numpower_tpu_torch.models import (
    MPCController, cartpole_step, double_integrator, ekf_filter_batched, first_components,
    kalman_estimator, kalman_filter_batched, kalman_filter_sqrt_batched, kalman_smoother_batched,
    pendulum_step, planar_quadrotor_step, rollout_nonlinear, simulate_closed_loop,
    ukf_filter_batched, unicycle_step,
)
from numpower_tpu_torch.models.estimation import _jac_x

pytestmark = pytest.mark.cuda
PLANTS = [(pendulum_step, 2, 1), (unicycle_step, 3, 2), (planar_quadrotor_step, 6, 2),
          (cartpole_step, 4, 1)]
HORIZON = {pendulum_step: 30, unicycle_step: 30, planar_quadrotor_step: 10, cartpole_step: 5}
# the planar quadrotor hovers (m g / 2 per rotor); with zero thrust it falls
U_NOM = {planar_quadrotor_step: 0.5 * 9.81}
# the long-horizon regime (T past HORIZON): the cartpole hangs (pole down),
# every plant starts within 0.05 of its nominal state, Q = 1e-4 and P0 =
# 0.01, so that measuring only the first component keeps every covariance
# of order one over 67 steps
X_NOM = {cartpole_step: (0.0, np.pi, 0.0, 0.0)}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


# K9's and K10's shapes past their narrow forms (csrc/kalman_wide.cu): the
# edges of the narrow buckets, chip_smoke.py phase 30's formation and shapes
# past a block's 32-trajectory tile
WIDE_KF = [(17, 1), (16, 9), (33, 17), (48, 24), (64, 8), (130, 67), (300, 40)]
WIDE_RTS = [17, 48, 130, 300]


def _wide(n, p=1):
    return n > kalman_mean.MAX_N or p > kalman_mean.MAX_P


def _lti(n, p, device, seed, N=1003, T=37):
    """A stable random system (spectral radius about 0.95) and random data;
    past the narrow forms C and B are N(0, 1) / sqrt(n), so that the
    innovations stay of order one at any width."""
    rng = np.random.default_rng(seed)
    A = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)
    C = rng.standard_normal((p, n))
    B = rng.standard_normal((n, 2))
    if _wide(n, p):
        C, B = C / np.sqrt(n), B / np.sqrt(n)
    mats = [_f32(M, device) for M in (A, C, 0.01 * np.eye(n), 0.1 * np.eye(p), 0.5 * np.eye(n))]
    data = [_f32(rng.standard_normal(s), device) for s in ((N, n), (N, T, p), (N, T, 2))]
    return mats, _f32(B, device), data


@pytest.mark.parametrize("n,p", [(2, 1), (3, 2), (4, 4), (12, 6), (16, 8)] + WIDE_KF)
@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
def test_kalman_mean_kernel_matches_plain(device, n, p, inputs):
    (A, C, Q, R, P0), B, (x0s, yss, uss) = _lti(n, p, device, seed=n * 10 + p)
    kw = dict(B=B, uss=uss) if inputs else {}
    before = kalman_mean.kalman_mean_pass.launches
    got = kalman_filter_batched(A, C, Q, R, x0s, P0, yss, method="pallas", **kw)
    torch.cuda.synchronize()
    assert kalman_mean.kalman_mean_pass.launches == before + 1
    want = kalman_filter_batched(A, C, Q, R, x0s, P0, yss, method="xla", **kw)
    assert torch.allclose(got.means, want.means, rtol=0, atol=2e-5)
    assert torch.allclose(got.pred_means, want.pred_means, rtol=0, atol=2e-5)
    assert torch.allclose(got.log_likelihood, want.log_likelihood, rtol=2e-4, atol=2e-3)


# K10's horizons: T - 1 steps inside one 16-step chunk, on its edges and
# across several (chunks of 16, 8 and 4 steps for n <= 4, <= 8 and <= 16)
RTS_T = [2, 17, 18, 33, 37, 50, 130]


@pytest.mark.parametrize("n", [2, 3, 4, 8, 12, 16] + WIDE_RTS)
@pytest.mark.parametrize("T", RTS_T)
def test_rts_mean_kernel_matches_plain(device, n, T):
    (A, C, Q, R, P0), _, (x0s, yss, _) = _lti(n, 1, device, seed=n, T=T)
    filt = kalman_filter_batched(A, C, Q, R, x0s, P0, yss)
    before = rts_mean.rts_mean_pass.launches
    got = kalman_smoother_batched(A, filt, method="pallas")
    torch.cuda.synchronize()
    assert rts_mean.rts_mean_pass.launches == before + 1
    want = kalman_smoother_batched(A, filt, method="xla")
    assert torch.allclose(got.means, want.means, rtol=0, atol=2e-5)


def _rts_operands(n, N, T, device, seed):
    """K10's operands: gains G_t' of spectral radius about 0.5, e_t and
    x_last of order one."""
    rng = np.random.default_rng(seed)
    G = 0.5 * rng.standard_normal((T - 1, n, n)) / np.sqrt(n)
    return [_f32(a, device) for a in (G, rng.standard_normal((T - 1, N, n)),
                                      rng.standard_normal((N, n)))]


@pytest.mark.parametrize("T", [2, 17, 18, 33, 50, 130])
@pytest.mark.parametrize("N", [1, 31, 33, 4096])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16] + WIDE_RTS)
def test_rts_mean_kernel_every_bucket_batch_and_horizon(device, n, N, T):
    """K10 at every bucket, at batches that leave a warp's lanes past N (1,
    31, 33) or fill 128 warps (4096), at the chunk edges: one launch, every
    row against the plain version."""
    G, es, x_last = _rts_operands(n, N, T, device, seed=100 * n + T)
    before = rts_mean.rts_mean_pass.launches
    got = rts_mean.rts_mean_pass(G, es, x_last)
    torch.cuda.synchronize()
    assert rts_mean.rts_mean_pass.launches == before + 1
    want = rts_mean.rts_mean_pass_reference(G, es, x_last)
    assert got.shape == (T, N, n)
    assert torch.allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("which", ["es_t", "x_last", "both"])
@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 48])
def test_rts_mean_kernel_takes_misaligned_views(device, n, which):
    """K10 with e_t and x_last as views 4 bytes into a larger buffer (n = 2
    then takes its 4-byte rows, not its 8-byte ones)."""
    G, es, x_last = _rts_operands(n, 1003, 37, device, seed=7 + n)
    want = rts_mean.rts_mean_pass_reference(G, es, x_last)
    if which in ("es_t", "both"):
        es = _misaligned(es)
    if which in ("x_last", "both"):
        x_last = _misaligned(x_last)
    before = rts_mean.rts_mean_pass.launches
    got = rts_mean.rts_mean_pass(G, es, x_last)
    torch.cuda.synchronize()
    assert rts_mean.rts_mean_pass.launches == before + 1
    assert torch.allclose(got, want, rtol=0, atol=2e-5)


def _nonlinear(f, n, m, p, device, B=257, T=None, seed=2):
    """(Q, R, x0s, P0, yss, uss): the first p components of the plant's own
    rollout from 0.3 N(0, 1) under small controls, measured with noise 0.05;
    the filters start 0.1 N(0, 1) off. Past HORIZON[f] steps, the
    long-horizon regime (X_NOM)."""
    rng = np.random.default_rng(seed)
    T = HORIZON[f] if T is None else T
    long = T > HORIZON[f]
    x_nom = np.asarray(X_NOM.get(f, np.zeros(n))) if long else np.zeros(n)
    x0 = _f32((0.05 if long else 0.3) * rng.standard_normal((B, n)) + x_nom, device)
    us = _f32(0.1 * rng.standard_normal((B, T, m)) + U_NOM.get(f, 0.0), device)
    xs = rollout_nonlinear(f, x0, us)
    ys = xs[:, 1:, :p] + _f32(0.05 * rng.standard_normal((B, T, p)), device)
    q, p0 = (1e-4, 0.01) if long else (1e-3, 0.1)
    return (_f32(np.eye(n) * q, device), _f32(np.eye(p) * 1e-2, device),
            x0 + _f32(0.1 * rng.standard_normal((B, n)), device), _f32(np.eye(n) * p0, device),
            ys, us)


@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
@pytest.mark.parametrize("which", ["ekf", "ukf"])
def test_whole_filter_kernels_match_plain_on_every_plant_and_width(device, f, n, m, which):
    port, ref = ((ekf.ekf_batched, ekf.ekf_reference) if which == "ekf"
                 else (ukf.ukf_batched, ukf.ukf_reference))
    for p in range(1, n + 1):
        h = functools.partial(first_components, k=p)
        args = _nonlinear(f, n, m, p, device, seed=p)
        before = port.launches
        got = port(f, h, *args)
        torch.cuda.synchronize()
        assert port.launches == before + 1
        want = ref(f, h, *args)
        for k, atol in enumerate((1e-4, 1e-5, 1e-4, 1e-5)):
            assert torch.allclose(got[k], want[k], rtol=0, atol=atol), (p, k)
        assert torch.allclose(got[4], want[4], rtol=1e-3, atol=5e-3), p


def _misaligned(t):
    """The same values in a contiguous view 4 bytes into a larger buffer:
    .contiguous() passes it uncopied, its base off every 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _assert_whole_filter_matches_plain(got, want, what):
    for k, atol in enumerate((1e-4, 1e-5, 1e-4, 1e-5)):
        assert torch.allclose(got[k], want[k], rtol=0, atol=atol), (what, k)
    assert torch.allclose(got[4], want[4], rtol=1e-3, atol=5e-3), what


@pytest.mark.parametrize("T", [1, 2, 50, 67])
@pytest.mark.parametrize("B", [1, 3, 1003, 1024])
@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
def test_ukf_kernel_every_plant_width_batch_and_horizon(device, f, n, m, B, T):
    """K12 on every registered plant and measurement width, at batches that
    leave a block's groups (32 / G trajectories, G = 8 or 16 lanes) empty or
    ragged, and at horizons inside one staged chunk of 16 steps and across
    three and four (the last one partial), every output against the plain
    version."""
    for p in range(1, n + 1):
        h = functools.partial(first_components, k=p)
        args = _nonlinear(f, n, m, p, device, B=B, T=T, seed=10 + p)
        before = ukf.ukf_batched.launches
        got = ukf.ukf_batched(f, h, *args)
        torch.cuda.synchronize()
        assert ukf.ukf_batched.launches == before + 1
        _assert_whole_filter_matches_plain(got, ukf.ukf_reference(f, h, *args), p)


@pytest.mark.parametrize("which", ["x0s", "yss", "uss", "all"])
@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
def test_ukf_kernel_takes_misaligned_views(device, f, n, m, which):
    """K12 stages each trajectory's inputs as aligned 16-byte spans: operands
    4 bytes off a 16-byte boundary are read at their offsets."""
    p = min(n, 2)
    h = functools.partial(first_components, k=p)
    args = list(_nonlinear(f, n, m, p, device, B=1003, T=37, seed=20))
    want = ukf.ukf_reference(f, h, *args)
    for i, name in ((2, "x0s"), (4, "yss"), (5, "uss")):
        if which in (name, "all"):
            args[i] = _misaligned(args[i])
    got = ukf.ukf_batched(f, h, *args)
    torch.cuda.synchronize()
    _assert_whole_filter_matches_plain(got, want, which)


@pytest.mark.parametrize("T", [1, 2, 50, 67])
@pytest.mark.parametrize("B", [1, 3, 1003, 1024])
@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
def test_ekf_kernel_every_plant_width_batch_and_horizon(device, f, n, m, B, T):
    """K11 on every registered plant and measurement width, at batches that
    leave a block's groups (32 / G trajectories, G = 4 or 8 lanes) empty or
    ragged, and at horizons inside one staged chunk of 16 steps and across
    three and four (the last one partial), every output against the plain
    version."""
    for p in range(1, n + 1):
        h = functools.partial(first_components, k=p)
        args = _nonlinear(f, n, m, p, device, B=B, T=T, seed=30 + p)
        before = ekf.ekf_batched.launches
        got = ekf.ekf_batched(f, h, *args)
        torch.cuda.synchronize()
        assert ekf.ekf_batched.launches == before + 1
        _assert_whole_filter_matches_plain(got, ekf.ekf_reference(f, h, *args), p)


@pytest.mark.parametrize("which", ["x0s", "yss", "uss", "all"])
@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
def test_ekf_kernel_takes_misaligned_views(device, f, n, m, which):
    """K11 stages each trajectory's inputs as aligned 16-byte spans: operands
    4 bytes off a 16-byte boundary are read at their offsets."""
    p = min(n, 2)
    h = functools.partial(first_components, k=p)
    args = list(_nonlinear(f, n, m, p, device, B=1003, T=37, seed=40))
    want = ekf.ekf_reference(f, h, *args)
    for i, name in ((2, "x0s"), (4, "yss"), (5, "uss")):
        if which in (name, "all"):
            args[i] = _misaligned(args[i])
    got = ekf.ekf_batched(f, h, *args)
    torch.cuda.synchronize()
    _assert_whole_filter_matches_plain(got, want, which)


def _mean_pass_operands(n, p, N, T, inputs, device, seed):
    """kalman_mean_pass's operands: the gains of a stable random system over
    T steps (shared_gains) and time-major data, with u_t = B u the inputs."""
    from numpower_tpu_torch.models.estimation import shared_gains

    (A, C, Q, R, P0), B, (x0s, yss, uss) = _lti(n, p, device, seed, N=N, T=T)
    Ws, _, _, invLs, logdets = shared_gains(A, C, Q, R, P0, T)
    us_t = (uss @ B.T).transpose(0, 1).contiguous() if inputs else None
    return [A, C, Ws, invLs, logdets, x0s, yss.transpose(0, 1).contiguous(), us_t]


def _assert_mean_pass_matches_plain(got, want, what):
    for k in range(2):
        assert torch.allclose(got[k], want[k], rtol=0, atol=2e-5), (what, k)
    assert torch.allclose(got[2], want[2], rtol=2e-4, atol=2e-3), what


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
@pytest.mark.parametrize("n,p", [(2, 1), (4, 4), (16, 8), (48, 24)])
@pytest.mark.parametrize("T", [1, 2, 50, 130])
@pytest.mark.parametrize("N", [1, 63, 1003, 4096])
def test_kalman_mean_kernel_every_batch_horizon_and_bucket(device, N, T, n, p, inputs):
    """K9 at batches that leave a block of 32 trajectories ragged (1, 63,
    1003) or fill it (4096), at horizons inside one staged chunk and across
    several (130 crosses any chunk of 4, 8 or 16 steps), in the smallest and
    largest buckets and a full one, without and with inputs, against the
    plain version."""
    args = _mean_pass_operands(n, p, N, T, inputs, device, seed=N + T + n)
    before = kalman_mean.kalman_mean_pass.launches
    got = kalman_mean.kalman_mean_pass(*args)
    torch.cuda.synchronize()
    assert kalman_mean.kalman_mean_pass.launches == before + 1
    _assert_mean_pass_matches_plain(got, kalman_mean.kalman_mean_pass_reference(*args),
                                    (N, T, n, p))


@pytest.mark.parametrize("which", ["ys_t", "us_t", "x0s", "all"])
@pytest.mark.parametrize("n,p", [(2, 1), (3, 2), (16, 8), (33, 17)])
def test_kalman_mean_kernel_takes_misaligned_views(device, n, p, which):
    """K9 stages each step's rows of a block as the aligned 16-byte span that
    holds them: operands 4 bytes off a 16-byte boundary are read at their
    offsets."""
    args = _mean_pass_operands(n, p, 1003, 37, True, device, seed=7)
    want = kalman_mean.kalman_mean_pass_reference(*args)
    for i, name in ((6, "ys_t"), (7, "us_t"), (5, "x0s")):
        if which in (name, "all"):
            args[i] = _misaligned(args[i])
    got = kalman_mean.kalman_mean_pass(*args)
    torch.cuda.synchronize()
    _assert_mean_pass_matches_plain(got, want, which)


def _held(got, plain, f64, atol):
    """Within atol of the plain version and of float64, or, where the plain
    fp32 version itself sits past atol from float64, within four times its
    distance of each (chip_smoke.held_against)."""
    floor = max(atol, 4 * (plain.double() - f64).abs().max().item())
    return ((got.double() - plain.double()).abs().max().item() <= floor
            and (got.double() - f64).abs().max().item() <= floor)


@pytest.mark.parametrize("n,p,N,T,form", [(48, 24, 1003, 13, 0), (130, 67, 257, 5, 0),
                                          (300, 40, 256, 8, 1), (4000, 3, 9, 3, 2)])
def test_kalman_mean_wide_forms_match_plain_and_float64(device, n, p, N, T, form):
    """The wide K9 in each of its forms (0: the matrices and the tile in
    shared memory; 1: the matrices read through L1; 2: the tile in a device
    workspace), with inputs, one launch, against its plain version and
    float64 (K9's bounds, or four times the plain fp32 version's own
    distance from float64)."""
    args = _mean_pass_operands(n, p, N, T, True, device, seed=n + p)
    assert kalman_mean.wide_plan(device.index, n, p, True)[0] == form
    before = kalman_mean.kalman_mean_pass.launches
    got = kalman_mean.kalman_mean_pass(*args)
    torch.cuda.synchronize()
    assert kalman_mean.kalman_mean_pass.launches == before + 1
    plain = kalman_mean.kalman_mean_pass_reference(*args)
    f64 = kalman_mean.kalman_mean_pass_reference(*(a.double() for a in args))
    for k in range(2):
        assert _held(got[k], plain[k], f64[k], 2e-5), k
    assert torch.allclose(got[2], plain[2], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n,N,T,form", [(130, 1003, 50, 0), (300, 256, 50, 1), (4000, 9, 3, 2)])
def test_rts_mean_wide_forms_match_plain_and_float64(device, n, N, T, form):
    G, es, x_last = _rts_operands(n, N, T, device, seed=n)
    assert rts_mean.wide_plan(device.index, n)[0] == form
    before = rts_mean.rts_mean_pass.launches
    got = rts_mean.rts_mean_pass(G, es, x_last)
    torch.cuda.synchronize()
    assert rts_mean.rts_mean_pass.launches == before + 1
    plain = rts_mean.rts_mean_pass_reference(G, es, x_last)
    assert _held(got, plain, rts_mean.rts_mean_pass_reference(G.double(), es.double(),
                                                             x_last.double()), 2e-5)


def _assert_held_k9(got, args, what):
    """chip_smoke phase 30's check of a wide K9 call: xs_f and xs_p within
    2e-5, ll within rtol 2e-4 / atol 2e-3, of the plain version and of
    float64, or within four times the plain fp32 version's own distance
    (chip_smoke.held_against)."""
    plain = kalman_mean.kalman_mean_pass_reference(*args)
    f64 = kalman_mean.kalman_mean_pass_reference(*(None if x is None else x.double()
                                                   for x in args))
    for k, (rtol, atol) in enumerate(((0.0, 2e-5), (0.0, 2e-5), (2e-4, 2e-3))):
        held, e_kp, e_k, e_p = held_against(got[k], plain[k], f64[k], rtol, atol)
        assert held, (what, k, e_kp, e_k, e_p)


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
@pytest.mark.parametrize("N", [4096, 1003])
def test_kalman_mean_wide_tensor_core_form_at_the_formation(device, N, inputs):
    """The wide K9's form 0, its products in rounded 3xTF32 on the tensor
    cores, at the four-quadrotor formation (chip_smoke phase 30: n = 48,
    p = 24, T = 50; N = 4096 and a ragged 1003), one launch, against its
    plain version and float64."""
    q = {k: torch.as_tensor(v, device=device)
         for k, v in quad_estimation(N_FORMATION, N, 50).items()}
    ops = kalman_mean_operands(q["A"], q["C"], q["Q"], q["R"], q["P0"], q["x0s"], q["yss"],
                               q["B"], q["uss"])
    args = ops if inputs else ops[:7] + [None]
    assert kalman_mean.wide_plan(device.index, 48, 24, inputs) == (0, 16)
    before = kalman_mean.kalman_mean_pass.launches
    got = kalman_mean.kalman_mean_pass(*args)
    torch.cuda.synchronize()
    assert kalman_mean.kalman_mean_pass.launches == before + 1
    _assert_held_k9(got, args, (N, inputs))


@pytest.mark.parametrize("inputs", [False, True], ids=["no_inputs", "inputs"])
@pytest.mark.parametrize("n,p", KALMAN_WIDE_EDGES)
def test_kalman_mean_wide_tensor_core_form_at_the_edges(device, n, p, inputs):
    """The wide K9's form 0 at chip_smoke.KALMAN_WIDE_EDGES (N = 4096, T =
    13: random stable systems, chip_smoke.random_estimation), one launch,
    against its plain version and float64."""
    d = random_estimation(n, p, 4096, T_KF_EDGE, seed=n + p, dev=device)
    ops = kalman_mean_operands(d["A"], d["C"], d["Q"], d["R"], d["P0"], d["x0s"], d["yss"],
                               d["B"], d["uss"])
    args = ops if inputs else ops[:7] + [None]
    assert kalman_mean.wide_plan(device.index, n, p, inputs)[0] == 0
    got = kalman_mean.kalman_mean_pass(*args)
    torch.cuda.synchronize()
    _assert_held_k9(got, args, (n, p, inputs))


@pytest.fixture(scope="module")
def wide_digests(device):
    return kalman_wide_checksums(device)


@pytest.mark.parametrize("case", sorted(K9_WIDE_DIGESTS))
def test_wide_kernels_keep_their_bits(wide_digests, case):
    """The wide K9's forms 1 and 2 and the wide K10 give the SHA-256 digests
    of the kernels before K9's form 0 moved to the tensor cores
    (chip_smoke.K9_WIDE_DIGESTS), and a second call the same bits."""
    digest, call = wide_digests[case]
    assert digest == K9_WIDE_DIGESTS[case]
    import hashlib

    h = hashlib.sha256()
    for x in call():
        h.update(x.contiguous().cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == digest


@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
def test_dual_number_jacobians_match_jacfwd(device, f, n, m):
    """K11's first prediction covariance is A P0 A' + Q with A the kernel's
    dual-number Jacobian at x0: against torch.func.jacfwd's A, for a generic
    SPD P0 (fp32 rounding of the products, rtol 1e-5)."""
    Q, R, x0s, _, yss, uss = _nonlinear(f, n, m, 1, device, T=1)
    M = np.random.default_rng(n).standard_normal((n, n))
    P0 = _f32(M @ M.T + n * np.eye(n), device)
    _, _, xs_p, Ps_p, _ = ekf.ekf_batched(f, first_components, Q, R, x0s, P0, yss, uss)
    A = _jac_x(f, x0s, uss[:, 0])
    want = A @ P0 @ A.transpose(1, 2) + Q
    assert torch.allclose(Ps_p[:, 0], want, rtol=1e-5, atol=1e-6)
    # the value part is the float plant, operation for operation
    assert torch.allclose(xs_p[:, 0], f(x0s, uss[:, 0]), rtol=0, atol=1e-6)


def test_batched_filters_launch_each_kernel_once(device):
    (A, C, Q, R, P0), _, (x0s, yss, uss) = _lti(2, 1, device, seed=1, N=300, T=20)
    counters = (kalman_mean.kalman_mean_pass, rts_mean.rts_mean_pass, ekf.ekf_batched,
                ukf.ukf_batched)
    before = [c.launches for c in counters]
    filt = kalman_filter_batched(A, C, Q, R, x0s, P0, yss)
    kalman_filter_sqrt_batched(A, C, Q, R, x0s, P0, yss)
    kalman_smoother_batched(A, filt)
    nl = (Q, R[:1, :1], x0s, P0, yss, uss[..., :1])
    ekf_filter_batched(pendulum_step, first_components, *nl)
    ukf_filter_batched(pendulum_step, first_components, *nl)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 1, 1, 1]
    # an unregistered plant or measurement: "auto" takes the kernel and raises
    # naming the registry; "xla" runs the plain filter on the card
    mine = lambda x, u: pendulum_step(x, u)  # noqa: E731
    for entry in (ekf_filter_batched, ukf_filter_batched):
        with pytest.raises(ValueError, match="kernel_plant"):
            entry(mine, first_components, *nl)
        with pytest.raises(ValueError, match="kernel_measurement"):
            entry(pendulum_step, lambda x: x[..., :1], *nl)
        r = entry(mine, first_components, *nl, method="xla")
        assert r.means.device.type == "cuda"
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 1, 1, 1]


def test_float64_takes_the_plain_route_by_default(device):
    """The kernels take float32. On float64 tensors, and on float64 numpy
    inputs (which the entry points put on the card), "auto" takes the plain
    route: no launch, and the float32 kernels' results within the JAX
    package's float64 bounds (test_kalman_filter_matches_fp64: means rtol
    1e-3 / atol 1e-4, log-likelihood rtol 1e-3) with the nonlinear kernels'
    log-likelihood atol 5e-3."""
    (A, C, Q, R, P0), _, (x0s, yss, uss) = _lti(2, 1, device, seed=3, N=300, T=20)
    counters = (kalman_mean.kalman_mean_pass, rts_mean.rts_mean_pass, ekf.ekf_batched,
                ukf.ukf_batched)
    kf, nl = (A, C, Q, R, x0s, P0, yss), (Q, R[:1, :1], x0s, P0, yss, uss[..., :1])
    want = (kalman_filter_batched(*kf), kalman_filter_sqrt_batched(*kf),
            ekf_filter_batched(pendulum_step, first_components, *nl),
            ukf_filter_batched(pendulum_step, first_components, *nl))
    want_sm = kalman_smoother_batched(A, want[0])
    before = [c.launches for c in counters]
    kf64 = [t.double() for t in kf]
    kf_np = [t.cpu().double().numpy() for t in kf]
    nl64 = [t.double() for t in nl]
    got = (kalman_filter_batched(*kf64), kalman_filter_sqrt_batched(*kf64),
           ekf_filter_batched(pendulum_step, first_components, *nl64),
           ukf_filter_batched(pendulum_step, first_components, *nl64))
    got_np = kalman_filter_batched(*kf_np)
    got_sm = kalman_smoother_batched(A.double(), got[0])
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert got_np.means.device.type == "cuda" and got_np.means.dtype == torch.float64
    for g, w in zip(got + (got_np,), want + (want[0],)):
        assert g.means.dtype == torch.float64
        assert torch.allclose(g.means, w.means.double(), rtol=1e-3, atol=1e-4)
        assert torch.allclose(g.log_likelihood, w.log_likelihood.double(), rtol=1e-3, atol=5e-3)
    assert torch.allclose(got_sm.means, want_sm.means.double(), rtol=1e-3, atol=1e-4)


def test_output_feedback_loop_on_the_card(device):
    """The Kalman-estimator MPC loop with the controller on its default
    device (the card): one K2 launch per tick, controls in the box."""
    from numpower_tpu_torch.kernels import boxqp_fista

    A, B = double_integrator(0.1)
    C = np.array([[1.0, 0.0]], np.float32)
    ctrl = MPCController(A, B, np.eye(2, dtype=np.float32), 0.1 * np.eye(1, dtype=np.float32),
                         10 * np.eye(2, dtype=np.float32), horizon=15, u_lo=-1.0, u_hi=1.0)
    assert ctrl.qp.H.device.type == "cuda"
    x0s = _f32(np.random.default_rng(0).uniform(-2, 2, (64, 2)), device)
    make, update = kalman_estimator(A, C, np.eye(2) * 1e-4, np.eye(1) * 1e-2, np.eye(2) * 0.5,
                                    B=B)
    A_t, B_t = _f32(A, device), _f32(B, device)
    before = boxqp_fista.fista_mpc_res.launches
    res = simulate_closed_loop(lambda x, u: x @ A_t.T + u @ B_t.T, ctrl.callback(),
                               ctrl.callback_init(64), x0s, 40, w_std=0.01, h=first_components,
                               v_std=0.05, estimator=update, est_state0=make(x0s))
    assert boxqp_fista.fista_mpc_res.launches == before + 40
    assert float(res.us.abs().max()) <= 1.0 + 1e-6 and bool(torch.isfinite(res.xhats).all())
