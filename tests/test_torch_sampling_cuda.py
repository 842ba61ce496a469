"""The sampling CUDA kernels of numpower_tpu_torch (K13 mppi_fused, K14
resample_systematic) against their plain PyTorch versions, on the card; the
launches and routes of the sampling entry points; numpy inputs landing on the
card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest:

    python -m pytest --noconftest tests/test_torch_sampling_cuda.py -q

K13 is checked at K = 1-1024 samples on each plant, on rounds that stay
resident in shared memory and rounds staged twice, with the box and a warm
start, and on operands 4 bytes off a 16-byte boundary.

Tolerances: K13 on the same perturbations, at most two rounds, us atol 2e-3
and ess rtol 1e-3 (MPPI is chaotic in its rounding over more rounds, ROADMAP
queue 3: a near tie between two samples' costs moves the weights); K14 is
exact, element for element.
"""

import functools

import numpy as np
import pytest
import torch

from numpower_tpu_torch.kernels import mppi as mppi_kernel
from numpower_tpu_torch.kernels import pf_resample
from numpower_tpu_torch.models import (
    al_ilqr_solve, al_ilqr_solve_batched, cartpole_step, condense, double_integrator,
    first_components, ilqr_solve, ilqr_solve_batched, mhe_solve, mppi_solve, mppi_solve_batched,
    mppi_step, particle_filter, particle_filter_batched, pendulum_step, planar_quadrotor_step,
    quadratic_mppi_cost, rollout_nonlinear, solve_mpc_state_constrained, solve_qp_osqp,
    tube_mpc_solve, unicycle_step,
)
from numpower_tpu_torch.models.particle import _resample_slots

pytestmark = pytest.mark.cuda
# plant: (n, m, cost weights Q, R, QF, goal, nominal control)
PLANTS = {
    "pendulum": (pendulum_step, 2, 1, np.diag([1.0, 0.1]), 0.01, np.diag([100.0, 10.0]),
                 np.zeros(2), 0.0),
    "unicycle": (unicycle_step, 3, 2, np.diag([1.0, 1.0, 0.0]), 0.01, np.diag([50.0, 50.0, 0.0]),
                 np.array([1.0, 1.0, 0.0]), 0.0),
    "cartpole": (cartpole_step, 4, 1, np.eye(4), 0.01, np.eye(4) * 10.0, np.zeros(4), 0.0),
    "planar_quadrotor": (planar_quadrotor_step, 6, 2, np.eye(6), 0.01, np.eye(6) * 10.0,
                         np.zeros(6), 0.5 * 9.81),
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cost(name):
    _, n, m, Q, r, QF, goal, _ = PLANTS[name]
    return quadratic_mppi_cost(Q, np.eye(m) * r, QF, goal)


def _k13_case(name, N, K, T, iters, device, seed, sigma=1.0, warm=False):
    f, n, m, *_, u_nom = PLANTS[name]
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(0.5 * rng.standard_normal((N, n)), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = mppi_kernel.eps_kernel_layout(gen, N, iters, T, m, K, sigma)
    us0 = torch.full((T * m,), u_nom, device=device)
    if warm:
        us0 = us0 + torch.as_tensor(0.2 * rng.standard_normal(T * m), dtype=torch.float32,
                                    device=device)
    return f, m, x0s, eps, us0


@pytest.mark.parametrize("name", list(PLANTS))
@pytest.mark.parametrize("N,K,T", [(37, 256, 20), (5, 100, 12), (3, 1024, 8), (64, 1, 5)])
def test_mppi_kernel_matches_plain(device, name, N, K, T):
    iters = 2
    f, m, x0s, eps, us0 = _k13_case(name, N, K, T, iters, device, seed=N + K + T)
    cost = _cost(name)
    kw = dict(T=T, iters=iters, m=m, lam=1.0, sigma=1.0)
    before = mppi_kernel.mppi_fused.launches
    us, ess = mppi_kernel.mppi_fused(f, cost, x0s, eps, us0, **kw)
    torch.cuda.synchronize()
    assert mppi_kernel.mppi_fused.launches == before + 1
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, cost.rows, x0s, eps, us0, **kw)
    assert us.shape == (N, T, m) and ess.shape == (N, iters)
    assert torch.allclose(us, us_p, rtol=0, atol=2e-3), (us - us_p).abs().max().item()
    assert torch.allclose(ess, ess_p, rtol=1e-3, atol=0), (ess / ess_p - 1).abs().max().item()
    assert bool(((ess >= 1.0 - 1e-4) & (ess <= K * (1 + 1e-4))).all())


@pytest.mark.parametrize("name,T", [("unicycle", 512), ("pendulum", 1024)])
def test_mppi_kernel_at_its_envelope(device, name, T):
    """K = 1024 samples and T m = 1024 nominal entries, the most K13 takes
    (its shared memory then holds 32 warps' partials of every entry). Over
    so long a horizon the costs reach 1e3-1e4, where a last-bit difference of
    the plant's sinf/cosf moves a weight exp(-S / lam) visibly; a high
    temperature (lam = 1e3) keeps the comparison about the kernel's
    arithmetic, not about that sensitivity."""
    f, m, x0s, eps, us0 = _k13_case(name, 2, 1024, T, 2, device, seed=T)
    assert T * m == mppi_kernel.MAX_TM
    kw = dict(T=T, iters=2, m=m, lam=1e3, sigma=1.0)
    us, ess = mppi_kernel.mppi_fused(f, _cost(name), x0s, eps, us0, **kw)
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost(name).rows, x0s, eps, us0, **kw)
    assert torch.allclose(us, us_p, rtol=0, atol=2e-3), (us - us_p).abs().max().item()
    assert torch.allclose(ess, ess_p, rtol=1e-3, atol=0)


@pytest.mark.parametrize("opts", [
    dict(u_lo=-2.0, u_hi=2.0, sigma=0.7, lam=0.5),
    dict(warm=True, lam=2.0),
    dict(sigma=(1.0, 0.5), u_lo=-1.5, u_hi=1.5),
], ids=["box_sigma_lam", "warm_start", "sigma_tuple"])
def test_mppi_kernel_options_match_plain(device, opts):
    opts = dict(opts)
    name = "unicycle" if isinstance(opts.get("sigma"), tuple) else "pendulum"
    sigma = opts.pop("sigma", 1.0)
    f, m, x0s, eps, us0 = _k13_case(name, 29, 192, 16, 2, device, seed=3, sigma=sigma,
                                    warm=opts.pop("warm", False))
    kw = dict(T=16, iters=2, m=m, sigma=sigma, lam=opts.pop("lam", 1.0), **opts)
    us, ess = mppi_kernel.mppi_fused(f, _cost(name), x0s, eps, us0, **kw)
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost(name).rows, x0s, eps, us0, **kw)
    assert torch.allclose(us, us_p, rtol=0, atol=2e-3)
    assert torch.allclose(ess, ess_p, rtol=1e-3, atol=0)
    if "u_lo" in kw:
        assert float(us.abs().max()) <= kw["u_hi"] + 1e-6


def _assert_k13(us, ess, us_p, ess_p, K):
    assert torch.allclose(us, us_p, rtol=0, atol=2e-3), (us - us_p).abs().max().item()
    assert torch.allclose(ess, ess_p, rtol=1e-3, atol=0), (ess / ess_p - 1).abs().max().item()
    assert bool(((ess >= 1.0 - 1e-4) & (ess <= K * (1 + 1e-4))).all())


# K from 1 to 1024: a sample a thread up to 256, two up to 512, four past it,
# and counts that leave a warp or a thread's last sample partly empty
@pytest.mark.parametrize("name", list(PLANTS))
@pytest.mark.parametrize("K", [1, 31, 33, 255, 256, 257, 1024])
def test_mppi_kernel_sample_counts(device, name, K):
    T, iters = 12, 2
    f, m, x0s, eps, us0 = _k13_case(name, 5, K, T, iters, device, seed=7 * K + T)
    kw = dict(T=T, iters=iters, m=m, lam=1.0, sigma=1.0)
    us, ess = mppi_kernel.mppi_fused(f, _cost(name), x0s, eps, us0, **kw)
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost(name).rows, x0s, eps, us0, **kw)
    _assert_k13(us, ess, us_p, ess_p, K)


# (plant, K, T, lam): rounds whose slice stays resident in shared memory
# (with a partial last chunk; 40 chunks of one sample's unaligned rows,
# staged a float a lane) and rounds the update stages again
# (kernels/mppi.py chunk_plan; with a partial last chunk; T m = 1024). Past
# T = 500 the costs reach 1e3-1e4, where a last-bit difference of the
# plant's sinf/cosf moves a weight visibly (test_mppi_kernel_at_its_envelope):
# a high temperature keeps those comparisons about the kernel's arithmetic.
ROUNDS = {"resident_bench": ("pendulum", 256, 40, 1.0, True),
          "resident_partial_chunk": ("planar_quadrotor", 128, 30, 1.0, True),
          "resident_40_chunks": ("pendulum", 1, 320, 1.0, True),
          "streamed_tm_1024": ("unicycle", 4, 512, 1e3, False),
          "streamed_k1024": ("unicycle", 1024, 16, 1.0, False),
          "streamed_partial_chunk": ("cartpole", 300, 60, 1.0, False)}


@pytest.mark.parametrize("case", list(ROUNDS))
@pytest.mark.parametrize("opts", ["cold", "box", "warm"])
def test_mppi_kernel_resident_and_streamed_rounds(device, case, opts):
    name, K, T, lam, resident = ROUNDS[case]
    f, m, x0s, eps, us0 = _k13_case(name, 7, K, T, 2, device, seed=K + T, warm=opts == "warm")
    assert mppi_kernel.chunk_plan(K, T, m)[4] == resident
    box = dict(u_lo=-1.5, u_hi=1.5) if opts == "box" else {}
    kw = dict(T=T, iters=2, m=m, lam=lam, sigma=1.0, **box)
    us, ess = mppi_kernel.mppi_fused(f, _cost(name), x0s, eps, us0, **kw)
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost(name).rows, x0s, eps, us0, **kw)
    _assert_k13(us, ess, us_p, ess_p, K)
    if box:
        assert float(us.abs().max()) <= 1.5 + 1e-6


@pytest.mark.parametrize("which", ["x0s", "eps", "us0", "all", "us0_broadcast"])
@pytest.mark.parametrize("K", [256, 33])
def test_mppi_kernel_takes_misaligned_views(device, which, K):
    """Operands 4 bytes off a 16-byte boundary (eps's rows then start
    anywhere in a 16-byte block, and are staged as their aligned spans), and
    a broadcast warm start, which the wrapper copies."""
    T, iters = 20, 2
    f, m, x0s, eps, us0 = _k13_case("unicycle", 9, K, T, iters, device, seed=K,
                                    sigma=(1.0, 0.5), warm=True)
    x0_in = _misaligned(x0s) if which in ("x0s", "all") else x0s
    eps_in = _misaligned(eps) if which in ("eps", "all") else eps
    us0_in = _misaligned(us0) if which in ("us0", "all") else us0
    if which == "us0_broadcast":
        us0 = us0[:1].expand(T * m)
        us0_in = us0
    kw = dict(T=T, iters=iters, m=m, lam=1.0, sigma=(1.0, 0.5))
    before = mppi_kernel.mppi_fused.launches
    us, ess = mppi_kernel.mppi_fused(f, _cost("unicycle"), x0_in, eps_in, us0_in, **kw)
    torch.cuda.synchronize()
    assert mppi_kernel.mppi_fused.launches == before + 1
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost("unicycle").rows, x0s, eps, us0, **kw)
    _assert_k13(us, ess, us_p, ess_p, K)


@pytest.mark.parametrize("eps_stream", ["exact", "direct"])
def test_mppi_solve_batched_launches_once(device, eps_stream):
    cost = _cost("pendulum")
    x0s = torch.as_tensor(np.random.default_rng(8).uniform(-np.pi, np.pi, (64, 2)),
                          dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    before = mppi_kernel.mppi_fused.launches
    res = mppi_solve_batched(pendulum_step, x0s, cost, 20, gen.manual_seed(1), samples=256,
                             iters=4, m=1, eps_stream=eps_stream)
    torch.cuda.synchronize()
    assert mppi_kernel.mppi_fused.launches == before + 1
    assert res.us.shape == (64, 20, 1) and res.xs.shape == (64, 21, 2) and res.ess.shape == (64,)
    assert bool(torch.isfinite(res.cost).all())
    if eps_stream == "exact":  # the plain route on the very same draw
        ref = mppi_solve_batched(pendulum_step, x0s, cost, 20, gen.manual_seed(1), method="xla",
                                 samples=256, iters=4, m=1)
        rel = (res.cost - ref.cost).abs() / ref.cost.abs().clamp(min=1e-6)
        assert float(rel.median()) <= 5e-2


def test_mppi_routes(device):
    cost = _cost("pendulum")
    x0s = torch.zeros((4, 2), device=device)
    kw = dict(samples=64, iters=1, m=1)
    before = mppi_kernel.mppi_fused.launches
    with pytest.raises(ValueError, match="registered"):
        mppi_solve_batched(lambda x, u: pendulum_step(x, u), x0s, cost, 5, **kw)
    # a cost without the kernel form and float64 take the plain route
    plain_cost = quadratic_mppi_cost(np.eye(2), np.eye(1), np.eye(2), np.zeros(2))
    del plain_cost.kernel
    r1 = mppi_solve_batched(pendulum_step, x0s, plain_cost, 5, **kw)
    r2 = mppi_solve_batched(pendulum_step, x0s.double(), cost, 5, **kw)
    r3 = mppi_solve_batched(pendulum_step, x0s, cost, 5, baseline_mix=0.25, **kw)
    assert mppi_kernel.mppi_fused.launches == before
    assert r1.us.device.type == "cuda" and r2.us.dtype == torch.float64
    assert r3.us.shape == (4, 5, 1)
    mppi_solve_batched(pendulum_step, x0s, cost, 5, **kw)
    assert mppi_kernel.mppi_fused.launches == before + 1


def _resample_case(B, N, n, device, seed, weights="spread"):
    """The cloud and its slot boundaries. weights: "spread" (log-weights
    2 N(0, 1)), "spike" (one particle of row 0 takes nearly all the weight),
    "one_owner" (one particle of every row owns every slot) or "half_zero"
    (every other run of particles has zero weight, long runs own no slot)."""
    rng = np.random.default_rng(seed)
    parts = torch.as_tensor(rng.standard_normal((B, N, n)), dtype=torch.float32, device=device)
    logw = torch.as_tensor(2.0 * rng.standard_normal((B, N)), dtype=torch.float32, device=device)
    if weights == "spike":
        logw[0, N // 3] = 40.0
    elif weights == "one_owner":
        logw.fill_(-float("inf"))
        logw[:, (2 * N) // 3] = 0.0
    elif weights == "half_zero":
        runs = (torch.arange(N, device=device) // max(1, N // 16)) % 2 == 1
        logw[:, runs] = -float("inf")
    u0 = torch.as_tensor(rng.uniform(size=B), dtype=torch.float32, device=device)
    return parts, _resample_slots(u0, logw, N)


def _assert_resampled(parts, m, out):
    B, N, n = parts.shape
    assert torch.equal(out, pf_resample.resample_systematic_reference(parts, m))
    counts = torch.diff(m, dim=1, prepend=torch.zeros_like(m[:, :1]))
    lib = parts.reshape(B * N, n).repeat_interleave(counts.reshape(-1).long(), dim=0,
                                                    output_size=B * N)
    assert torch.equal(out.reshape(B * N, n), lib)


# n = 1-6 (scalar, 8-byte and 16-byte accesses), B = 1, ragged N, and N past
# the kernel's shared-memory staging (12,288 boundaries)
@pytest.mark.parametrize("B,N,n", [(1, 1, 1), (3, 7, 2), (256, 1024, 2), (5, 1023, 6),
                                   (2, 4099, 3), (2, 12289, 1), (3, 1000, 1), (3, 1001, 3),
                                   (4, 1024, 4), (3, 999, 5), (1, 1024, 2), (1, 12289, 4),
                                   (2, 12288, 2)])
@pytest.mark.parametrize("weights", ["spread", "spike", "one_owner", "half_zero"])
def test_resample_kernel_matches_plain(device, B, N, n, weights):
    parts, m = _resample_case(B, N, n, device, seed=B + N + n, weights=weights)
    before = pf_resample.resample_systematic.launches
    out = pf_resample.resample_systematic(parts, m)
    torch.cuda.synchronize()
    assert pf_resample.resample_systematic.launches == before + 1
    _assert_resampled(parts, m, out)


def _misaligned(t):
    """The same values in a contiguous view 4 bytes into a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("which", ["parts", "m", "both"])
@pytest.mark.parametrize("B,N,n", [(5, 1024, 2), (3, 1023, 4), (2, 12288, 2)])
def test_resample_kernel_takes_misaligned_views(device, which, B, N, n):
    parts, m = _resample_case(B, N, n, device, seed=7 * N + n)
    parts_in = _misaligned(parts) if which in ("parts", "both") else parts
    m_in = _misaligned(m) if which in ("m", "both") else m
    out = pf_resample.resample_systematic(parts_in, m_in)
    torch.cuda.synchronize()
    _assert_resampled(parts, m, out)


def test_resample_kernel_rejects_bad_operands(device):
    parts, m = _resample_case(2, 8, 2, device, seed=0)
    with pytest.raises(ValueError, match="int32"):
        pf_resample.resample_systematic(parts, m.long())
    with pytest.raises(ValueError):
        pf_resample.resample_systematic(parts.double(), m)


def test_particle_filter_batched_launches_once_per_step(device):
    B, T, N = 16, 12, 256
    rng = np.random.default_rng(2)
    x0s = torch.as_tensor(0.3 * rng.standard_normal((B, 2)), dtype=torch.float32, device=device)
    yss = torch.as_tensor(rng.standard_normal((B, T, 1)), dtype=torch.float32, device=device)
    uss = torch.zeros((B, T, 1), device=device)
    args = (pendulum_step, first_components, np.eye(2) * 1e-4, np.eye(1) * 2.5e-3, x0s, np.eye(2),
            yss, uss)
    gen = torch.Generator(device=device)
    before = pf_resample.resample_systematic.launches
    auto = particle_filter_batched(*args, gen.manual_seed(3), n_particles=N)
    torch.cuda.synchronize()
    assert pf_resample.resample_systematic.launches == before + T
    gather = particle_filter_batched(*args, gen.manual_seed(3), n_particles=N,
                                     resample_method="gather")
    assert pf_resample.resample_systematic.launches == before + T
    for field in ("means", "log_likelihood", "ess"):
        assert torch.allclose(getattr(auto, field), getattr(gather, field), rtol=0, atol=1e-6)


def _card(res):
    first = res[0] if isinstance(res, tuple) else res
    while isinstance(first, tuple):
        first = first[0]
    return first.device.type == "cuda"


A_DI, B_DI = (np.asarray(M) for M in double_integrator(0.1))
NUMPY_CALLS = {
    "mppi_solve": lambda: mppi_solve(pendulum_step, np.zeros(2, np.float32), _cost("pendulum"),
                                     5, samples=8, iters=1, m=1),
    "mppi_solve_batched": lambda: mppi_solve_batched(pendulum_step, np.zeros((2, 2), np.float32),
                                                     _cost("pendulum"), 5, samples=8, iters=1,
                                                     m=1),
    "mppi_step": lambda: mppi_step(pendulum_step, np.zeros((5, 1), np.float32),
                                   np.zeros(2, np.float32), _cost("pendulum"), samples=8,
                                   iters=1)[1],
    "particle_filter": lambda: particle_filter(
        pendulum_step, first_components, np.eye(2) * 1e-3, np.eye(1) * 1e-2,
        np.zeros(2, np.float32), np.eye(2), np.zeros((4, 1)), np.zeros((4, 1)), n_particles=16),
    "particle_filter_batched": lambda: particle_filter_batched(
        pendulum_step, first_components, np.eye(2) * 1e-3, np.eye(1) * 1e-2,
        np.zeros((2, 2), np.float32), np.eye(2), np.zeros((2, 4, 1)), np.zeros((2, 4, 1)),
        n_particles=16),
    "mhe_solve": lambda: mhe_solve(A_DI, np.array([[1.0, 0.0]]), np.eye(2) * 1e-3,
                                   np.eye(1) * 1e-2, np.eye(2) * 0.1, np.zeros(2),
                                   np.zeros((4, 1))),
    "solve_qp_osqp": lambda: solve_qp_osqp(np.eye(2), np.ones(2), np.eye(2), -1.0, 1.0, iters=3),
    "solve_mpc_state_constrained": lambda: solve_mpc_state_constrained(
        condense(A_DI, B_DI, np.eye(2), np.eye(1), np.eye(2), 5), np.zeros((2, 2)), -1.0, 1.0,
        -2.0, 2.0, iters=3),
    "ilqr_solve": lambda: ilqr_solve(cartpole_step, np.zeros(4, np.float32), np.eye(4),
                                     np.eye(1), np.eye(4), np.zeros(4), 4, iters=1),
    "ilqr_solve_batched_vmap": lambda: ilqr_solve_batched(
        cartpole_step, np.zeros((2, 4)), np.eye(4), np.eye(1), np.eye(4), np.zeros(4), 4,
        iters=1),
    "ilqr_solve_batched_fused": lambda: ilqr_solve_batched(
        cartpole_step, np.zeros((2, 4)), np.eye(4), np.eye(1), np.eye(4), np.zeros(4), 4,
        backend="fused", iters=1),
    "al_ilqr_solve": lambda: al_ilqr_solve(pendulum_step, np.zeros(2), np.eye(2), np.eye(1),
                                           np.eye(2), np.zeros(2), 4, -1.0, 1.0, al_iters=1,
                                           ilqr_iters=1),
    "al_ilqr_solve_batched_fused": lambda: al_ilqr_solve_batched(
        pendulum_step, np.zeros((2, 2)), np.eye(2), np.eye(1), np.eye(2), np.zeros(2), 4, -1.0,
        1.0, backend="fused", al_iters=1, ilqr_iters=1),
    "rollout_nonlinear": lambda: rollout_nonlinear(functools.partial(pendulum_step, dt=0.05),
                                                   np.zeros(2), np.zeros((3, 1))),
    "tube_mpc_solve": lambda: tube_mpc_solve(
        condense(A_DI, B_DI, np.eye(2), np.eye(1), np.eye(2), 5), A_DI, B_DI, np.eye(2),
        np.eye(1), np.zeros(2), np.zeros((3, 5, 2)), -1.0, 1.0).xs_scenarios,
}


@pytest.mark.parametrize("call", list(NUMPY_CALLS.values()), ids=list(NUMPY_CALLS))
def test_numpy_inputs_land_on_the_card(device, call):
    assert _card(call())


def test_particle_filter_is_reproducible_past_one_scan_tile(device):
    """One trajectory of 65,536 particles twice from one seed: the same
    filter, bit for bit (a single row's torch.cumsum on the card took CUB's
    single-pass scan, whose sums vary with its timing, and moved resampling
    slots from run to run; models/particle._cumsum_rows)."""
    rng = np.random.default_rng(12)
    args = (pendulum_step, first_components, np.eye(2) * 1e-4, np.eye(1) * 2.5e-3,
            torch.as_tensor(0.3 * rng.standard_normal(2), dtype=torch.float32, device=device),
            np.eye(2), rng.standard_normal((20, 1)), np.zeros((20, 1)))
    runs = [particle_filter(*args, torch.Generator(device=device).manual_seed(0),
                            n_particles=65536) for _ in range(3)]
    for other in runs[1:]:
        for field in ("means", "log_likelihood", "ess", "particles"):
            assert torch.equal(getattr(other, field), getattr(runs[0], field)), field
