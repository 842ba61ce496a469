"""The wide K13 of numpower_tpu_torch (csrc/mppi_wide.cu: K > 1024 samples or
T*m > 1024 nominal entries) against its plain PyTorch version, on the card;
the launches of mppi_solve_batched at 4096 samples; the launch that fails;
and the narrow K13's bits, which the wide form leaves as they were.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest, from the repository root (it imports
chip_smoke's digests of the narrow kernel):

    python -m pytest --noconftest tests/test_torch_mppi_wide_cuda.py -q

Tolerances: on the same perturbations, at most two rounds, us atol 2e-3 and
ess rtol 1e-3, the narrow kernel's (tests/test_torch_sampling_cuda.py); two
launches of the wide kernel on the same operands are equal bit for bit; the
narrow kernel's SHA-256 digests (chip_smoke.k13_checksums) equal those it
gave before the wide form was added (chip_smoke.K13_NARROW_DIGESTS).
"""

import numpy as np
import pytest
import torch

from chip_smoke import K13_NARROW_DIGESTS, k13_checksums
from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels import mppi as mppi_kernel
from numpower_tpu_torch.models import (
    mppi_solve_batched, pendulum_step, planar_quadrotor_step, quadratic_mppi_cost, unicycle_step,
)

pytestmark = pytest.mark.cuda
# plant: (n, m, cost weights Q, R, QF, goal, nominal control), the narrow tests'
PLANTS = {
    "pendulum": (pendulum_step, 2, 1, np.diag([1.0, 0.1]), 0.01, np.diag([100.0, 10.0]),
                 np.zeros(2), 0.0),
    "unicycle": (unicycle_step, 3, 2, np.diag([1.0, 1.0, 0.0]), 0.01, np.diag([50.0, 50.0, 0.0]),
                 np.array([1.0, 1.0, 0.0]), 0.0),
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


def _case(name, N, K, T, device, seed, sigma=1.0, warm=False, iters=2):
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


def _wide(name, K, T):
    assert not mppi_kernel.is_narrow(K, T, PLANTS[name][2])


def _run(name, f, x0s, eps, us0, kw):
    before = mppi_kernel.mppi_fused.launches
    us, ess = mppi_kernel.mppi_fused(f, _cost(name), x0s, eps, us0, **kw)
    torch.cuda.synchronize()
    assert mppi_kernel.mppi_fused.launches == before + 1
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost(name).rows, x0s, eps, us0, **kw)
    K = eps.shape[2]
    assert us.shape == us_p.shape and ess.shape == ess_p.shape
    assert torch.allclose(us, us_p, rtol=0, atol=2e-3), (us - us_p).abs().max().item()
    assert torch.allclose(ess, ess_p, rtol=1e-3, atol=0), (ess / ess_p - 1).abs().max().item()
    assert bool(((ess >= 1.0 - 1e-4) & (ess <= K * (1 + 1e-4))).all())
    return us, ess


@pytest.mark.parametrize("opts", [
    dict(),
    dict(u_lo=-2.0, u_hi=2.0, sigma=0.7, lam=0.5),
    dict(warm=True, lam=2.0),
    dict(sigma=(1.0, 0.5), u_lo=-1.5, u_hi=1.5),
], ids=["cold", "box_sigma_lam", "warm_start", "sigma_tuple"])
@pytest.mark.parametrize("K", [1152, 2048, 4096, 16384])
def test_wide_kernel_matches_plain(device, K, opts):
    """The options of test_mppi_kernel_options_match_plain past K = 1024."""
    opts = dict(opts)
    name = "unicycle" if isinstance(opts.get("sigma"), tuple) else "pendulum"
    sigma = opts.pop("sigma", 1.0)
    T = 16
    _wide(name, K, T)
    f, m, x0s, eps, us0 = _case(name, 13, K, T, device, seed=K + 3, sigma=sigma,
                                warm=opts.pop("warm", False))
    us, _ = _run(name, f, x0s, eps, us0, dict(T=T, iters=2, m=m, sigma=sigma,
                                              lam=opts.pop("lam", 1.0), **opts))
    if "u_lo" in opts:
        assert float(us.abs().max()) <= opts["u_hi"] + 1e-6


# (plant, N, K, T, lam): the slice's shapes at two rounds, T*m past 1024
# (with a high temperature over a long horizon, as
# tests/test_torch_sampling_cuda.py test_mppi_kernel_at_its_envelope), a last
# tile mostly empty, K a multiple of no tile, one and two samples a thread at
# T*m past 1024, and K past 16384, where the first form kept its row of S in
# an (N, K) scratch ("scratch_*")
SHAPES = {"pendulum_4096": ("pendulum", 64, 4096, 40, 1.0),
          "quadrotor_2048": ("planar_quadrotor", 32, 2048, 50, 1.0),
          "unicycle_tm_1280": ("unicycle", 8, 1152, 640, 1e3),
          "pendulum_ragged_tile": ("pendulum", 5, 1025, 12, 1.0),
          "pendulum_4100_ragged": ("pendulum", 6, 4100, 16, 1.0),
          "unicycle_k128_tm_1280": ("unicycle", 4, 128, 640, 1e3),
          "pendulum_k384_tm_1100": ("pendulum", 3, 384, 1100, 1e3),
          "scratch_16512": ("pendulum", 4, 16512, 12, 1.0),
          "scratch_quadrotor": ("planar_quadrotor", 3, 20000, 8, 1.0)}


@pytest.mark.parametrize("opts", ["cold", "box", "warm"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_wide_kernel_shapes(device, case, opts):
    name, N, K, T, lam = SHAPES[case]
    _wide(name, K, T)
    f, m, x0s, eps, us0 = _case(name, N, K, T, device, seed=K + T, warm=opts == "warm")
    box = dict(u_lo=-1.5, u_hi=1.5) if opts == "box" else {}
    if name == "planar_quadrotor" and box:
        box = dict(u_lo=3.0, u_hi=7.0)  # about the hover thrust
    _run(name, f, x0s, eps, us0, dict(T=T, iters=2, m=m, lam=lam, sigma=1.0, **box))


def _misaligned(t):
    """The same values in a contiguous view 4 bytes into a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("which", ["x0s", "eps", "us0", "all", "us0_broadcast"])
@pytest.mark.parametrize("K", [1152, 4096])
def test_wide_kernel_takes_misaligned_views(device, which, K):
    """Operands 4 bytes off a 16-byte boundary and a broadcast warm start
    (which the wrapper copies)."""
    T = 20
    f, m, x0s, eps, us0 = _case("unicycle", 9, K, T, device, seed=K, sigma=(1.0, 0.5), warm=True)
    x0_in = _misaligned(x0s) if which in ("x0s", "all") else x0s
    eps_in = _misaligned(eps) if which in ("eps", "all") else eps
    us0_in = _misaligned(us0) if which in ("us0", "all") else us0
    if which == "us0_broadcast":
        us0 = us0[:1].expand(T * m)
        us0_in = us0
    kw = dict(T=T, iters=2, m=m, lam=1.0, sigma=(1.0, 0.5))
    us, ess = mppi_kernel.mppi_fused(f, _cost("unicycle"), x0_in, eps_in, us0_in, **kw)
    us_p, ess_p = mppi_kernel.mppi_fused_reference(f, _cost("unicycle").rows, x0s, eps, us0, **kw)
    assert torch.allclose(us, us_p, rtol=0, atol=2e-3)
    assert torch.allclose(ess, ess_p, rtol=1e-3, atol=0)


@pytest.mark.parametrize("K", [4096, 4100, 16512])
def test_wide_kernel_is_deterministic(device, K):
    """The wide kernel's reductions run in a fixed order: two launches on the
    same operands give the same bits (whole tiles, a ragged last tile, 17
    tiles)."""
    f, m, x0s, eps, us0 = _case("pendulum", 7, K, 24, device, seed=K, iters=3)
    kw = dict(T=24, iters=3, m=m, lam=1.0, sigma=1.0)
    a = mppi_kernel.mppi_fused(f, _cost("pendulum"), x0s, eps, us0, **kw)
    b = mppi_kernel.mppi_fused(f, _cost("pendulum"), x0s, eps, us0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _first_round_costs(name, x0s, eps, us0, T, lam):
    """S of every sample in the first round, on the plain version's
    arithmetic (the rollout of u_nom + eps through the plant, the stage and
    terminal costs, the coupling): (N, K)."""
    f, m = PLANTS[name][0], PLANTS[name][2]
    rows, inv_sig2 = _cost(name).rows, 1.0  # sigma = 1
    x = x0s[:, None, :].expand(x0s.shape[0], eps.shape[2], x0s.shape[1])
    S = torch.zeros(eps.shape[1:], device=x0s.device)
    for t in range(T):
        u = [us0[t * m + a] + eps[t * m + a] for a in range(m)]
        S = S + rows(list(x.unbind(-1)), u, t)
        S = S + lam * sum((u[a] - us0[t * m + a]) * (inv_sig2 * us0[t * m + a])
                          for a in range(m))
        x = f(x, torch.stack(u, dim=-1))
    return S + rows(list(x.unbind(-1)), None, T)


@pytest.mark.parametrize("lam", [1e-2, 1.0])
@pytest.mark.parametrize("K", [2048, 4100])
def test_wide_kernel_running_minimum_best_last(device, K, lam):
    """The samples ordered by their first round's cost, the worst first, so
    that every tile lowers the running minimum and the last tile holds the
    best sample: at lam = 1e-2 the rescale of the earlier tiles' sums falls
    to 0, as the plain version's weights of those samples do."""
    T = 12
    f, m, x0s, eps, us0 = _case("pendulum", 5, K, T, device, seed=K + 7, warm=True)
    S = _first_round_costs("pendulum", x0s, eps[:T * m], us0, T, lam)
    order = torch.argsort(S, dim=1, descending=True)  # per scenario
    eps = torch.gather(eps, 2, order[None].expand_as(eps)).contiguous()
    S = torch.gather(S, 1, order)
    assert bool((S[:, -1] <= S[:, 0]).all())
    _run("pendulum", f, x0s, eps, us0, dict(T=T, iters=2, m=m, lam=lam, sigma=1.0))


@pytest.mark.parametrize("eps_stream", ["exact", "direct"])
def test_mppi_solve_batched_launches_once_at_4096_samples(device, eps_stream):
    """"auto" at 4096 samples takes the wide K13, one launch a call; on the
    exact stream its final costs stay within 5e-2 (median, relative) of the
    plain route's from the same generator, below zero control's."""
    cost = _cost("pendulum")
    x0s = torch.as_tensor(np.random.default_rng(8).uniform(-np.pi, np.pi, (64, 2)),
                          dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    kw = dict(samples=4096, iters=4, m=1)
    before = mppi_kernel.mppi_fused.launches
    res = mppi_solve_batched(pendulum_step, x0s, cost, 40, gen.manual_seed(1),
                             eps_stream=eps_stream, **kw)
    torch.cuda.synchronize()
    assert mppi_kernel.mppi_fused.launches == before + 1
    assert res.us.shape == (64, 40, 1) and res.ess.shape == (64,)
    assert bool(torch.isfinite(res.cost).all())
    ref = mppi_solve_batched(pendulum_step, x0s, cost, 40, gen.manual_seed(1), method="xla", **kw)
    assert mppi_kernel.mppi_fused.launches == before + 1
    zero = mppi_solve_batched(pendulum_step, x0s, cost, 40, gen.manual_seed(1), method="xla",
                              samples=128, iters=0, m=1)
    assert float(res.cost.median()) < float(zero.cost.median())
    if eps_stream == "exact":
        rel = (res.cost - ref.cost).abs() / (1.0 + ref.cost.abs())
        assert float(rel.median()) <= 5e-2


def test_a_refused_launch_raises(device, monkeypatch):
    """A plan the C side refuses (512 threads) raises RuntimeError from the
    wrapper and counts no launch; nothing falls back to the plain version."""
    f, m, x0s, eps, us0 = _case("pendulum", 3, 2048, 8, device, seed=1)
    kw = dict(T=8, iters=2, m=m, lam=1.0, sigma=1.0)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mppi_kernel, "mppi_fused_reference", plain)
    mppi_kernel.mppi_fused(f, _cost("pendulum"), x0s, eps, us0, **kw)  # the kernel, no fallback
    monkeypatch.setattr(mppi_kernel, "wide_plan", lambda K: (512, 4, 1))
    before = mppi_kernel.mppi_fused.launches
    with pytest.raises(RuntimeError, match="mppi_fused kernel launch: CUDA error"):
        mppi_kernel.mppi_fused(f, _cost("pendulum"), x0s, eps, us0, **kw)
    assert mppi_kernel.mppi_fused.launches == before
    # three samples a thread, which no instance carries: refused by the C side
    monkeypatch.undo()
    args, held = mppi_kernel.kernel_args(f, _cost("pendulum"), x0s, eps, us0, **kw)
    args = list(args)
    args[-1] = 3  # spt
    assert _build.launch("npt_mppi_wide", device, *args) != 0
    del held


def test_narrow_kernel_keeps_its_bits(device):
    """Every narrow launch (K <= 1024, T*m <= 1024) gives the bits it gave
    before the wide form existed: the bench's shape and the envelope."""
    got = {case: digest for case, (digest, _) in k13_checksums(device).items()}
    assert got == K13_NARROW_DIGESTS
