"""The Riccati and small-matrix CUDA kernels of numpower_tpu_torch (K5
riccati_batched_fused, K6a cholesky_batched, K6b psd_solve_batched) against
their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest:

    python -m pytest --noconftest tests/test_torch_riccati_cuda.py -q

K5 is checked in every (NB, MB) bucket at N = 1003 and N = 1, at T = 0
with an asymmetric QF, and on operands 4 bytes off a 16-byte boundary.
K6a is checked at every n = 1..16 and N in {1, 31, 33, 1003, 4096}, and on
misaligned and strided views, with exact zeros above the diagonal.

Tolerances: K5 against its plain version rtol 1e-3, atol 1e-4 on Ks and 1e-3
on P0, the JAX package's bound for its fused kernel
(tests/test_kernels.py:133-136); K6b rtol 2e-3, atol 2e-4 and a residual
|AX - B| <= 2e-3 (tests/test_kernels.py:77-82); K6a 1e-4. The kernels use
rsqrtf (<= 2 ulp) where the plain versions use torch.rsqrt; both orders of
summation are fp32 FMA chains. N = 1003 is ragged for the 8-scenario
blocks of K5, K6a's tiles (128 / 2^ceil(log2 n) matrices) and K6b's
32-matrix blocks (16 past n = 8); K6b also takes N = 1, 31 and 33, every r at n = 4, and operands at
a 4-byte offset from a 16-byte boundary, which it stages as aligned spans.
"""

import numpy as np
import pytest
import torch

from numpower_tpu_torch.kernels import cholesky, riccati
from numpower_tpu_torch.models import quadrotor12, riccati_scan_per_scenario
from numpower_tpu_torch.utils.smallmat import cholesky_unrolled, psd_solve_unrolled

pytestmark = pytest.mark.cuda
T = 30


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _costs(n, m):
    return (np.eye(n, dtype=np.float32), np.eye(m, dtype=np.float32) * 0.1,
            np.eye(n, dtype=np.float32) * 5.0)


def _plant_batch(N, n, m, device, seed=4, per_scenario_b=False, stable=False):
    """The bench recipe (bench.py:345-355) for the quadrotor; a random
    contraction-ish plant for other (n, m); with `stable`, a random plant
    whose A has its eigenvalues well inside the unit circle (0.8 I + a
    3% perturbation), for any (n, m)."""
    rng = np.random.default_rng(seed)
    if stable:
        A = (0.8 * np.eye(n) + 0.03 * rng.standard_normal((n, n))).astype(np.float32)
        B = (0.1 * rng.standard_normal((n, m))).astype(np.float32)
    elif (n, m) == (12, 4):
        A, B = quadrotor12(0.02)
    else:
        A = (np.eye(n) + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
        B = (0.1 * rng.standard_normal((n, m))).astype(np.float32)
    As = torch.as_tensor(np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, n, n)),
                         dtype=torch.float32, device=device)
    if per_scenario_b:
        Bs = torch.as_tensor(np.tile(B, (N, 1, 1)) + 0.01 * rng.standard_normal((N, n, m)),
                             dtype=torch.float32, device=device)
    else:
        Bs = torch.as_tensor(B, device=device).expand(N, n, m)  # a broadcast view
    return As, Bs


def _spd(N, n, device, seed, junk_upper=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, n, n)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    if junk_upper:  # the kernels read the lower triangle only
        spd = spd + np.triu(rng.standard_normal((N, n, n)).astype(np.float32), 1)
    return torch.as_tensor(spd, device=device)


@pytest.mark.parametrize("N", [4096, 1003])
@pytest.mark.parametrize("per_scenario_b", [False, True], ids=["Bs_broadcast", "Bs_each"])
def test_riccati_kernel_matches_plain(device, N, per_scenario_b):
    As, Bs = _plant_batch(N, 12, 4, device, per_scenario_b=per_scenario_b)
    launches = riccati.riccati_batched_fused.launches
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, *_costs(12, 4), T)
    torch.cuda.synchronize()
    assert riccati.riccati_batched_fused.launches == launches + 1
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *_costs(12, 4), T)
    assert Ks.shape == (N, T, 4, 12) and P0.shape == (N, 12, 12)
    torch.testing.assert_close(Ks, Ks_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(P0, P0_ref, rtol=1e-3, atol=1e-3)
    assert torch.equal(P0, P0.transpose(1, 2))  # formed from the upper triangle, mirrored


@pytest.mark.parametrize("n,m", [(2, 1), (3, 2), (4, 1), (6, 2), (16, 8)])
def test_riccati_kernel_envelope_shapes(device, n, m):
    As, Bs = _plant_batch(257, n, m, device, seed=n, per_scenario_b=True)
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, *_costs(n, m), 20)
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *_costs(n, m), 20)
    torch.testing.assert_close(Ks, Ks_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(P0, P0_ref, rtol=1e-3, atol=1e-3)


# every (NB, MB) bucket of the kernel (n up to 4, 8, 12, 16; m up to 1, 2,
# 4, 8), n and m at and below their bucket's bound, at a ragged N and N = 1.
# The plants are stable: on the unstable random ones of _plant_batch, P
# grows to 1e4 within 20 steps, and there the plain version itself misses
# its float64 run by 2-9x these tolerances (n = 12, 16).
@pytest.mark.parametrize("n", [4, 7, 12, 16])
@pytest.mark.parametrize("m", [1, 2, 3, 8])
@pytest.mark.parametrize("N", [1003, 1])
def test_riccati_kernel_every_bucket(device, n, m, N):
    As, Bs = _plant_batch(N, n, m, device, seed=10 * n + m, per_scenario_b=True, stable=True)
    launches = riccati.riccati_batched_fused.launches
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, *_costs(n, m), 20)
    torch.cuda.synchronize()
    assert riccati.riccati_batched_fused.launches == launches + 1
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *_costs(n, m), 20)
    torch.testing.assert_close(Ks, Ks_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(P0, P0_ref, rtol=1e-3, atol=1e-3)
    assert torch.equal(P0, P0.transpose(1, 2))


@pytest.mark.parametrize("N", [1, 65, 1003])
def test_riccati_kernel_returns_qf_at_t0(device, N):
    """With no stage P0 is QF itself, an asymmetric one as given (the kernel
    stages QF transposed for its first step and writes P0 by columns), and
    Ks is empty."""
    As, Bs = _plant_batch(N, 6, 2, device, seed=6, per_scenario_b=True)
    Q, R, QF = _costs(6, 2)
    QF = QF + np.triu(np.random.default_rng(1).standard_normal((6, 6)), 1).astype(np.float32)
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, Q, R, QF, 0)
    torch.cuda.synchronize()
    assert Ks.shape == (N, 0, 2, 6)
    assert torch.equal(P0, torch.as_tensor(QF, device=device).expand(N, 6, 6))


@pytest.mark.parametrize("which", ["As", "Bs", "costs", "all"])
def test_riccati_kernel_takes_misaligned_views(device, which):
    """As, Bs and the costs 4 bytes off a 16-byte boundary (contiguous, so
    passed uncopied), and Bs broadcast where it is not misaligned."""
    As, Bs = _plant_batch(1003, 12, 4, device)
    costs = tuple(torch.as_tensor(c, device=device) for c in _costs(12, 4))
    As_in = _misaligned(As) if which in ("As", "all") else As
    Bs_in = _misaligned(Bs.contiguous()) if which in ("Bs", "all") else Bs
    costs_in = tuple(_misaligned(c) for c in costs) if which in ("costs", "all") else costs
    Ks, P0 = riccati.riccati_batched_fused(As_in, Bs_in, *costs_in, T)
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *costs, T)
    torch.testing.assert_close(Ks, Ks_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(P0, P0_ref, rtol=1e-3, atol=1e-3)


def test_riccati_routes_and_launch_counts(device):
    As, Bs = _plant_batch(256, 12, 4, device)
    fused, psd = riccati.riccati_batched_fused, cholesky.psd_solve_batched
    before = (fused.launches, psd.launches)
    Ks_auto, _ = riccati_scan_per_scenario(As, Bs, *_costs(12, 4), T)
    assert (fused.launches, psd.launches) == (before[0] + 1, before[1])
    Ks_psd, _ = riccati_scan_per_scenario(As, Bs, *_costs(12, 4), T, method="psd")
    assert (fused.launches, psd.launches) == (before[0] + 1, before[1] + T)
    Ks_plain, _ = riccati_scan_per_scenario(As, Bs, *_costs(12, 4), T, method="plain")
    assert (fused.launches, psd.launches) == (before[0] + 1, before[1] + T)
    torch.testing.assert_close(Ks_auto, Ks_plain, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(Ks_psd, Ks_plain, rtol=1e-3, atol=1e-4)


def test_riccati_envelope_raises(device):
    """Past n = 48 or m = 48 (the wide form's edge; the narrow form's, n = 16
    and m = 8, now hands over to it: tests/test_torch_riccati_wide_cuda.py)."""
    As, Bs = _plant_batch(8, 49, 4, device)
    with pytest.raises(ValueError, match="envelope"):
        riccati.riccati_batched_fused(As, Bs, *_costs(49, 4), 5)
    with pytest.raises(ValueError, match="envelope"):
        riccati_scan_per_scenario(As, Bs, *_costs(49, 4), 5, method="fused")
    As, Bs = _plant_batch(8, 12, 49, device)
    with pytest.raises(ValueError, match="envelope"):
        riccati_scan_per_scenario(As, Bs, *_costs(12, 49), 5, method="fused")
    As, Bs = _plant_batch(8, 49, 4, device)
    with pytest.raises(ValueError, match="envelope"):
        riccati_scan_per_scenario(As, Bs, *_costs(49, 4), 5, method="psd")
    with pytest.raises(ValueError, match="float32"):
        riccati.riccati_batched_fused(As[:, :12, :12].double(), Bs[:, :12].double(),
                                      *_costs(12, 4), 5)
    launches = riccati.riccati_batched_fused.launches
    Ks, _ = riccati_scan_per_scenario(As, Bs, *_costs(49, 4), 5)  # auto past the envelope
    assert riccati.riccati_batched_fused.launches == launches and Ks.shape == (8, 5, 4, 49)


# every r at n = 4 (the Riccati inner solve's n); n = 1, 5, 12, 16; N = 1, 31,
# 33 and 1003 against the kernel's tiles of 32 (n <= 8) or 16 matrices
PSD_SHAPES = ([(4096, 4, 12), (4096, 12, 4), (1003, 12, 4), (1003, 16, 16), (64, 1, 3)]
              + [(1003, 4, r) for r in range(1, 17)]
              + [(257, 1, 16), (1003, 5, 7), (33, 12, 12), (31, 16, 1), (1, 4, 12), (1, 16, 5),
                 (31, 4, 12), (33, 4, 12), (33, 16, 16)])


@pytest.mark.parametrize("N,n,r", PSD_SHAPES)
def test_psd_solve_kernel_matches_plain(device, N, n, r):
    a = _spd(N, n, device, seed=n, junk_upper=True)
    b = torch.as_tensor(np.random.default_rng(r).standard_normal((N, n, r)),
                        dtype=torch.float32, device=device)
    launches = cholesky.psd_solve_batched.launches
    X = cholesky.psd_solve_batched(a, b)
    torch.cuda.synchronize()
    assert cholesky.psd_solve_batched.launches == launches + 1
    _assert_solves(a, b, X)


def _assert_solves(a, b, X):
    torch.testing.assert_close(X, psd_solve_unrolled(a, b), rtol=2e-3, atol=2e-4)
    sym = torch.tril(a) + torch.tril(a, -1).transpose(1, 2)
    assert (sym @ X - b).abs().max().item() <= 2e-3


def _misaligned(t):
    """The same values in a contiguous view 4 bytes into a larger buffer:
    .contiguous() passes it uncopied, its base off every 8- and 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("which", ["a", "b", "both"])
@pytest.mark.parametrize("N,n,r", [(1003, 4, 12), (257, 5, 3), (65, 12, 4)])
def test_psd_solve_kernel_takes_misaligned_views(device, which, N, n, r):
    a = _spd(N, n, device, seed=n + 40, junk_upper=True)
    b = torch.as_tensor(np.random.default_rng(r + 40).standard_normal((N, n, r)),
                        dtype=torch.float32, device=device)
    a_in = _misaligned(a) if which in ("a", "both") else a
    b_in = _misaligned(b) if which in ("b", "both") else b
    launches = cholesky.psd_solve_batched.launches
    X = cholesky.psd_solve_batched(a_in, b_in)
    torch.cuda.synchronize()
    assert cholesky.psd_solve_batched.launches == launches + 1
    _assert_solves(a, b, X)


@pytest.mark.parametrize("N,n", [(4096, 12), (1003, 16), (1003, 5), (64, 1)])
def test_cholesky_kernel_matches_plain_and_torch(device, N, n):
    a = _spd(N, n, device, seed=100 + n, junk_upper=True)
    launches = cholesky.cholesky_batched.launches
    L = cholesky.cholesky_batched(a)
    torch.cuda.synchronize()
    assert cholesky.cholesky_batched.launches == launches + 1
    torch.testing.assert_close(L, cholesky_unrolled(a), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(L, torch.linalg.cholesky(torch.tril(a) + torch.tril(a, -1).mT),
                               rtol=1e-4, atol=1e-4)
    assert torch.count_nonzero(torch.triu(L, 1)).item() == 0


@pytest.mark.parametrize("N", [1, 31, 33, 1003, 4096])
@pytest.mark.parametrize("n", list(range(1, 17)))
def test_cholesky_kernel_every_dim_and_batch(device, N, n):
    """K6a at every n of its envelope (each a template instance, with its own
    group of lanes: 1, 2, 4, 8 or 16) and at batches below, across and past
    a block's tile (128 / the group's lanes matrices)."""
    a = _spd(N, n, device, seed=200 + n, junk_upper=True)
    launches = cholesky.cholesky_batched.launches
    L = cholesky.cholesky_batched(a)
    torch.cuda.synchronize()
    assert cholesky.cholesky_batched.launches == launches + 1
    torch.testing.assert_close(L, cholesky_unrolled(a), rtol=1e-4, atol=1e-4)
    assert torch.count_nonzero(torch.triu(L, 1)).item() == 0


@pytest.mark.parametrize("view", ["misaligned", "strided"])
@pytest.mark.parametrize("N,n", [(1003, 12), (33, 5), (4096, 3), (31, 16)])
def test_cholesky_kernel_takes_misaligned_and_strided_views(device, view, N, n):
    """K6a stages its tile as an aligned 16-byte span: a base 4 bytes off a
    16-byte boundary is read at its offset; a strided view is copied by the
    wrapper."""
    a = _spd(N, n, device, seed=300 + n, junk_upper=True)
    a_in = _misaligned(a) if view == "misaligned" else \
        torch.tril(a).mT.contiguous().mT  # the lower triangle, column-major
    assert view == "misaligned" or not a_in.is_contiguous()
    L = cholesky.cholesky_batched(a_in)
    torch.cuda.synchronize()
    torch.testing.assert_close(L, cholesky_unrolled(a), rtol=1e-4, atol=1e-4)
    assert torch.count_nonzero(torch.triu(L, 1)).item() == 0


def test_kernels_take_strided_and_broadcast_inputs(device):
    a = _spd(1003, 12, device, seed=7)
    b = torch.as_tensor(np.random.default_rng(8).standard_normal((1003, 4, 12)),
                        dtype=torch.float32, device=device).transpose(1, 2)  # strided
    assert not b.is_contiguous()
    torch.testing.assert_close(cholesky.psd_solve_batched(a, b), psd_solve_unrolled(a, b),
                               rtol=2e-3, atol=2e-4)
    a_view = a.transpose(1, 2)  # symmetric, so the same matrices, strided
    torch.testing.assert_close(cholesky.cholesky_batched(a_view), cholesky_unrolled(a),
                               rtol=1e-4, atol=1e-4)
    one = a[:1].expand(64, 12, 12)  # broadcast
    torch.testing.assert_close(cholesky.cholesky_batched(one), cholesky_unrolled(one),
                               rtol=1e-4, atol=1e-4)


def test_non_pd_gives_nan_like_the_plain_version(device):
    a = torch.diag(torch.tensor([1.0, -1.0, 2.0, 3.0], device=device)).expand(40, 4, 4)
    b = torch.ones((40, 4, 2), device=device)
    L, L_ref = cholesky.cholesky_batched(a), cholesky_unrolled(a)
    assert torch.equal(torch.isnan(L), torch.isnan(L_ref))
    assert bool(torch.isnan(L[:, 1:, 1]).all()) and bool(torch.isfinite(L[:, :, 0]).all())
    X, X_ref = cholesky.psd_solve_batched(a, b), psd_solve_unrolled(a, b)
    assert torch.equal(torch.isnan(X), torch.isnan(X_ref)) and bool(torch.isnan(X).any())


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    a = _spd(64, 12, device, seed=3)
    with pytest.raises(ValueError, match="float32"):
        cholesky.cholesky_batched(a.double())
    with pytest.raises(ValueError, match="envelope"):
        cholesky.cholesky_batched(_spd(8, 49, device, seed=1))
    with pytest.raises(ValueError, match="envelope"):
        cholesky.psd_solve_batched(a, torch.zeros((64, 12, 49), device=device))
    with pytest.raises(ValueError, match="shape"):
        cholesky.psd_solve_batched(a, torch.zeros((63, 12, 4), device=device))
    with pytest.raises(ValueError, match="cpu"):
        cholesky.psd_solve_batched(a, torch.zeros((64, 12, 4)))


def test_argmax_takes_the_first_maximum_on_the_card(device):
    """lu_solve_unrolled's pivot rule, as jnp.argmax: first maximum on ties,
    first NaN."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [float("nan"), 1.0, float("nan"), 5.0]],
                     device=device)
    assert torch.argmax(x, dim=-1).tolist() == [1, 0]
