"""The wide forms of K5 riccati_batched_fused, K6a cholesky_batched and K6b
psd_solve_batched (csrc/riccati_wide.cu, cholesky_wide.cu; n, m, r up to
48) against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu; it builds the
four-quadrotor formation and its random plants with chip_smoke, so run it
from the repository's root, without the conftest (which imports jax):

    python -m pytest --noconftest tests/test_torch_riccati_wide_cuda.py -q

Covered: every K5 bucket (NB in {16, 32, 48} x MB in {8, 16, 32, 48}, less
the narrow form's (16, 8)) at its edges, N = 1 and a ragged 1003, T = 0 and
T = 1; at n = 48 the warp's inverse of S (m <= 32) and the block's factor
(m > 32); the formation at N = 529, one past a wave of four blocks on each
of 132 multiprocessors; the formation with A far from the identity (-As,
As O), also against float64; the
formation through riccati_scan_per_scenario ("auto": one K5 launch, "psd":
T K6b launches); K6a at every n = 17..48; K6b across the narrow form's edge
(n or r = 16 / 17) and at every wide bucket; misaligned and strided
operands; ValueError at n, m or r = 49 and nowhere below.

Tolerances as tests/test_torch_riccati_cuda.py: K5 rtol 1e-3 / atol 1e-4 on
Ks and 1e-3 on P0; K6b rtol 2e-3 / atol 2e-4 and a residual |AX - B| <=
2e-3; K6a 1e-4, exact zeros above the diagonal. The plain versions' unrolled
48 x 48 factor is ~40k launches a call on the card, so the horizons here are
short.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (FAR_FROM_I, K5_WIDE_SHAPES, formation, formation_far, scaled_err,
                        stable_plant)
from numpower_tpu_torch.kernels import cholesky, riccati
from numpower_tpu_torch.models import riccati_scan_per_scenario
from numpower_tpu_torch.utils.smallmat import cholesky_unrolled, psd_solve_unrolled

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _stable(N, n, m, device, seed):
    """chip_smoke.stable_plant on the card: As per scenario, Bs broadcast,
    (Q, R, QF) = (I, 0.1 I, 5 I)."""
    As, B, *costs = stable_plant(n, m, N, seed)
    Bs = torch.as_tensor(B, device=device).expand(N, n, m)
    return torch.as_tensor(As, device=device), Bs, costs


def _spd(N, n, device, seed, junk_upper=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, n, n)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    if junk_upper:  # the kernels read the lower triangle only
        spd = spd + np.triu(rng.standard_normal((N, n, n)).astype(np.float32), 1)
    return torch.as_tensor(spd, device=device)


def _assert_riccati(As, Bs, costs, T):
    launches = riccati.riccati_batched_fused.launches
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, *costs, T)
    torch.cuda.synchronize()
    assert riccati.riccati_batched_fused.launches == launches + 1
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *costs, T)
    torch.testing.assert_close(Ks, Ks_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(P0, P0_ref, rtol=1e-3, atol=1e-3)


# each wide bucket (NB, MB) at the (n, m) of its upper edge and one inside it
K5_SHAPES = list(K5_WIDE_SHAPES)


@pytest.mark.parametrize("N", [1003, 1])
@pytest.mark.parametrize("n,m", K5_SHAPES)
def test_riccati_wide_every_bucket(device, n, m, N):
    As, Bs, costs = _stable(N, n, m, device, seed=n * 64 + m)
    _assert_riccati(As, Bs, costs, 3 if max(n, m) > 40 else 6)


@pytest.mark.parametrize("n,m", K5_SHAPES)
def test_riccati_wide_one_step(device, n, m):
    """T = 1: one step from QF, the gains of its only stage."""
    As, Bs, costs = _stable(257, n, m, device, seed=n * 64 + m + 1)
    _assert_riccati(As, Bs, costs, 1)


# at n = 48: the warp's register inverse of S for m <= 32 (MB = 8, 16, 32)
# and the block's factor and substitutions past it (MB = 48)
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 31, 32, 33, 40, 47, 48])
def test_riccati_wide_inverse_and_factor_at_48(device, m):
    As, Bs, costs = _stable(1003, 48, m, device, seed=4800 + m)
    _assert_riccati(As, Bs, costs, 4)


def test_riccati_wide_formation_past_a_wave(device):
    """N = 529: a wave of four blocks on each of 132 multiprocessors and one
    scenario more."""
    As, B, Q, R, QF = formation(4, 529)
    _assert_riccati(torch.as_tensor(As, device=device),
                    torch.as_tensor(B, device=device).expand(529, 48, 16), (Q, R, QF), 30)


@pytest.mark.parametrize("kind", FAR_FROM_I)
def test_riccati_wide_formation_far_from_identity(device, kind):
    """The formation's Q, R, QF and T = 30 with A far from I (-As, or As
    times a random orthogonal matrix): the products must hold the plain
    version's bounds whatever A is, and stay within four times the plain
    version's own distance from float64 (phase 28's check)."""
    As, B, Q, R, QF = formation_far(kind, 4, 1003)
    As = torch.as_tensor(As, device=device)
    Bs = torch.as_tensor(B, device=device).expand(1003, 48, 16)
    _assert_riccati(As, Bs, (Q, R, QF), 30)
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, Q, R, QF, 30)
    Ks_p, P0_p = riccati.riccati_batched_reference(As, Bs, Q, R, QF, 30)
    Ks_64, P0_64 = riccati.riccati_batched_reference(As.double(), Bs.double(), Q, R, QF, 30)
    e_k = max(scaled_err(Ks, Ks_64, 1e-3, 1e-4), scaled_err(P0, P0_64, 1e-3, 1e-3))
    e_p = max(scaled_err(Ks_p, Ks_64, 1e-3, 1e-4), scaled_err(P0_p, P0_64, 1e-3, 1e-3))
    assert e_k <= max(1.0, 4 * e_p), (e_k, e_p)


@pytest.mark.parametrize("n,m", [(17, 1), (48, 16), (48, 48)])
def test_riccati_wide_returns_qf_at_t0(device, n, m):
    As, Bs, _ = _stable(65, n, m, device, seed=5)
    QF = np.random.default_rng(6).standard_normal((n, n)).astype(np.float32)  # asymmetric
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, np.eye(n), np.eye(m), QF, 0)
    torch.cuda.synchronize()
    assert Ks.shape == (65, 0, m, n)
    assert torch.equal(P0, torch.as_tensor(QF, device=device).expand(65, n, n))


@pytest.mark.parametrize("N", [4096, 1003])
def test_riccati_wide_on_the_formation(device, N):
    As, B, Q, R, QF = formation(4, N)
    _assert_riccati(torch.as_tensor(As, device=device),
                    torch.as_tensor(B, device=device).expand(N, 48, 16), (Q, R, QF), 30)


def test_formation_routes_and_launch_counts(device):
    """riccati_scan_per_scenario at the formation: "auto" is one K5 launch,
    "psd" one K6b launch a stage, both equal to the plain route."""
    As, B, Q, R, QF = formation(4, 256)
    As = torch.as_tensor(As, device=device)
    Bs = torch.as_tensor(B, device=device).expand(256, 48, 16)
    fused, psd = riccati.riccati_batched_fused, cholesky.psd_solve_batched
    before = (fused.launches, psd.launches)
    Ks_auto, P0_auto = riccati_scan_per_scenario(As, Bs, Q, R, QF, 30)
    assert (fused.launches, psd.launches) == (before[0] + 1, before[1])
    Ks_psd, P0_psd = riccati_scan_per_scenario(As, Bs, Q, R, QF, 30, method="psd")
    assert (fused.launches, psd.launches) == (before[0] + 1, before[1] + 30)
    Ks_plain, P0_plain = riccati_scan_per_scenario(As, Bs, Q, R, QF, 30, method="plain")
    assert (fused.launches, psd.launches) == (before[0] + 1, before[1] + 30)
    for Ks, P0 in ((Ks_auto, P0_auto), (Ks_psd, P0_psd)):
        torch.testing.assert_close(Ks, Ks_plain, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(P0, P0_plain, rtol=1e-3, atol=1e-3)


def test_riccati_wide_takes_misaligned_views(device):
    As, Bs, costs = _stable(257, 33, 8, device, seed=9)
    buf = torch.empty(As.numel() + 1, device=device)
    view = buf[1:].view(As.shape)
    view.copy_(As)
    assert view.data_ptr() % 16 == 4
    Ks, P0 = riccati.riccati_batched_fused(view, Bs, *costs, 5)
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *costs, 5)
    torch.testing.assert_close(Ks, Ks_ref, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(P0, P0_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("N", [1, 5, 1003])
@pytest.mark.parametrize("n", list(range(17, 49)))
def test_cholesky_wide_every_dim(device, n, N):
    a = _spd(N, n, device, seed=400 + n, junk_upper=True)
    launches = cholesky.cholesky_batched.launches
    L = cholesky.cholesky_batched(a)
    torch.cuda.synchronize()
    assert cholesky.cholesky_batched.launches == launches + 1
    torch.testing.assert_close(L, cholesky_unrolled(a), rtol=1e-4, atol=1e-4)
    assert torch.count_nonzero(torch.triu(L, 1)).item() == 0


@pytest.mark.parametrize("view", ["misaligned", "strided"])
def test_cholesky_wide_takes_misaligned_and_strided_views(device, view):
    a = _spd(1003, 40, device, seed=41, junk_upper=True)
    if view == "misaligned":
        buf = torch.empty(a.numel() + 1, device=device)
        a_in = buf[1:].view(a.shape)
        a_in.copy_(a)
    else:
        a_in = torch.tril(a).mT.contiguous().mT
    L = cholesky.cholesky_batched(a_in)
    torch.testing.assert_close(L, cholesky_unrolled(a), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(L, torch.linalg.cholesky(torch.tril(a) + torch.tril(a, -1).mT),
                               rtol=1e-4, atol=1e-4)


# the narrow form's edge (16, 16) and past it in n or r; every wide bucket of
# n at r = 1, 17, 32, 33, 48
PSD_WIDE = ([(16, 16), (16, 17), (17, 16), (1, 48), (8, 48), (16, 48)]
            + [(n, r) for n in (24, 33, 40, 48) for r in (1, 17, 32, 33, 48)])


@pytest.mark.parametrize("N", [1003, 1])
@pytest.mark.parametrize("n,r", PSD_WIDE)
def test_psd_solve_wide_matches_plain(device, n, r, N):
    a = _spd(N, n, device, seed=n, junk_upper=True)
    b = torch.as_tensor(np.random.default_rng(r).standard_normal((N, n, r)),
                        dtype=torch.float32, device=device)
    launches = cholesky.psd_solve_batched.launches
    X = cholesky.psd_solve_batched(a, b)
    torch.cuda.synchronize()
    assert cholesky.psd_solve_batched.launches == launches + 1
    torch.testing.assert_close(X, psd_solve_unrolled(a, b), rtol=2e-3, atol=2e-4)
    sym = torch.tril(a) + torch.tril(a, -1).transpose(1, 2)
    assert (sym @ X - b).abs().max().item() <= 2e-3


@pytest.mark.parametrize("which", ["a", "b", "strided"])
def test_psd_solve_wide_takes_misaligned_and_strided_views(device, which):
    a = _spd(257, 33, device, seed=3)
    b = torch.as_tensor(np.random.default_rng(4).standard_normal((257, 33, 20)),
                        dtype=torch.float32, device=device)
    a_in, b_in = a, b
    if which in ("a", "b"):
        t = a if which == "a" else b
        buf = torch.empty(t.numel() + 1, device=device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        a_in, b_in = (view, b) if which == "a" else (a, view)
    else:
        b_in = b.mT.contiguous().mT
    X = cholesky.psd_solve_batched(a_in, b_in)
    torch.testing.assert_close(X, psd_solve_unrolled(a, b), rtol=2e-3, atol=2e-4)


def test_wrappers_raise_at_49_and_nowhere_below(device):
    As, Bs, costs = _stable(4, 48, 48, device, seed=1)
    riccati.riccati_batched_fused(As, Bs, *costs, 1)
    cholesky.cholesky_batched(_spd(4, 48, device, seed=2))
    cholesky.psd_solve_batched(_spd(4, 48, device, seed=2), torch.ones((4, 48, 48), device=device))
    torch.cuda.synchronize()
    As, Bs, costs = _stable(4, 49, 4, device, seed=1)
    with pytest.raises(ValueError, match="envelope"):
        riccati.riccati_batched_fused(As, Bs, *costs, 1)
    As, Bs, costs = _stable(4, 12, 49, device, seed=1)
    with pytest.raises(ValueError, match="envelope"):
        riccati.riccati_batched_fused(As, Bs, *costs, 1)
    with pytest.raises(ValueError, match="envelope"):
        cholesky.cholesky_batched(_spd(4, 49, device, seed=2))
    with pytest.raises(ValueError, match="envelope"):
        cholesky.psd_solve_batched(_spd(4, 49, device, seed=2),
                                   torch.ones((4, 49, 4), device=device))
    with pytest.raises(ValueError, match="envelope"):
        cholesky.psd_solve_batched(_spd(4, 12, device, seed=2),
                                   torch.ones((4, 12, 49), device=device))
