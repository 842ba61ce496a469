"""The Riccati family past n = 16 (K5 riccati_batched_fused, K6a
cholesky_batched, K6b psd_solve_batched, up to n = m = r = 48) of
numpower_tpu_torch against the JAX package on the same numpy inputs (CPU).

On the CPU each kernel wrapper runs its plain version: the "fused" route of
riccati_scan_per_scenario is riccati_batched_reference, "psd" solves with
psd_solve_unrolled, and "plain" with utils/smallmat (torch.linalg past 16).
The JAX side runs its "xla" route, the reference its own fused kernel is
held to (tests/test_kernels.py:116-136; the Pallas Riccati kernel in
interpret mode takes over a minute past n = 16), and its cholesky_batched
and psd_solve_batched in interpret mode at n = 17; at n = 33 and 48 the
functions they are the drop-in for, jnp.linalg.cholesky and a Cholesky
solve (bench.py:1246-1252).

Sizes: (17, 1), (32, 8) and (48, 48), the envelope's edges, and (24, 8) on
random stable systems; (36, 12) and (48, 16), three and four quadrotor12
plants in a formation: A = kron(I_k, Aq), B = kron(I_k, Bq), Q = I +
kron(L_ring, E_pos) (the ring's Laplacian over the quadrotors' positions),
R = 0.1 I, QF = 5 I, each scenario's A perturbed by 0.01 N(0, 1).

Tolerances: the Riccati gains rtol 2e-3 / atol 2e-4 and the cost-to-go rtol
2e-3 / atol 2e-3, as the JAX package holds its per-scenario Riccati against
the single-system scan (tests/test_mpc.py:296-299); the factor rtol 1e-4 /
atol 1e-4 with exact zeros above the diagonal, the solve rtol 2e-3 / atol
2e-4 with a residual |AX - B| <= 2e-3 (tests/test_kernels.py:60-82).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.scipy.linalg as jsl  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
from numpower_tpu.kernels import cholesky as jchol  # noqa: E402
from numpower_tpu_torch.kernels import cholesky, riccati  # noqa: E402
from numpower_tpu_torch.models import riccati_scan_per_scenario  # noqa: E402
from numpower_tpu_torch.models.lqr import route_riccati_per_scenario  # noqa: E402
from numpower_tpu_torch.utils.flops import riccati_fused_cost  # noqa: E402

N = 6


def formation(k: int, N: int):
    """chip_smoke.formation with Bs broadcast: (As, Bs, Q, R, QF), numpy."""
    As, B, Q, R, QF = chip_smoke.formation(k, N)
    return As, np.broadcast_to(B, (N,) + B.shape), Q, R, QF


def stable(n: int, m: int, N: int, seed: int):
    """A random plant with A's eigenvalues well inside the unit circle (0.8 I
    plus a 3% perturbation), per-scenario As and Bs perturbed by 0.01 N(0, 1),
    Q = I, R = 0.1 I, QF = 5 I."""
    rng = np.random.default_rng(seed)
    A = 0.8 * np.eye(n) + 0.03 * rng.standard_normal((n, n))
    B = 0.1 * rng.standard_normal((n, m))
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, n, n))).astype(np.float32)
    Bs = (np.tile(B, (N, 1, 1)) + 0.01 * rng.standard_normal((N, n, m))).astype(np.float32)
    return (As, Bs, np.eye(n, dtype=np.float32), (0.1 * np.eye(m)).astype(np.float32),
            (5.0 * np.eye(n)).astype(np.float32))


# (n, m): the problem and its horizon (T <= 20; 10 at m = 48, whose unrolled
# 48 x 48 solves dominate the file's time on the CPU)
SIZES = {
    (17, 1): lambda: stable(17, 1, N, seed=17) + (20,),
    (24, 8): lambda: stable(24, 8, N, seed=24) + (20,),
    (32, 8): lambda: stable(32, 8, N, seed=32) + (20,),
    (36, 12): lambda: formation(3, N) + (20,),
    (48, 16): lambda: formation(4, N) + (20,),
    (48, 48): lambda: stable(48, 48, N, seed=48) + (10,),
}


@functools.cache
def _problem(n, m):
    return SIZES[(n, m)]()


@functools.cache
def _jax_xla(n, m):
    As, Bs, Q, R, QF, T = _problem(n, m)
    Ks, P0 = jm.riccati_scan_per_scenario(jnp.asarray(As), jnp.asarray(Bs), Q, R, QF, T,
                                          method="xla")
    return np.asarray(Ks), np.asarray(P0)


@pytest.mark.parametrize("route", ["fused", "psd", "plain"])
@pytest.mark.parametrize("n,m", list(SIZES))
def test_riccati_per_scenario_wide_matches_jax_xla(n, m, route):
    As, Bs, Q, R, QF, T = _problem(n, m)
    Ks_j, P0_j = _jax_xla(n, m)
    Ks, P0 = riccati_scan_per_scenario(torch.from_numpy(As), torch.from_numpy(np.array(Bs)),
                                       Q, R, QF, T, method=route)
    assert Ks.shape == (N, T, m, n) and P0.shape == (N, n, n)
    assert Ks.dtype == torch.float32 and Ks.device.type == "cpu"
    np.testing.assert_allclose(Ks.numpy(), Ks_j, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(P0.numpy(), P0_j, rtol=2e-3, atol=2e-3)


def test_formation_is_the_issue_configuration():
    """n = 48, m = 16; Q symmetric positive definite and coupling the
    quadrotors' positions only; the same As for the same seed."""
    As, Bs, Q, R, QF = formation(4, 8)
    assert As.shape == (8, 48, 48) and Bs.shape == (8, 48, 16)
    np.testing.assert_array_equal(Q, Q.T)
    assert np.linalg.eigvalsh(Q.astype(np.float64)).min() >= 1.0 - 1e-6
    off = Q - np.eye(48, dtype=np.float32)
    rows = np.nonzero(off.any(axis=1))[0]
    np.testing.assert_array_equal(rows % 12, np.tile([0, 1, 2], 4))
    np.testing.assert_array_equal(As, formation(4, 8)[0])


def _spd(N, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [17, 33, 48])
def test_cholesky_batched_wide_matches_jax(n):
    a = _spd(8, n, seed=n)
    if n == 17:  # the Pallas kernel in interpret mode
        want = np.asarray(jchol.cholesky_batched(jnp.asarray(a), tile_b=128, interpret=True))
    else:  # the function it is the drop-in for
        want = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    L = cholesky.cholesky_batched(torch.from_numpy(a))
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-4, atol=1e-4)
    assert not np.triu(L.numpy(), 1).any()


@functools.cache
def _jax_solve(n):
    """(a, b, X) at 48 right-hand-side columns: the JAX kernel (n = 17, in
    interpret mode) or a Cholesky solve. Each column of X is solved on its
    own, by the same operations, so the first r columns of X are the solve
    against the first r columns of b."""
    a = _spd(8, n, seed=100 + n)
    b = np.random.default_rng(n).standard_normal((8, n, 48)).astype(np.float32)
    if n == 17:
        X = jchol.psd_solve_batched(jnp.asarray(a), jnp.asarray(b), tile_b=128, interpret=True)
    else:
        X = jsl.cho_solve((jnp.linalg.cholesky(jnp.asarray(a)), True), jnp.asarray(b))
    return a, b, np.asarray(X)


@pytest.mark.parametrize("r", [1, 16, 48])
@pytest.mark.parametrize("n", [17, 33, 48])
def test_psd_solve_batched_wide_matches_jax(n, r):
    a, b, want = _jax_solve(n)
    b = np.ascontiguousarray(b[..., :r])
    X = cholesky.psd_solve_batched(torch.from_numpy(a), torch.from_numpy(b))
    assert X.shape == (8, n, r)
    np.testing.assert_allclose(X.numpy(), want[..., :r], rtol=2e-3, atol=2e-4)
    assert np.abs(a @ X.numpy() - b).max() <= 2e-3


def test_route_is_fused_inside_the_envelope_and_plain_past_it():
    for n in range(1, 50):
        for m in range(1, 50):
            inside = n <= 48 and m <= 48
            assert route_riccati_per_scenario("cuda", n, m) == ("fused" if inside else "plain")
            assert route_riccati_per_scenario("cpu", n, m) == "plain"
            for method in ("fused", "psd", "pallas"):
                if inside:
                    assert route_riccati_per_scenario("cuda", n, m, method) in ("fused", "psd")
                else:
                    with pytest.raises(ValueError, match="envelope"):
                        route_riccati_per_scenario("cuda", n, m, method)


@pytest.mark.parametrize("n,m,entry", [
    (1, 1, "npt_riccati_fused"), (16, 8, "npt_riccati_fused"),  # the narrow form
    (17, 1, "npt_riccati_fused_wide"), (16, 9, "npt_riccati_fused_wide"),
    (12, 16, "npt_riccati_fused_wide"), (48, 16, "npt_riccati_fused_wide"),
    (48, 48, "npt_riccati_fused_wide"),
])
def test_riccati_kernel_entry_by_shape(n, m, entry):
    assert riccati._entry(4096, n, m, 30) == entry


@pytest.mark.parametrize("n,m,T", [(49, 1, 30), (1, 49, 30), (49, 49, 30), (12, 4, -1)])
def test_riccati_kernel_entry_rejects_past_the_envelope(n, m, T):
    with pytest.raises(ValueError, match="envelope"):
        riccati._entry(4096, n, m, T)


def test_small_matrix_kernels_envelope():
    for n in (1, 16, 17, 48):
        assert cholesky._batch_shape(torch.empty(3, n, n)) == (3, n)
    with pytest.raises(ValueError, match="envelope"):
        cholesky._batch_shape(torch.empty(3, 49, 49))
    assert (cholesky.NARROW_DIM, cholesky.NARROW_RHS, cholesky.MAX_DIM, cholesky.MAX_RHS) == \
        (16, 16, 48, 48)
    assert (riccati.NARROW_N, riccati.NARROW_M, riccati.MAX_N, riccati.MAX_M) == (16, 8, 48, 48)


@pytest.mark.parametrize("n", [49])
def test_cpu_wrappers_take_their_plain_versions_past_the_envelope(n):
    """On the CPU a wrapper runs its plain version at any size, as the JAX
    package's kernels take any size; the envelope binds the card."""
    a = torch.from_numpy(_spd(2, n, seed=5))
    L = cholesky.cholesky_batched(a)
    torch.testing.assert_close(L @ L.mT, a, rtol=1e-4, atol=1e-3)
    b = torch.ones((2, n, 3))
    torch.testing.assert_close(a @ cholesky.psd_solve_batched(a, b), b, rtol=1e-4, atol=1e-4)


def test_riccati_fused_cost_past_16():
    """utils/flops.riccati_fused_cost at the formation: 643,072 FLOP a
    scenario-step (4n^3 + 4mn^2 + 4m^2n + m^3), 7.9e10 at N = 4096, T = 30
    (1.18 ms at the H100's 67 fp32 TFLOP/s), 466 MB moved (0.14 ms at
    3.35 TB/s)."""
    N_, T = 4096, 30
    cost = riccati_fused_cost(N_, T, 48, 16)
    assert cost.flops == N_ * T * 643_072
    assert cost.bytes_moved == 4.0 * N_ * (48 * 48 + 48 * 16 + T * 16 * 48 + 48 * 48)
    assert 465e6 < cost.bytes_moved < 466e6  # 466 MB rounded
    assert cost.flops / 67e12 == pytest.approx(1.18e-3, rel=1e-2)
    assert riccati_fused_cost(1, 1, 48, 48).flops == 13 * 48 ** 3  # 4 + 4 + 4 + 1 n^3
