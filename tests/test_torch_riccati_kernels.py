"""The plain versions of the Riccati and small-matrix kernels of
numpower_tpu_torch (K5 riccati_batched_fused, K6a cholesky_batched, K6b
psd_solve_batched) against the JAX package's Pallas kernels in interpret mode,
at the sizes the JAX package's own tests use (tests/test_kernels.py:55-136,
tile_b=128), and the port's wrappers on a CPU tensor, which must run exactly
their plain versions and launch nothing.

Tolerances are the JAX package's for its kernels: K5 rtol 1e-3 / atol 1e-4 on
Ks and 1e-3 on P0; K6a 1e-4; K6b rtol 2e-3 / atol 2e-4 and a residual
|AX - B| <= 2e-3. The kernels themselves are held against these plain
versions on the card by tests/test_torch_riccati_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from numpower_tpu.kernels.cholesky import cholesky_batched as jax_cholesky  # noqa: E402
from numpower_tpu.kernels.cholesky import psd_solve_batched as jax_psd_solve  # noqa: E402
from numpower_tpu.kernels.riccati import riccati_batched_fused as jax_riccati  # noqa: E402
from numpower_tpu.models import quadrotor12  # noqa: E402
from numpower_tpu_torch.kernels import cholesky, riccati  # noqa: E402
from numpower_tpu_torch.models import riccati_scan_per_scenario  # noqa: E402


def _costs():
    return (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
            np.eye(12, dtype=np.float32) * 5.0)


def _plants(N, per_scenario_b, seed=0):
    A, B = (np.asarray(x) for x in quadrotor12(0.02))
    rng = np.random.default_rng(seed)
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 12))).astype(np.float32)
    if per_scenario_b:
        return As, (np.tile(B, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 4))).astype(np.float32)
    return As, np.broadcast_to(B, (N, 12, 4))


def _spd(N, n, seed, shift):
    a = np.random.default_rng(seed).standard_normal((N, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + shift * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("per_scenario_b", [True, False], ids=["Bs_each", "Bs_broadcast"])
def test_riccati_plain_matches_jax_kernel(per_scenario_b):
    As, Bs = _plants(8, per_scenario_b)
    Ks_j, P0_j = jax_riccati(jnp.asarray(As), jnp.asarray(Bs), *_costs(), 20, tile_b=128,
                             interpret=True)
    Bs_t = torch.from_numpy(np.ascontiguousarray(Bs))
    if not per_scenario_b:
        Bs_t = Bs_t[:1].expand(8, 12, 4)  # the broadcast view a caller passes
    Ks, P0 = riccati.riccati_batched_reference(torch.from_numpy(As), Bs_t, *_costs(), 20)
    assert Ks.shape == (8, 20, 4, 12) and P0.shape == (8, 12, 12)
    np.testing.assert_allclose(Ks.numpy(), np.asarray(Ks_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(P0.numpy(), np.asarray(P0_j), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("N,junk_upper", [(40, False), (17, True)])
def test_cholesky_plain_matches_jax_kernel(N, junk_upper):
    spd = _spd(N, 12, 1, 8.0)
    if junk_upper:  # both read the lower triangle only
        spd = spd + np.triu(np.random.default_rng(9).standard_normal(spd.shape), 1).astype(np.float32)
    L_j = jax_cholesky(jnp.asarray(spd), tile_b=128, interpret=True)
    L = cholesky.cholesky_batched_reference(torch.from_numpy(spd))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), rtol=1e-4, atol=1e-4)
    assert not np.triu(L.numpy(), 1).any() and not np.triu(np.asarray(L_j), 1).any()


@pytest.mark.parametrize("N,n,r", [(24, 8, 5), (17, 4, 12), (17, 12, 4)])
def test_psd_solve_plain_matches_jax_kernel(N, n, r):
    spd = _spd(N, n, 2 + n, float(n))
    b = np.random.default_rng(r).standard_normal((N, n, r)).astype(np.float32)
    X_j = jax_psd_solve(jnp.asarray(spd), jnp.asarray(b), tile_b=128, interpret=True)
    X = cholesky.psd_solve_batched_reference(torch.from_numpy(spd), torch.from_numpy(b))
    np.testing.assert_allclose(X.numpy(), np.asarray(X_j), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(spd @ X.numpy(), b, rtol=2e-3, atol=2e-3)


def test_wrappers_on_cpu_take_the_plain_version():
    counters = (riccati.riccati_batched_fused, cholesky.cholesky_batched,
                cholesky.psd_solve_batched)
    before = [c.launches for c in counters]
    As, Bs = (torch.from_numpy(np.ascontiguousarray(x)) for x in _plants(6, True))
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, *_costs(), 10)
    Ks_p, P0_p = riccati.riccati_batched_reference(As, Bs, *_costs(), 10)
    assert torch.equal(Ks, Ks_p) and torch.equal(P0, P0_p)
    spd = torch.from_numpy(_spd(6, 4, 3, 4.0))
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((6, 4, 12)).astype(np.float32))
    assert torch.equal(cholesky.cholesky_batched(spd), cholesky.cholesky_batched_reference(spd))
    assert torch.equal(cholesky.psd_solve_batched(spd, b),
                       cholesky.psd_solve_batched_reference(spd, b))
    assert [c.launches for c in counters] == before  # no kernel ran


def test_per_scenario_routes_on_cpu_run_the_plain_versions():
    """"fused" and "psd" on a CPU tensor run the kernels' plain versions,
    which are the "plain" route's own recurrence: the same bits."""
    As, Bs = (torch.from_numpy(np.ascontiguousarray(x)) for x in _plants(5, False))
    plain = riccati_scan_per_scenario(As, Bs, *_costs(), 10, method="plain")
    for method in ("auto", "fused", "psd"):
        got = riccati_scan_per_scenario(As, Bs, *_costs(), 10, method=method)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]), method
