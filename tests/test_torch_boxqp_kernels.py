"""The box-QP kernels of numpower_tpu_torch against the JAX package's Pallas
kernels: the fused ones (K1, K2) and the two-step ones that take g (K3a
admm_boxqp, K3b fista_boxqp, with the drop-in solve_mpc_boxqp_pallas).

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs fista_mpc_pallas_res / admm_mpc_pallas_res / fista_boxqp_pallas /
admm_boxqp_pallas in interpret mode, as tests/test_kernels.py does. The
two-step kernels get g of a reference-tracking problem (an x_ref held over
the horizon), formed once by the JAX package and handed to both. Both solve the identical QP (carried over with
condensed_from_jax) from the same numpy inputs. Tolerances: all-fp32
(coarse_iters=0) 1e-5 on the solution and the residuals; the default
bf16 + fp32 schedules 1e-4, because JAX on the CPU computes the coarse
DEFAULT-precision products in fp32 while the port rounds their operands to
bf16 as the TPU does.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from numpower_tpu.kernels.boxqp_admm import (  # noqa: E402
    admm_boxqp_pallas, admm_mpc_pallas_res,
)
from numpower_tpu.kernels.boxqp_fista import (  # noqa: E402
    fista_boxqp_pallas, fista_mpc_pallas_res,
)
from numpower_tpu.models import gradient_offset as jax_gradient_offset  # noqa: E402
from numpower_tpu.models.condensed import (  # noqa: E402
    default_coarse_iters as jax_default_coarse_iters,
)
from numpower_tpu.models import condense as jax_condense  # noqa: E402
from numpower_tpu.models import quadrotor12  # noqa: E402
from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista  # noqa: E402
from numpower_tpu_torch.models.condensed import (  # noqa: E402
    admm_coarse_iters, condensed_from_jax, default_coarse_iters,
)

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
N, ITERS = 24, 40
BOXES = {"pm0.5": (-0.5, 0.5), "0.1-0.5": (0.1, 0.5)}  # the second excludes 0


def _qps(T):
    A, B = quadrotor12(0.02)
    jqp = jax_condense(jnp.asarray(A), jnp.asarray(B), jnp.eye(12), jnp.eye(4) * 0.1,
                       jnp.eye(12) * 5.0, T)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                             T=T, n=jqp.n, m=jqp.m, kappa=jqp.kappa, device="cpu")
    return jqp, tqp


@pytest.fixture(scope="module", params=[10, 30], ids=lambda T: f"T{T}")
def qps(request):
    return _qps(request.param)


def _inputs(T, warm):
    rng = np.random.default_rng(0)
    x0s = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
    # a warm start that leaves the box in places: FISTA takes U0 as it is,
    # ADMM clips it
    U0 = (0.8 * rng.standard_normal((N, 4 * T))).astype(np.float32) if warm else None
    return x0s, U0


def _tol(coarse):
    return 1e-5 if coarse == 0 else 1e-4


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_fista_plain_matches_jax_kernel(qps, schedule, box, start):
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else default_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, start == "warm")
    U_j, r_j = fista_mpc_pallas_res(
        jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(lo), jnp.float32(hi),
        jqp.lipschitz, iters=ITERS, coarse_iters=coarse, tile_n=16, interpret=True,
        U0=None if U0 is None else jnp.asarray(U0))
    U_t, r_t = boxqp_fista.fista_mpc_res(
        tqp.H, tqp.Sx.T, tqp.SuTQ.T, torch.from_numpy(x0s), lo, hi, tqp.lipschitz,
        iters=ITERS, coarse_iters=coarse, U0=None if U0 is None else torch.from_numpy(U0))
    tol = _tol(coarse)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(r_t), float(r_j), rtol=0, atol=tol)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_admm_plain_matches_jax_kernel(qps, schedule, box, start):
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, start == "warm")
    rho_j = jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12))
    z_j, rp_j, rd_j = admm_mpc_pallas_res(
        jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(lo), jnp.float32(hi),
        rho_j, iters=ITERS, coarse_iters=coarse, tile_n=16, interpret=True,
        U0=None if U0 is None else jnp.asarray(U0))
    z_t, rp_t, rd_t = boxqp_admm.admm_mpc_res(
        tqp.H, tqp.Sx.T, tqp.SuTQ.T, torch.from_numpy(x0s), lo, hi,
        torch.from_numpy(np.array(rho_j)), iters=ITERS, coarse_iters=coarse,
        U0=None if U0 is None else torch.from_numpy(U0))
    tol = _tol(coarse)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rp_t), float(rp_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rd_t), float(rd_j), rtol=0, atol=tol)


def test_wrappers_on_cpu_take_the_plain_version():
    _, tqp = _qps(10)
    x0s, U0 = _inputs(10, warm=True)
    x0s, U0 = torch.from_numpy(x0s), torch.from_numpy(U0)
    before = (boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches)
    fold = (tqp.H, tqp.Sx.T, tqp.SuTQ.T)
    U, r = boxqp_fista.fista_mpc_res(*fold, x0s, -0.5, 0.5, tqp.lipschitz, 20, 10, U0)
    U_ref, r_ref = boxqp_fista.fista_mpc_res_reference(*fold, x0s, -0.5, 0.5, tqp.lipschitz,
                                                       20, 10, U0)
    assert torch.equal(U, U_ref) and torch.equal(r, r_ref)
    z, rp, rd = boxqp_admm.admm_mpc_res(*fold, x0s, -0.5, 0.5, 0.2, 20, 10, U0=U0)
    z_ref, rp_ref, rd_ref = boxqp_admm.admm_mpc_res_reference(*fold, x0s, -0.5, 0.5, 0.2,
                                                              20, 10, U0=U0)
    assert torch.equal(z, z_ref) and torch.equal(rp, rp_ref) and torch.equal(rd, rd_ref)
    # no kernel ran
    assert (boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches) == before


def _g(jqp, x0s):
    """g of tracking x_ref = 0.2 N(0, 1) from seed 5, by the JAX package."""
    x_ref = (0.2 * np.random.default_rng(5).standard_normal(12)).astype(np.float32)
    return np.array(jax_gradient_offset(jqp, jnp.asarray(x0s), jnp.asarray(x_ref)))


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_fista_boxqp_plain_matches_jax_kernel(qps, schedule, box, start):
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else default_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, start == "warm")
    g = _g(jqp, x0s)
    U_j = fista_boxqp_pallas(jqp.H, jnp.asarray(g), jnp.float32(lo), jnp.float32(hi),
                             jqp.lipschitz, iters=ITERS, coarse_iters=coarse, tile_n=16,
                             interpret=True, U0=None if U0 is None else jnp.asarray(U0))
    U_t = boxqp_fista.fista_boxqp(tqp.H, torch.from_numpy(g), lo, hi, tqp.lipschitz,
                                  iters=ITERS, coarse_iters=coarse,
                                  U0=None if U0 is None else torch.from_numpy(U0))
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=0, atol=_tol(coarse))


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_admm_boxqp_plain_matches_jax_kernel(qps, schedule, box, start):
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, start == "warm")
    g = _g(jqp, x0s)
    rho_j = jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12))
    z_j, y_j = admm_boxqp_pallas(jqp.H, jnp.asarray(g), jnp.float32(lo), jnp.float32(hi),
                                 rho_j, iters=ITERS, coarse_iters=coarse, tile_n=16,
                                 interpret=True, U0=None if U0 is None else jnp.asarray(U0))
    z_t, y_t = boxqp_admm.admm_boxqp(tqp.H, torch.from_numpy(g), lo, hi,
                                     torch.from_numpy(np.array(rho_j)), iters=ITERS,
                                     coarse_iters=coarse,
                                     U0=None if U0 is None else torch.from_numpy(U0))
    tol = _tol(coarse)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=tol)
    # y = s - z carries the x-update's magnitude (|y| up to ~1), and JAX's
    # interpret-mode tail runs that product as bf16x3, ~1e-5 relative: the
    # same bound plus 1e-5 of |y|
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=tol)


def test_solve_mpc_boxqp_pallas_matches_jax(qps):
    """The drop-in against the JAX one's steps (solve_mpc_boxqp_pallas has no
    interpret switch, so its three lines run here with the kernel in
    interpret mode): g, the two-step kernel at the default schedule, the
    residual outside. Bound 1e-4, as for the default schedules above."""
    jqp, tqp = qps
    x0s, _ = _inputs(tqp.T, warm=False)
    coarse = jax_default_coarse_iters(jqp, ITERS)
    g = jax_gradient_offset(jqp, jnp.asarray(x0s))
    U_j = fista_boxqp_pallas(jqp.H, g, jnp.float32(-0.5), jnp.float32(0.5), jqp.lipschitz,
                             iters=ITERS, coarse_iters=coarse, tile_n=16, interpret=True)
    grad = U_j @ jqp.H.T + g
    r_j = jnp.max(jnp.abs(U_j - jnp.clip(U_j - grad / jqp.lipschitz, -0.5, 0.5)))
    got = boxqp_fista.solve_mpc_boxqp_pallas(tqp, torch.from_numpy(x0s), -0.5, 0.5,
                                             iters=ITERS)
    assert default_coarse_iters(tqp, ITERS) == coarse
    np.testing.assert_allclose(got.U.numpy(), np.asarray(U_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.residual), float(r_j), rtol=0, atol=1e-4)
    assert got.iterations == ITERS


def test_two_step_wrappers_on_cpu_take_the_plain_version():
    jqp, tqp = _qps(10)
    x0s, U0 = _inputs(10, warm=True)
    g, U0 = torch.from_numpy(_g(jqp, x0s)), torch.from_numpy(U0)
    before = (boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches)
    U = boxqp_fista.fista_boxqp(tqp.H, g, -0.5, 0.5, tqp.lipschitz, 20, 10, U0)
    assert torch.equal(U, boxqp_fista.fista_boxqp_reference(tqp.H, g, -0.5, 0.5,
                                                            tqp.lipschitz, 20, 10, U0))
    z, y = boxqp_admm.admm_boxqp(tqp.H, g, -0.5, 0.5, 0.2, 20, 10, U0=U0)
    z_ref, y_ref = boxqp_admm.admm_boxqp_reference(tqp.H, g, -0.5, 0.5, 0.2, 20, 10, U0=U0)
    assert torch.equal(z, z_ref) and torch.equal(y, y_ref)
    # no kernel ran
    assert (boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches) == before
