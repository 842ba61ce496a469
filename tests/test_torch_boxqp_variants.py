"""The box-QP kernels K1' (admm_mpc) and K2' (fista_mpc), K1's loop forms
and the precision classes of K1 and K2, against the JAX package's Pallas
kernels on the same numpy inputs (CPU).

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs admm_mpc_pallas / fista_mpc_pallas / admm_mpc_pallas_res /
fista_mpc_pallas_res in interpret mode, as tests/test_kernels.py does, on
the identical QP (carried over with condensed_from_jax). Tolerances: all-fp32
(coarse_iters=0) 1e-5 on the solutions and the residuals; the default
bf16 + fp32 schedules 1e-4, because JAX on the CPU computes the coarse
DEFAULT-precision products in fp32 while the port rounds their operands to
bf16 as the TPU does; g at rtol 1e-5, atol 1e-5. The precision classes are
compared class for class: JAX's split schemes run on the CPU as fp32
products of the hi/lo parts, and so do the port's plain versions.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from numpower_tpu.kernels.boxqp_admm import admm_mpc_pallas, admm_mpc_pallas_res  # noqa: E402
from numpower_tpu.kernels.boxqp_fista import (  # noqa: E402
    fista_mpc_pallas, fista_mpc_pallas_res,
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


def _inputs(T, warm, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
    U0 = (0.8 * rng.standard_normal((N, 4 * T))).astype(np.float32) if warm else None
    return x0s, U0


def _tol(coarse):
    return 1e-5 if coarse == 0 else 1e-4


def _rho(jqp):
    return jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12))


def _fold(tqp):
    return tqp.H, tqp.Sx.T, tqp.SuTQ.T


def _jfold(jqp, x0s, lo, hi):
    return (jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(lo), jnp.float32(hi))


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_fista_mpc_plain_matches_jax_kernel(qps, schedule, box):
    """K2': U at the schedule's bound, the g it emits at rtol/atol 1e-5."""
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else default_coarse_iters(tqp, ITERS)
    x0s, _ = _inputs(tqp.T, warm=False)
    U_j, g_j = fista_mpc_pallas(*_jfold(jqp, x0s, lo, hi), jqp.lipschitz, iters=ITERS,
                                coarse_iters=coarse, tile_n=16, interpret=True)
    U_t, g_t = boxqp_fista.fista_mpc(*_fold(tqp), torch.from_numpy(x0s), lo, hi, tqp.lipschitz,
                                     iters=ITERS, coarse_iters=coarse)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=0, atol=_tol(coarse))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_admm_mpc_plain_matches_jax_kernel(qps, schedule, box):
    """K1': z at the schedule's bound, y as in the K3a test (JAX's
    interpret-mode tail is bf16x3, ~1e-5 relative of |y|), g at 1e-5."""
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(tqp, ITERS)
    x0s, _ = _inputs(tqp.T, warm=False)
    rho = _rho(jqp)
    z_j, y_j, g_j = admm_mpc_pallas(*_jfold(jqp, x0s, lo, hi), rho, iters=ITERS,
                                    coarse_iters=coarse, tile_n=16, interpret=True)
    z_t, y_t, g_t = boxqp_admm.admm_mpc(*_fold(tqp), torch.from_numpy(x0s), lo, hi,
                                        torch.from_numpy(np.array(rho)), iters=ITERS,
                                        coarse_iters=coarse)
    tol = _tol(coarse)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=tol)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=tol)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_fista_mpc_is_the_two_step_kernel_on_its_g():
    """K2' == K3b on the g K2' emits, and that g == gradient_offset, at the
    bounds of tests/test_kernels.py (rtol 1e-4, atol 1e-5; g 1e-4)."""
    from numpower_tpu_torch.models import gradient_offset

    _, tqp = _qps(10)
    x0s = torch.from_numpy(_inputs(10, warm=False)[0])
    U, g = boxqp_fista.fista_mpc(*_fold(tqp), x0s, -0.5, 0.5, tqp.lipschitz, iters=50)
    U_two = boxqp_fista.fista_boxqp(tqp.H, g, -0.5, 0.5, tqp.lipschitz, iters=50)
    torch.testing.assert_close(U, U_two, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g, gradient_offset(tqp, x0s), rtol=1e-4, atol=1e-4)


def test_admm_mpc_is_the_two_step_kernel_on_its_g():
    """K1' == K3a on the g K1' emits, and that g == gradient_offset, at the
    bounds of tests/test_solvers_extra.py (rtol 1e-4, atol 1e-5)."""
    from numpower_tpu_torch.models import gradient_offset

    _, tqp = _qps(10)
    x0s = torch.from_numpy(np.random.default_rng(17).standard_normal((5, 12)).astype(np.float32))
    rho = torch.sqrt(tqp.lipschitz * tqp.mu)
    z1, y1, g1 = boxqp_admm.admm_mpc(*_fold(tqp), x0s, -0.5, 0.5, rho, iters=50)
    torch.testing.assert_close(g1, gradient_offset(tqp, x0s), rtol=1e-4, atol=1e-5)
    z2, y2 = boxqp_admm.admm_boxqp(tqp.H, g1, -0.5, 0.5, rho, iters=50)
    torch.testing.assert_close(z1, z2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("form", ["s", "zy", "sp"])
def test_admm_forms_match_jax_kernel(qps, form, schedule, box, start):
    """K1 in each loop form against JAX's same form (c "highest" on both)."""
    jqp, tqp = qps
    lo, hi = BOXES[box]
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, start == "warm")
    rho = _rho(jqp)
    z_j, rp_j, rd_j = admm_mpc_pallas_res(
        *_jfold(jqp, x0s, lo, hi), rho, iters=ITERS, coarse_iters=coarse, tile_n=16,
        interpret=True, U0=None if U0 is None else jnp.asarray(U0), form=form,
        c_precision="highest")
    z_t, rp_t, rd_t = boxqp_admm.admm_mpc_res(
        *_fold(tqp), torch.from_numpy(x0s), lo, hi, torch.from_numpy(np.array(rho)),
        iters=ITERS, coarse_iters=coarse, U0=None if U0 is None else torch.from_numpy(U0),
        form=form)
    tol = _tol(coarse)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rp_t), float(rp_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rd_t), float(rd_j), rtol=0, atol=tol)


@pytest.mark.parametrize("form", ["zy", "sp"])
def test_admm_forms_match_the_s_form(form):
    """The forms are one recursion: the same solution and residuals as "s"
    at the mixed schedule, at the bounds of tests/test_kernels.py (rtol
    1e-4, atol 5e-5)."""
    _, tqp = _qps(10)
    x0s = torch.from_numpy((0.3 * np.random.default_rng(3).standard_normal((24, 12)))
                           .astype(np.float32))
    rho = torch.sqrt(tqp.lipschitz * torch.clamp(tqp.mu, min=1e-12))
    args = (*_fold(tqp), x0s, -0.5, 0.5, rho, 40, 20)
    z_s, rp_s, rd_s = boxqp_admm.admm_mpc_res(*args)
    z_f, rp_f, rd_f = boxqp_admm.admm_mpc_res(*args, form=form)
    torch.testing.assert_close(z_f, z_s, rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(float(rp_f), float(rp_s), atol=5e-5)
    np.testing.assert_allclose(float(rd_f), float(rd_s), atol=5e-5)


@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("c_precision", ["bf16x4", "bf16x3", "highest"])
def test_admm_c_precision_matches_jax_kernel(qps, c_precision, schedule):
    jqp, tqp = qps
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, warm=True, seed=1)
    rho = _rho(jqp)
    z_j, rp_j, rd_j = admm_mpc_pallas_res(
        *_jfold(jqp, x0s, -0.5, 0.5), rho, iters=ITERS, coarse_iters=coarse, tile_n=16,
        interpret=True, U0=jnp.asarray(U0), c_precision=c_precision)
    z_t, rp_t, rd_t = boxqp_admm.admm_mpc_res(
        *_fold(tqp), torch.from_numpy(x0s), -0.5, 0.5, torch.from_numpy(np.array(rho)),
        iters=ITERS, coarse_iters=coarse, U0=torch.from_numpy(U0), c_precision=c_precision)
    tol = _tol(coarse)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rp_t), float(rp_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rd_t), float(rd_j), rtol=0, atol=tol)


@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("g_precision", ["highest", "bf16x4", "bf16x3"])
@pytest.mark.parametrize("tail_precision", ["bf16x3", "highest"])
def test_fista_precisions_match_jax_kernel(qps, tail_precision, g_precision, schedule):
    jqp, tqp = qps
    coarse = 0 if schedule == "fp32" else default_coarse_iters(tqp, ITERS)
    x0s, U0 = _inputs(tqp.T, warm=True, seed=2)
    U_j, r_j = fista_mpc_pallas_res(
        *_jfold(jqp, x0s, -0.5, 0.5), jqp.lipschitz, iters=ITERS, coarse_iters=coarse,
        tile_n=16, interpret=True, U0=jnp.asarray(U0), tail_precision=tail_precision,
        g_precision=g_precision)
    U_t, r_t = boxqp_fista.fista_mpc_res(
        *_fold(tqp), torch.from_numpy(x0s), -0.5, 0.5, tqp.lipschitz, iters=ITERS,
        coarse_iters=coarse, U0=torch.from_numpy(U0), tail_precision=tail_precision,
        g_precision=g_precision)
    tol = _tol(coarse)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), rtol=0, atol=tol)
    np.testing.assert_allclose(float(r_t), float(r_j), rtol=0, atol=tol)


def test_wrappers_on_cpu_take_the_plain_version():
    _, tqp = _qps(10)
    x0s, U0 = (torch.from_numpy(a) for a in _inputs(10, warm=True))
    counters = (boxqp_fista.fista_mpc, boxqp_admm.admm_mpc, boxqp_fista.fista_mpc_res,
                boxqp_admm.admm_mpc_res)
    before = [c.launches for c in counters]
    fold = _fold(tqp)
    got = boxqp_fista.fista_mpc(*fold, x0s, -0.5, 0.5, tqp.lipschitz, 20, 10)
    want = boxqp_fista.fista_mpc_reference(*fold, x0s, -0.5, 0.5, tqp.lipschitz, 20, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = boxqp_admm.admm_mpc(*fold, x0s, -0.5, 0.5, 0.2, 20, 10)
    want = boxqp_admm.admm_mpc_reference(*fold, x0s, -0.5, 0.5, 0.2, 20, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kw = dict(tail_precision="bf16x3", g_precision="bf16x4")
    got = boxqp_fista.fista_mpc_res(*fold, x0s, -0.5, 0.5, tqp.lipschitz, 20, 10, U0, **kw)
    want = boxqp_fista.fista_mpc_res_reference(*fold, x0s, -0.5, 0.5, tqp.lipschitz, 20, 10,
                                               U0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kw = dict(U0=U0, form="zy", c_precision="bf16x3")
    got = boxqp_admm.admm_mpc_res(*fold, x0s, -0.5, 0.5, 0.2, 20, 10, **kw)
    want = boxqp_admm.admm_mpc_res_reference(*fold, x0s, -0.5, 0.5, 0.2, 20, 10, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # no kernel ran
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("fn,kw", [
    (boxqp_admm.admm_mpc_res, dict(form="z")),
    (boxqp_admm.admm_mpc_res, dict(c_precision="bf16")),
    (boxqp_fista.fista_mpc_res, dict(tail_precision="bf16x4")),  # not a tail class in JAX
    (boxqp_fista.fista_mpc_res, dict(g_precision="default")),
], ids=["form", "c_precision", "tail_precision", "g_precision"])
def test_unknown_form_or_precision_raises(fn, kw):
    _, tqp = _qps(10)
    x0s = torch.from_numpy(_inputs(10, warm=False)[0])
    with pytest.raises(ValueError):
        fn(*_fold(tqp), x0s, -0.5, 0.5, 0.2, 4, 0, **kw)
