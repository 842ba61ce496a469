"""The tensor-core box-QP kernels against their plain PyTorch versions on
the card: K2 (fista_mpc_res) in every tail_precision x g_precision class and
K1 (admm_mpc_res) in every loop form x c_precision class, at N in {1003,
4096} (1003 leaves a ragged 32-scenario tile) and d in {8, 60, 120, 128}
(the quadrotor at horizons 2, 15, 30 and 32: one warpgroup's rows or both,
a part of the last k-step or all eight), cold and warm; then K3a, K3b, K1'
and K2' at the envelope's ends. Tolerances as chip_smoke.py phase 1:
all-fp32 1e-5 (3e-5 for the bf16x3 tail, as phase 17), the default
schedule 1e-4, residuals within 1e-5.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu; run it on the
GPU machine without tests/conftest.py, which imports jax:

    python -m pytest --noconftest tests/test_torch_boxqp_tensorcore_cuda.py -q
"""

import numpy as np
import pytest
import torch

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import condense, quadrotor12
from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters

pytestmark = pytest.mark.cuda
ITERS, LO, HI = 40, -1.0, 1.0
HORIZONS = {8: 2, 60: 15, 120: 30, 128: 32}  # d -> T, with m = 4 controls
K2_CLASSES = [(t, g) for t in boxqp_fista.TAIL_PRECISIONS for g in boxqp_fista.G_PRECISIONS]
K1_VARIANTS = [(f, c) for f in boxqp_admm.FORMS for c in boxqp_admm.C_PRECISIONS]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=sorted(HORIZONS), ids=lambda d: f"d{d}")
def qp(request, device):
    A, B = quadrotor12(0.02)
    return condense(A, B, np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
                    np.eye(12, dtype=np.float32) * 5.0, HORIZONS[request.param], device=device)


def _inputs(qp, N):
    rng = np.random.default_rng(N)
    x0s = torch.as_tensor(0.3 * rng.standard_normal((N, 12)), dtype=torch.float32,
                          device=qp.H.device)
    U0 = torch.as_tensor(0.8 * rng.standard_normal((N, qp.H.shape[0])), dtype=torch.float32,
                         device=qp.H.device)
    return x0s, U0


def _rho(qp):
    return torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("classes", K2_CLASSES, ids=lambda c: f"tail-{c[0]}-g-{c[1]}")
@pytest.mark.parametrize("N", [1003, 4096])
def test_k2_matches_plain(qp, N, classes, start):
    tail, g_prec = classes
    x0s, U0 = _inputs(qp, N)
    U0 = U0 if start == "warm" else None
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, LO, HI, qp.lipschitz, ITERS)
    for coarse, tol in ((0, 3e-5 if tail == "bf16x3" else 1e-5),
                        (default_coarse_iters(qp, ITERS), 1e-4)):
        before = boxqp_fista.fista_mpc_res.launches
        U, r = boxqp_fista.fista_mpc_res(*fold, coarse, U0, tail, g_prec)
        torch.cuda.synchronize()
        assert boxqp_fista.fista_mpc_res.launches == before + 1
        U_ref, r_ref = boxqp_fista.fista_mpc_res_reference(*fold, coarse, U0, tail, g_prec)
        assert _err(U, U_ref) <= tol, (coarse, _err(U, U_ref))
        assert abs(r.item() - r_ref.item()) <= 1e-5


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("variant", K1_VARIANTS, ids=lambda v: f"form-{v[0]}-c-{v[1]}")
@pytest.mark.parametrize("N", [1003, 4096])
def test_k1_matches_plain(qp, N, variant, start):
    form, c_prec = variant
    x0s, U0 = _inputs(qp, N)
    U0 = U0 if start == "warm" else None
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, LO, HI, _rho(qp), ITERS)
    for coarse, tol in ((0, 1e-5), (admm_coarse_iters(qp, ITERS), 1e-4)):
        before = boxqp_admm.admm_mpc_res.launches
        z, rp, rd = boxqp_admm.admm_mpc_res(*fold, coarse, U0=U0, form=form, c_precision=c_prec)
        torch.cuda.synchronize()
        assert boxqp_admm.admm_mpc_res.launches == before + 1
        z_ref, rp_ref, rd_ref = boxqp_admm.admm_mpc_res_reference(
            *fold, coarse, U0=U0, form=form, c_precision=c_prec)
        assert _err(z, z_ref) <= tol, (coarse, _err(z, z_ref))
        assert abs(rp.item() - rp_ref.item()) <= 1e-5
        assert abs(rd.item() - rd_ref.item()) <= 1e-5


@pytest.mark.parametrize("N", [1003, 4096])
def test_two_step_and_g_forming_kernels_match_plain(qp, N):
    """K3b, K3a (warm) and K2', K1' (cold, g within 1e-5 relative) on the
    tensor cores, both schedules."""
    x0s, U0 = _inputs(qp, N)
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, LO, HI)
    g = (x0s @ (qp.Sx.T @ qp.SuTQ.T)).contiguous()
    rho = _rho(qp)
    for cf, ca, tol in ((0, 0, 1e-5),
                        (default_coarse_iters(qp, ITERS), admm_coarse_iters(qp, ITERS), 1e-4)):
        U = boxqp_fista.fista_boxqp(qp.H, g, LO, HI, qp.lipschitz, ITERS, cf, U0)
        U_ref = boxqp_fista.fista_boxqp_reference(qp.H, g, LO, HI, qp.lipschitz, ITERS, cf, U0)
        z, y = boxqp_admm.admm_boxqp(qp.H, g, LO, HI, rho, ITERS, ca, U0=U0)
        z_ref, y_ref = boxqp_admm.admm_boxqp_reference(qp.H, g, LO, HI, rho, ITERS, ca, U0=U0)
        U2, g2 = boxqp_fista.fista_mpc(*fold, qp.lipschitz, ITERS, cf)
        U2_ref, g_ref = boxqp_fista.fista_mpc_reference(*fold, qp.lipschitz, ITERS, cf)
        z1, y1, g1 = boxqp_admm.admm_mpc(*fold, rho, ITERS, ca)
        z1_ref, y1_ref, _ = boxqp_admm.admm_mpc_reference(*fold, rho, ITERS, ca)
        torch.cuda.synchronize()
        for got, want in ((U, U_ref), (z, z_ref), (y, y_ref), (U2, U2_ref), (z1, z1_ref),
                          (y1, y1_ref)):
            assert _err(got, want) <= tol
        scale = g_ref.abs().max().item()
        assert _err(g2, g_ref) <= 1e-5 * scale and _err(g1, g_ref) <= 1e-5 * scale
