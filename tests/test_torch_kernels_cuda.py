"""The box-QP CUDA kernels of numpower_tpu_torch (K1, K2 and the two-step
K3a, K3b) against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import (
    MPCController, condense, gradient_offset, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
)
from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters

pytestmark = pytest.mark.cuda
ITERS = 40


def _costs():
    return (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
            np.eye(12, dtype=np.float32) * 5.0)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def problem(device):
    A, B = quadrotor12(0.02)
    qp = condense(A, B, *_costs(), 30, device=device)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(0.3 * rng.standard_normal((1000, 12)), dtype=torch.float32,
                          device=device)  # not a multiple of the 32-scenario tile
    U0 = torch.as_tensor(0.8 * rng.standard_normal((1000, 120)), dtype=torch.float32,
                         device=device)
    rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    return qp, x0s, U0, rho


@pytest.mark.parametrize("box", [(-0.5, 0.5), (0.1, 0.5)])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_fista_kernel_matches_plain(problem, schedule, start, box):
    qp, x0s, U0, _ = problem
    U0 = U0 if start == "warm" else None
    coarse = 0 if schedule == "fp32" else default_coarse_iters(qp, ITERS)
    args = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, *box, qp.lipschitz, ITERS, coarse, U0)
    launches = boxqp_fista.fista_mpc_res.launches
    U, r = boxqp_fista.fista_mpc_res(*args)
    torch.cuda.synchronize()
    assert boxqp_fista.fista_mpc_res.launches == launches + 1
    U_ref, r_ref = boxqp_fista.fista_mpc_res_reference(*args)
    assert (U - U_ref).abs().max().item() <= (1e-5 if coarse == 0 else 1e-4)
    assert abs(r.item() - r_ref.item()) <= 1e-5


@pytest.mark.parametrize("box", [(-0.5, 0.5), (0.1, 0.5)])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_admm_kernel_matches_plain(problem, schedule, start, box):
    qp, x0s, U0, rho = problem
    U0 = U0 if start == "warm" else None
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(qp, ITERS)
    args = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, *box, rho, ITERS, coarse)
    launches = boxqp_admm.admm_mpc_res.launches
    z, rp, rd = boxqp_admm.admm_mpc_res(*args, U0=U0)
    torch.cuda.synchronize()
    assert boxqp_admm.admm_mpc_res.launches == launches + 1
    z_ref, rp_ref, rd_ref = boxqp_admm.admm_mpc_res_reference(*args, U0=U0)
    assert (z - z_ref).abs().max().item() <= (1e-5 if coarse == 0 else 1e-4)
    assert abs(rp.item() - rp_ref.item()) <= 1e-5
    assert abs(rd.item() - rd_ref.item()) <= 1e-5


@pytest.mark.parametrize("solver,counter", [("fista", boxqp_fista.fista_mpc_res),
                                            ("admm", boxqp_admm.admm_mpc_res)])
def test_serving_tick_launches_its_kernel_once(device, solver, counter):
    """The first tick runs eagerly (one launch, counted by the wrapper) and
    captures the tick; a replay calls no wrapper. Each tick runs the kernel
    once on the card (torch.profiler's CUDA activity)."""
    from chip_smoke import tick_runs

    kernel = "fista_kernel" if solver == "fista" else "admm_kernel"
    A, B = quadrotor12(0.02)
    ctrl = MPCController(A, B, *_costs(), horizon=30, u_lo=-1, u_hi=1, solver=solver,
                         device=device)
    state = ctrl.init(256)
    x = torch.as_tensor(0.3 * np.random.default_rng(2).standard_normal((256, 12)),
                        dtype=torch.float32, device=device)
    for t in range(3):
        before = counter.launches
        (u0, state, resid), runs = tick_runs(ctrl, state, x, kernel, with_residual=True)
        assert runs == 1
        assert counter.launches == before + (t == 0)
    assert u0.device.type == "cuda" and u0.shape == (256, 4)
    assert bool(((u0 >= -1) & (u0 <= 1)).all()) and bool(torch.isfinite(resid))


def test_wrappers_reject_what_the_kernel_does_not_take(problem):
    qp, x0s, U0, rho = problem
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T)
    with pytest.raises(ValueError, match="float32"):
        boxqp_fista.fista_mpc_res(*fold, x0s.double(), -1, 1, qp.lipschitz)
    with pytest.raises(ValueError, match="contiguous"):
        boxqp_fista.fista_mpc_res(*fold, x0s, -1, 1, qp.lipschitz, U0=U0.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        boxqp_admm.admm_mpc_res(*fold, x0s, -1, 1, rho, U0=U0[:10])
    big = torch.eye(boxqp_fista.MAX_D + 8, device=x0s.device)
    with pytest.raises(ValueError, match="envelope"):
        boxqp_fista.fista_mpc_res(big, qp.Sx.T, torch.zeros(360, big.shape[0],
                                                            device=x0s.device),
                                  x0s, -1, 1, qp.lipschitz)


@pytest.fixture(scope="module")
def tracking_g(problem):
    """g of tracking an x_ref held over the horizon, for the 1000 scenarios."""
    qp, x0s, _, _ = problem
    x_ref = torch.as_tensor(0.2 * np.random.default_rng(5).standard_normal(12),
                            dtype=torch.float32, device=x0s.device)
    return gradient_offset(qp, x0s, x_ref).contiguous(), x_ref


@pytest.mark.parametrize("box", [(-0.5, 0.5), (0.1, 0.5)])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_two_step_kernels_match_plain(problem, tracking_g, schedule, start, box):
    qp, _, U0, rho = problem
    g, _ = tracking_g
    U0 = U0 if start == "warm" else None
    cf = 0 if schedule == "fp32" else default_coarse_iters(qp, ITERS)
    ca = 0 if schedule == "fp32" else admm_coarse_iters(qp, ITERS)
    tol = 1e-5 if schedule == "fp32" else 1e-4
    before = (boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches)
    U = boxqp_fista.fista_boxqp(qp.H, g, *box, qp.lipschitz, ITERS, cf, U0)
    z, y = boxqp_admm.admm_boxqp(qp.H, g, *box, rho, ITERS, ca, U0=U0)
    torch.cuda.synchronize()
    assert (boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches) == \
        (before[0] + 1, before[1] + 1)
    U_ref = boxqp_fista.fista_boxqp_reference(qp.H, g, *box, qp.lipschitz, ITERS, cf, U0)
    z_ref, y_ref = boxqp_admm.admm_boxqp_reference(qp.H, g, *box, rho, ITERS, ca, U0=U0)
    assert (U - U_ref).abs().max().item() <= tol
    assert (z - z_ref).abs().max().item() <= tol
    assert (y - y_ref).abs().max().item() <= tol


def test_x_ref_and_single_x0_solves_run_the_two_step_kernels(problem, tracking_g):
    qp, x0s, _, _ = problem
    _, x_ref = tracking_g
    before = (boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches)
    res = solve_mpc_boxqp(qp, x0s, -1, 1, x_ref=x_ref, iters=ITERS)
    one = solve_mpc_boxqp(qp, x0s[3], -1, 1, iters=ITERS)
    res_a = solve_mpc_boxqp_admm(qp, x0s, -1, 1, x_ref=x_ref, iters=ITERS)
    assert (boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches) == \
        (before[0] + 2, before[1] + 1)
    assert one.U.shape == (120,) and res.U.shape == res_a.U.shape == (1000, 120)
    for r in (res.residual, one.residual, res_a.primal_residual, res_a.dual_residual):
        assert bool(torch.isfinite(r)) and r.item() <= 1e-3
    # the single x0 is the row of the batch's regulation solve
    batch = solve_mpc_boxqp(qp, x0s, -1, 1, iters=ITERS)
    assert (one.U - batch.U[3]).abs().max().item() <= 1e-4


def test_x_ref_serving_tick_launches_k3b_once(device):
    """Each x_ref tick runs K3b once and K2 never (torch.profiler); K3b's
    wrapper counts the first, eager tick's launch, and a replay calls no
    wrapper."""
    from chip_smoke import tick_runs

    A, B = quadrotor12(0.02)
    x_ref = 0.1 * np.ones(12, np.float32)
    ctrl = MPCController(A, B, *_costs(), horizon=30, u_lo=-1, u_hi=1, x_ref=x_ref,
                         device=device)
    state = ctrl.init(256)
    x = torch.as_tensor(0.3 * np.random.default_rng(2).standard_normal((256, 12)),
                        dtype=torch.float32, device=device)
    for t in range(3):
        before = (boxqp_fista.fista_boxqp.launches, boxqp_fista.fista_mpc_res.launches)
        (u0, state, resid), runs = tick_runs(ctrl, state, x, "fista_kernel",
                                             with_residual=True)
        assert runs == 1  # K3b and K2 are both fista_kernel instances
        assert (boxqp_fista.fista_boxqp.launches, boxqp_fista.fista_mpc_res.launches) == \
            (before[0] + (t == 0), before[1])
    assert u0.shape == (256, 4) and bool(((u0 >= -1) & (u0 <= 1)).all())
    assert bool(torch.isfinite(resid))
