"""K1' (admm_mpc), K2' (fista_mpc), K1's loop forms and the precision
classes of K1 and K2 against their plain PyTorch versions on the card, and
the data-parallel solvers and MPCController(mesh=...) on a one-rank NCCL
group.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu; run it on the
GPU machine without tests/conftest.py, which imports jax:

    python -m pytest --noconftest tests/test_torch_boxqp_variants_cuda.py -q
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import MPCController, condense, quadrotor12
from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters
from numpower_tpu_torch.parallel import (
    make_mesh, shard_batch, solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp,
)

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


def _err(a, b):
    return (a - b).abs().max().item()


@pytest.mark.parametrize("box", [(-0.5, 0.5), (0.1, 0.5)])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
def test_g_forming_kernels_match_plain(problem, schedule, box):
    """K2' (U, g) and K1' (z, y, g) against their plain versions; g within
    1e-5 relative."""
    qp, x0s, _, rho = problem
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, *box)
    cf = 0 if schedule == "fp32" else default_coarse_iters(qp, ITERS)
    ca = 0 if schedule == "fp32" else admm_coarse_iters(qp, ITERS)
    tol = 1e-5 if schedule == "fp32" else 1e-4
    before = (boxqp_fista.fista_mpc.launches, boxqp_admm.admm_mpc.launches)
    U, g = boxqp_fista.fista_mpc(*fold, qp.lipschitz, ITERS, cf)
    z, y, g_a = boxqp_admm.admm_mpc(*fold, rho, ITERS, ca)
    torch.cuda.synchronize()
    assert (boxqp_fista.fista_mpc.launches, boxqp_admm.admm_mpc.launches) == \
        (before[0] + 1, before[1] + 1)
    U_ref, g_ref = boxqp_fista.fista_mpc_reference(*fold, qp.lipschitz, ITERS, cf)
    z_ref, y_ref, _ = boxqp_admm.admm_mpc_reference(*fold, rho, ITERS, ca)
    assert _err(U, U_ref) <= tol and _err(z, z_ref) <= tol and _err(y, y_ref) <= tol
    scale = g_ref.abs().max().item()
    assert _err(g, g_ref) <= 1e-5 * scale and _err(g_a, g_ref) <= 1e-5 * scale


def test_g_forming_kernels_are_the_two_step_kernels_on_their_g(problem):
    qp, x0s, _, rho = problem
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, -0.5, 0.5)
    U, g = boxqp_fista.fista_mpc(*fold, qp.lipschitz, ITERS)
    assert _err(U, boxqp_fista.fista_boxqp(qp.H, g, -0.5, 0.5, qp.lipschitz, ITERS)) <= 1e-5
    z, y, g_a = boxqp_admm.admm_mpc(*fold, rho, ITERS)
    z2, y2 = boxqp_admm.admm_boxqp(qp.H, g_a, -0.5, 0.5, rho, ITERS)
    assert _err(z, z2) <= 1e-5 and _err(y, y2) <= 1e-5


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("form", ["zy", "sp"])
def test_admm_forms_match_plain(problem, form, schedule, start):
    qp, x0s, U0, rho = problem
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(qp, ITERS)
    args = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, -0.5, 0.5, rho, ITERS, coarse)
    kw = dict(U0=U0 if start == "warm" else None, form=form)
    z, rp, rd = boxqp_admm.admm_mpc_res(*args, **kw)
    z_ref, rp_ref, rd_ref = boxqp_admm.admm_mpc_res_reference(*args, **kw)
    assert _err(z, z_ref) <= (1e-5 if coarse == 0 else 1e-4)
    assert abs(rp.item() - rp_ref.item()) <= 1e-5 and abs(rd.item() - rd_ref.item()) <= 1e-5


@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("c_precision", ["bf16x4", "bf16x3"])
def test_admm_c_precision_matches_plain(problem, c_precision, schedule):
    qp, x0s, U0, rho = problem
    coarse = 0 if schedule == "fp32" else admm_coarse_iters(qp, ITERS)
    args = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, -0.5, 0.5, rho, ITERS, coarse)
    kw = dict(U0=U0, c_precision=c_precision)
    z, rp, rd = boxqp_admm.admm_mpc_res(*args, **kw)
    z_ref, rp_ref, rd_ref = boxqp_admm.admm_mpc_res_reference(*args, **kw)
    assert _err(z, z_ref) <= (1e-5 if coarse == 0 else 1e-4)
    assert abs(rp.item() - rp_ref.item()) <= 1e-5 and abs(rd.item() - rd_ref.item()) <= 1e-5


@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("g_precision", ["highest", "bf16x4", "bf16x3"])
@pytest.mark.parametrize("tail_precision", ["bf16x3", "highest"])
def test_fista_precisions_match_plain(problem, tail_precision, g_precision, schedule):
    qp, x0s, U0, _ = problem
    coarse = 0 if schedule == "fp32" else default_coarse_iters(qp, ITERS)
    args = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, -0.5, 0.5, qp.lipschitz, ITERS, coarse, U0)
    kw = dict(tail_precision=tail_precision, g_precision=g_precision)
    U, r = boxqp_fista.fista_mpc_res(*args, **kw)
    U_ref, r_ref = boxqp_fista.fista_mpc_res_reference(*args, **kw)
    # bf16x3 drops lo*lo, which moves with the hi/lo split of operands one ulp
    # apart: two fp32 implementations of the class part by ~1e-5 (chip_smoke.py)
    fp32_tol = 3e-5 if tail_precision == "bf16x3" else 1e-5
    assert _err(U, U_ref) <= (fp32_tol if coarse == 0 else 1e-4)
    assert abs(r.item() - r_ref.item()) <= 1e-5


def test_g_forming_kernels_refuse_wide_d(problem):
    qp, x0s, _, rho = problem
    big = torch.eye(boxqp_fista.MAX_D + 8, device=x0s.device)
    wide = torch.zeros(360, big.shape[0], device=x0s.device)
    with pytest.raises(ValueError, match="envelope"):
        boxqp_fista.fista_mpc(big, qp.Sx.T, wide, x0s, -1, 1, qp.lipschitz)
    with pytest.raises(ValueError, match="envelope"):
        boxqp_admm.admm_mpc(big, qp.Sx.T, wide, x0s, -1, 1, rho)


@pytest.fixture(scope="module")
def nccl_mesh(device, tmp_path_factory):
    """A one-rank NCCL group over a FileStore, and its (1, 1) mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield make_mesh((1, 1))
    dist.destroy_process_group()


def test_dp_solvers_launch_their_kernels_on_a_cuda_mesh(problem, nccl_mesh):
    qp, x0s, U0, rho = problem
    x_block = shard_batch(x0s, nccl_mesh)
    before = (boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches)
    r_f = solve_mpc_boxqp_dp(qp, x_block, -1.0, 1.0, nccl_mesh, ITERS)
    r_a = solve_mpc_boxqp_admm_dp(qp, x_block, -1.0, 1.0, nccl_mesh, iters=ITERS)
    assert (boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches) == \
        (before[0] + 1, before[1] + 1)
    U, resid = boxqp_fista.fista_mpc_res(qp.H, qp.Sx.T, qp.SuTQ.T, x0s, -1.0, 1.0,
                                         qp.lipschitz, ITERS, default_coarse_iters(qp, ITERS))
    assert _err(r_f.U, U) <= 1e-5 and abs(r_f.residual.item() - resid.item()) <= 1e-5
    assert _err(r_a.U, r_f.U) <= 2e-3


@pytest.mark.parametrize("solver,counter", [("fista", boxqp_fista.fista_mpc_res),
                                            ("admm", boxqp_admm.admm_mpc_res)])
def test_mesh_controller_ticks_launch_once_and_match_one_device(nccl_mesh, solver, counter):
    A, B = quadrotor12(0.02)
    kw = dict(horizon=30, u_lo=-1, u_hi=1, solver=solver)
    ctrl_m = MPCController(A, B, *_costs(), mesh=nccl_mesh, **kw)
    ctrl_1 = MPCController(A, B, *_costs(), device=nccl_mesh.device, **kw)
    x = torch.as_tensor(0.3 * np.random.default_rng(2).standard_normal((256, 12)),
                        dtype=torch.float32, device=nccl_mesh.device)
    sm, s1 = ctrl_m.init(256), ctrl_1.init(256)
    for _ in range(3):
        before = counter.launches
        um, sm = ctrl_m.step(sm, x)
        assert counter.launches == before + 1
        u1, s1 = ctrl_1.step(s1, x)
        assert _err(um, u1) <= 1e-5
