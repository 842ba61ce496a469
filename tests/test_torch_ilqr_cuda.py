"""The iLQR CUDA kernels of numpower_tpu_torch (K7 ilqr_backward_fused, K8
ilqr_forward_fused) against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest:

    python -m pytest --noconftest tests/test_torch_ilqr_cuda.py -q

Tolerances: K7 rtol 1e-3, atol 1e-4, the JAX package's bound for its fused
kernel (tests/test_kernels.py:158-163). K8 on the candidates whose plain
rollout stays in |x| <= 10 (the others leave the linearization's region and
diverge, in both versions alike): xs 1e-4, costs rtol 1e-5 (the JAX
package's, tests/test_kernels.py:577-582), us 5e-4 (gains up to |K| ~ 100
turn a 5e-6 state difference into 5e-4). N = 1, 31, 33, 257 and 1003 are
ragged for K7's 32-scenario (n <= 4) and 16- or 8-scenario blocks and K8's
32-scenario blocks. Past n = 16 or m = 8 K7 runs its wide form
(csrc/ilqr_backward_wide.cu), its working set in shared memory or, at
(128, 64), in a device workspace.
"""

import functools

import numpy as np
import pytest
import torch

from numpower_tpu_torch.kernels import ilqr_backward, ilqr_forward
from numpower_tpu_torch.models import (
    cartpole_step, ilqr_solve_batched, pendulum_step, planar_quadrotor_step, rollout_nonlinear,
    linearize_trajectory, unicycle_step,
)

pytestmark = pytest.mark.cuda
ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03, 0.01)
PLANTS = [(cartpole_step, 4, 1), (pendulum_step, 2, 1), (unicycle_step, 3, 2),
          (planar_quadrotor_step, 6, 2)]
# The nominal control of each plant's test problem: the planar quadrotor
# hovers (m g / 2 per rotor), for with zero thrust it falls out of the
# bounded region within the horizon.
U_NOM = {planar_quadrotor_step: 0.5 * 9.81}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ltv(N, T, n, m, device, seed):
    """A random LTV problem: A near I, small B, affine terms, stage costs."""
    rng = np.random.default_rng(seed)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=device)
    return (f32(np.eye(n) + 0.05 * rng.standard_normal((N, T, n, n))),
            f32(0.3 * rng.standard_normal((N, T, n, m))), f32(rng.standard_normal((N, T, n))),
            f32(rng.standard_normal((N, T, m))), 2.0 * np.eye(n, dtype=np.float32),
            0.2 * np.eye(m, dtype=np.float32), f32(rng.standard_normal((N, n))),
            10.0 * np.eye(n, dtype=np.float32))


# (n, m, T, N): the configurations' shapes at N = 1003, then each edge of the
# two forms (thread per scenario for n <= 4, lane per row above; the m buckets
# 1, 2, 4, 8) at T = 1, at T off the thread form's chunk (5 stages at n = 4,
# m = 1; 12 at n = 2) and past its ring of three chunks, and at N ragged
# against 32-scenario blocks (1, 31, 33, 257)
BACKWARD_CASES = {
    "cartpole": (4, 1, 50, 1003), "quadrotor": (12, 4, 30, 1003), "planar": (6, 2, 20, 1003),
    "envelope": (16, 8, 10, 1003), "unicycle": (3, 2, 7, 1003),
    "n2-m1-T40-N257": (2, 1, 40, 257), "n2-m8-T1-N33": (2, 8, 1, 33),
    "n4-m1-T1-N1": (4, 1, 1, 1), "n4-m1-T17-N31": (4, 1, 17, 31),
    "n4-m2-T64-N33": (4, 2, 64, 33), "n4-m8-T9-N257": (4, 8, 9, 257),
    "n1-m1-T23-N33": (1, 1, 23, 33), "n5-m1-T1-N31": (5, 1, 1, 31),
    "n5-m8-T13-N257": (5, 8, 13, 257), "n8-m2-T37-N1": (8, 2, 37, 1),
    "n8-m8-T5-N33": (8, 8, 5, 33), "n12-m1-T19-N257": (12, 1, 19, 257),
    "n16-m2-T1-N31": (16, 2, 1, 31), "n16-m1-T26-N33": (16, 1, 26, 33),
    # past the narrow envelope, the wide form (csrc/ilqr_backward_wide.cu):
    # chip_smoke.py phase 29's edges, the eight-quadrotor formation's shape
    # at a ragged N, (96, 48) and (100, 32) in one shared-memory stage buffer
    # (the block's factor and the warp's inverse), and (128, 64) past the
    # shared-memory form (a workspace)
    "wide-n17-m1": (17, 1, 8, 1003), "wide-n16-m9": (16, 9, 8, 1003),
    "wide-n4-m12": (4, 12, 8, 1003), "wide-n48-m48": (48, 48, 8, 257),
    "wide-n64-m32": (64, 32, 8, 257), "wide-formation-n48-m16": (48, 16, 10, 1003),
    "wide-n1-m9-T1-N1": (1, 9, 1, 1), "wide-depth1-n96-m48": (96, 48, 5, 257),
    "wide-depth1-n100-m32": (100, 32, 5, 257), "wide-workspace-n128-m64": (128, 64, 4, 64),
}
# the wide form each wide case takes (ilqr_backward._wide_depth): 2 or 1
# stage buffers in shared memory, 0 a workspace
WIDE_DEPTHS = {(17, 1): 2, (16, 9): 2, (4, 12): 2, (48, 48): 2, (64, 32): 2, (48, 16): 2,
               (1, 9): 2, (96, 48): 1, (100, 32): 1, (128, 64): 0}


@pytest.mark.parametrize("n,m,T,N", list(BACKWARD_CASES.values()), ids=list(BACKWARD_CASES))
@pytest.mark.parametrize("diag", [False, True], ids=["plain", "luu_diags"])
def test_backward_kernel_matches_plain(device, n, m, T, N, diag):
    args = _ltv(N, T, n, m, device, seed=n * 10 + m)
    luu_diags = None
    if diag:
        luu_diags = torch.as_tensor(np.random.default_rng(7).uniform(0.0, 2.0, (N, T, m)),
                                    dtype=torch.float32, device=device)
    before = ilqr_backward.ilqr_backward_fused.launches
    ks, Ks = ilqr_backward.ilqr_backward_fused(*args, reg=1e-3, luu_diags=luu_diags)
    torch.cuda.synchronize()
    assert ilqr_backward.ilqr_backward_fused.launches == before + 1
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*args, reg=1e-3, luu_diags=luu_diags)
    assert torch.allclose(ks, ks_p, rtol=1e-3, atol=1e-4)
    assert torch.allclose(Ks, Ks_p, rtol=1e-3, atol=1e-4)


def test_wide_cases_cover_every_wide_form(device):
    """BACKWARD_CASES reach both stage depths of the shared-memory form and
    the workspace form."""
    got = {nm: ilqr_backward._wide_depth(device.index, *nm) for nm in WIDE_DEPTHS}
    assert got == WIDE_DEPTHS
    assert ilqr_backward._wide_depth(device.index, 16, 8) == -1


def _shifted(t, shift):
    """A copy of t that starts `shift` floats into a fresh buffer: 4 * shift
    bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_backward_kernel_reads_runs_at_any_alignment(device, shift):
    """Operands that start 4, 8 or 12 bytes past a 16-byte boundary: the
    16-byte copies stage the aligned span around each run."""
    N, T, n, m = 33, 13, 4, 1
    args = list(_ltv(N, T, n, m, device, seed=5))
    diag = torch.as_tensor(np.random.default_rng(6).uniform(0.0, 2.0, (N, T, m)),
                           dtype=torch.float32, device=device)
    moved = [_shifted(args[i], shift) for i in (0, 1, 2, 3)]
    assert all(t.data_ptr() % 16 == 4 * shift % 16 for t in moved)
    ks, Ks = ilqr_backward.ilqr_backward_fused(*moved, *args[4:], luu_diags=_shifted(diag, shift))
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*args, luu_diags=diag)
    assert torch.allclose(ks, ks_p, rtol=1e-3, atol=1e-4)
    assert torch.allclose(Ks, Ks_p, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_wide_backward_kernel_reads_operands_at_any_alignment(device, shift):
    """The wide form's element copies at operands 4, 8 or 12 bytes past a
    16-byte boundary."""
    N, T, n, m = 33, 6, 20, 9
    args = list(_ltv(N, T, n, m, device, seed=9))
    diag = torch.as_tensor(np.random.default_rng(6).uniform(0.0, 2.0, (N, T, m)),
                           dtype=torch.float32, device=device)
    moved = [_shifted(args[i], shift) for i in (0, 1, 2, 3, 6)]
    ks, Ks = ilqr_backward.ilqr_backward_fused(*moved[:4], *args[4:6], moved[4], args[7],
                                               luu_diags=_shifted(diag, shift))
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*args, luu_diags=diag)
    assert torch.allclose(ks, ks_p, rtol=1e-3, atol=1e-4)
    assert torch.allclose(Ks, Ks_p, rtol=1e-3, atol=1e-4)


def test_backward_kernel_rejects_what_it_does_not_take(device):
    # n = 17 is past the narrow envelope: the wide form launches, as the JAX
    # kernel takes any size
    args = _ltv(4, 3, 17, 1, device, seed=1)
    before = ilqr_backward.ilqr_backward_fused.launches
    ks, Ks = ilqr_backward.ilqr_backward_fused(*args)
    assert ilqr_backward.ilqr_backward_fused.launches == before + 1
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*args)
    assert torch.allclose(ks, ks_p, rtol=1e-3, atol=1e-4)
    assert torch.allclose(Ks, Ks_p, rtol=1e-3, atol=1e-4)
    args = _ltv(4, 3, 4, 1, device, seed=1)
    with pytest.raises(ValueError, match="float32"):
        ilqr_backward.ilqr_backward_fused(args[0].double(), *args[1:])


def _line_search_problem(f, n, m, N, T, device):
    """The first line search of a solve from x0 = 0.3 N(0, 1) and constant
    nominal controls (U_NOM, else zero): its rollout, FD linearization and
    plain backward pass."""
    x0s = torch.as_tensor(0.3 * np.random.default_rng(n).standard_normal((N, n)),
                          dtype=torch.float32, device=device)
    us = torch.full((N, T, m), U_NOM.get(f, 0.0), dtype=torch.float32, device=device)
    xs = rollout_nonlinear(f, x0s, us)
    As, Bs = linearize_trajectory(f, xs, us, use_fd=True)
    Q, R, QF = (torch.eye(n, device=device), 0.1 * torch.eye(m, device=device),
                10.0 * torch.eye(n, device=device))
    goal = torch.zeros(n, device=device)
    ks, Ks = ilqr_backward.ilqr_backward_reference(
        As, Bs, 2.0 * (xs[:, :T] - goal) @ Q.T, 2.0 * us @ R.T, 2.0 * Q, 2.0 * R,
        2.0 * (xs[:, T] - goal) @ QF.T, 2.0 * QF)
    alphas = torch.tensor(ALPHAS, device=device)
    return (f, Q, R, QF, goal, alphas, x0s, xs.contiguous(), us, ks, Ks)


@pytest.mark.parametrize("f,n,m", PLANTS, ids=[f.__name__ for f, _, _ in PLANTS])
def test_forward_kernel_matches_plain_on_every_registered_plant(device, f, n, m):
    args = _line_search_problem(f, n, m, 257, 40, device)
    before = ilqr_forward.ilqr_forward_fused.launches
    us, xs, costs = ilqr_forward.ilqr_forward_fused(*args)
    torch.cuda.synchronize()
    assert ilqr_forward.ilqr_forward_fused.launches == before + 1
    assert us.shape == (6, 257, 40, m) and xs.shape == (6, 257, 41, n) and costs.shape == (6, 257)
    us_p, xs_p, c_p = ilqr_forward.ilqr_forward_reference(*args)
    ok = torch.isfinite(c_p) & (xs_p.abs().amax(dim=(-2, -1)) <= 10.0)
    assert ok.double().mean().item() >= 0.4
    assert (us[ok] - us_p[ok]).abs().max().item() <= 5e-4
    assert (xs[ok] - xs_p[ok]).abs().max().item() <= 1e-4
    assert ((costs[ok] - c_p[ok]).abs() / c_p[ok].abs()).max().item() <= 1e-5
    assert torch.equal(xs[:, :, 0], args[6].expand(6, 257, n))


def _check_forward(args, A, N, T, n, m):
    us, xs, costs = ilqr_forward.ilqr_forward_fused(*args)
    torch.cuda.synchronize()
    assert us.shape == (A, N, T, m) and xs.shape == (A, N, T + 1, n) and costs.shape == (A, N)
    us_p, xs_p, c_p = ilqr_forward.ilqr_forward_reference(*args)
    ok = torch.isfinite(c_p) & (xs_p.abs().amax(dim=(-2, -1)) <= 10.0)
    assert ok.double().mean().item() >= 0.4
    assert (us[ok] - us_p[ok]).abs().max().item() <= 5e-4
    assert (xs[ok] - xs_p[ok]).abs().max().item() <= 1e-4
    assert ((costs[ok] - c_p[ok]).abs() / c_p[ok].abs()).max().item() <= 1e-5
    assert torch.equal(xs[:, :, 0], args[6].expand(A, N, n))


# alpha counts 1, 6 (two blocks of three warps) and 32 (eight blocks of four);
# T = 1, T = 9 across the cartpole's 8-step chunk, T = 50 past its ring of
# three chunks; N ragged against 32-scenario blocks
@pytest.mark.parametrize("A", [1, 6, 32])
@pytest.mark.parametrize("T,N", [(1, 33), (9, 31), (50, 257)], ids=["T1-N33", "T9-N31", "T50-N257"])
def test_forward_kernel_alpha_counts_and_chunks(device, A, T, N):
    args = list(_line_search_problem(cartpole_step, 4, 1, N, T, device))
    args[5] = torch.tensor(np.geomspace(0.1, 1e-3, A) if A > 1 else [0.05],
                           dtype=torch.float32, device=device)
    _check_forward(args, A, N, T, 4, 1)


@pytest.mark.parametrize("shift", [1, 3])
def test_forward_kernel_reads_runs_at_any_alignment(device, shift):
    N, T = 33, 20
    args = list(_line_search_problem(pendulum_step, 2, 1, N, T, device))
    for i in (7, 8, 9, 10):  # xs_nom, us_nom, ks, Ks
        args[i] = _shifted(args[i], shift)
    _check_forward(args, 6, N, T, 2, 1)


def test_partial_plant_carries_its_parameters_into_the_kernel(device):
    f = functools.partial(cartpole_step, dt=0.02, mp=0.2)
    args = _line_search_problem(f, 4, 1, 64, 30, device)
    us, xs, costs = ilqr_forward.ilqr_forward_fused(*args)
    us_p, xs_p, c_p = ilqr_forward.ilqr_forward_reference(*args)
    ok = torch.isfinite(c_p) & (xs_p.abs().amax(dim=(-2, -1)) <= 10.0)
    assert ok.any() and (xs[ok] - xs_p[ok]).abs().max().item() <= 1e-4
    assert ((costs[ok] - c_p[ok]).abs() / c_p[ok].abs()).max().item() <= 1e-5


def test_unregistered_plant_on_the_kernel_route_raises(device):
    x0s = torch.zeros((8, 2), device=device)
    Q, R = np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32)

    def my_pendulum(x, u):
        return pendulum_step(x, u)

    with pytest.raises(ValueError, match="not registered"):
        ilqr_solve_batched(my_pendulum, x0s, Q, R, Q, np.zeros(2, np.float32), 5, iters=1,
                           backend="fused")
    r = ilqr_solve_batched(my_pendulum, x0s, Q, R, Q, np.zeros(2, np.float32), 5, iters=1,
                           backend="fused", forward="plain")
    assert r.us.device.type == "cuda" and bool(torch.isfinite(r.cost).all())


def test_fused_solve_launches_each_kernel_once_per_iteration(device):
    x0s = torch.as_tensor(0.3 * np.random.default_rng(1).standard_normal((300, 4)),
                          dtype=torch.float32, device=device)
    Q, R, QF = np.eye(4, dtype=np.float32), 0.01 * np.eye(1, dtype=np.float32), \
        10.0 * np.eye(4, dtype=np.float32)
    before = (ilqr_backward.ilqr_backward_fused.launches, ilqr_forward.ilqr_forward_fused.launches)
    r = ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, np.zeros(4, np.float32), 15, iters=4,
                           backend="fused")
    assert (ilqr_backward.ilqr_backward_fused.launches,
            ilqr_forward.ilqr_forward_fused.launches) == (before[0] + 4, before[1] + 4)
    v = ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, np.zeros(4, np.float32), 15, iters=4)
    # the JAX package's cross-backend bound on its test problem (tests/test_kernels.py:176)
    assert torch.allclose(r.cost, v.cost, rtol=1e-2, atol=1e-3)
    assert bool((r.costs[:, 1:] <= r.costs[:, :-1]).all())
