"""MPCController's captured serving tick and the JAX-named box-QP
functions, on the card.

Every test here needs a CUDA device and skips without one (the tick is
captured as a CUDA graph only there). The file imports neither jax nor
numpower_tpu, so it runs on the GPU machine, where jax is absent;
tests/conftest.py imports jax, so run it there without the conftest:

    python -m pytest --noconftest tests/test_torch_controller_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import tick_runs
from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import MPCController, MPCState, quadrotor12, solve_mpc_boxqp

pytestmark = pytest.mark.cuda
N = 1000  # not a multiple of the kernels' 32-scenario tile


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tick is captured only on the card")
    return torch.device("cuda", 0)


def _controller(device, **kw):
    A, B = quadrotor12(0.02)
    costs = (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
             np.eye(12, dtype=np.float32) * 5.0)
    return MPCController(A, B, *costs, 30, -1.0, 1.0, iters=30, device=device, **kw)


def _x0s(device, seed=0, n=N):
    return torch.as_tensor(0.3 * np.random.default_rng(seed).standard_normal((n, 12)),
                           dtype=torch.float32, device=device)


@pytest.mark.parametrize("kw", [{"solver": "fista"}, {"solver": "admm"},
                                {"x_ref": 0.2 * np.ones(12, np.float32)}],
                         ids=["fista", "admm", "x_ref"])
def test_captured_tick_is_the_eager_tick(device, kw):
    """Every tick bit for bit the eager _step_impl from the same state; the
    plan stays in the passed buffer; one graph a batch size."""
    ctrl = _controller(device, **kw)
    state, x = ctrl.init(N), _x0s(device)
    ptr = state.U_prev.data_ptr()
    for _ in range(5):
        twin = MPCState(U_prev=state.U_prev.clone(), tick=state.tick)
        u0, state, resid = ctrl.step_with_residual(state, x)
        u_e, eager, r_e = ctrl._step_impl(ctrl.qp, twin, x)
        assert torch.equal(u0, u_e) and torch.equal(state.U_prev, eager.U_prev)
        assert torch.equal(resid, r_e)
        assert state.U_prev.data_ptr() == ptr
        x = 0.9 * x
    assert ctrl.compile_cache_size() == 1
    ctrl.step(ctrl.init(64), x[:64])
    assert ctrl.compile_cache_size() == 2


def test_captured_tick_is_the_public_tick(device):
    """The tick with its folds formed once equals the public solve on the
    shifted plan, bit for bit."""
    ctrl = _controller(device)
    state, x = ctrl.init(N), _x0s(device)
    for _ in range(3):
        U_shift = torch.cat([state.U_prev[:, 4:], state.U_prev[:, -4:]], dim=1)
        want = solve_mpc_boxqp(ctrl.qp, x, -1.0, 1.0, iters=30, U0=U_shift,
                               coarse_iters=ctrl.coarse_iters)
        u0, state = ctrl.step(state, x)
        assert torch.equal(u0, want.U[:, :4]) and torch.equal(state.U_prev, want.U)


def test_fleets_and_launch_counters(device):
    """A second fleet and a restored plan on one controller: each equal to
    its eager twin, the graph's own fleet untouched by them. K2's wrapper
    counts the first tick's eager launch and none on a replay, which runs
    K2 once on the card."""
    ctrl = _controller(device)
    mine, other = ctrl.init(N), ctrl.init(N)
    restored = MPCState(U_prev=torch.rand(N, 120, device=device) - 0.5, tick=7)
    x = _x0s(device)
    counter = boxqp_fista.fista_mpc_res
    for t in range(3):
        for name in ("mine", "other", "restored"):
            st = {"mine": mine, "other": other, "restored": restored}[name]
            twin = MPCState(U_prev=st.U_prev.clone(), tick=st.tick)
            before = counter.launches
            (u0, new), runs = tick_runs(ctrl, st, x, "fista_kernel")
            first = t == 0 and name == "mine"
            assert counter.launches == before + first
            assert runs == 1
            u_e, eager, _ = ctrl._step_impl(ctrl.qp, twin, x)
            assert torch.equal(u0, u_e) and torch.equal(new.U_prev, eager.U_prev), name
            assert new.U_prev.data_ptr() == st.U_prev.data_ptr()
            mine, other, restored = (new if n == name else s for n, s in
                                     (("mine", mine), ("other", other), ("restored", restored)))
    assert ctrl.compile_cache_size() == 1


@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_reassigned_qp_is_captured_again(device, solver):
    """After ``ctrl.qp = <another QP>`` the next tick is captured on the new
    QP: it and the replays after it equal a controller built on that QP
    (the same coarse schedule) bit for bit."""
    A, B = quadrotor12(0.02)
    costs = (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.2,
             np.eye(12, dtype=np.float32) * 5.0)
    ctrl = _controller(device, solver=solver)
    fresh = MPCController(A, B, *costs, 30, -1.0, 1.0, iters=30, device=device, solver=solver,
                          coarse_iters=ctrl.coarse_iters)
    state, x = ctrl.init(N), _x0s(device)
    for _ in range(2):
        _, state = ctrl.step(state, x)
    ctrl.qp = fresh.qp.replace()
    twin = fresh.init(N)
    twin.U_prev.copy_(state.U_prev)
    for _ in range(3):
        u0, state = ctrl.step(state, x)
        u_f, twin = fresh.step(twin, x)
        assert torch.equal(u0, u_f) and torch.equal(state.U_prev, twin.U_prev)
    assert ctrl.compile_cache_size() == 1


def test_jax_named_box_qp_functions_on_the_card(device):
    """The JAX names launch the port's kernels and return their results."""
    ctrl = _controller(device)
    qp, x = ctrl.qp, _x0s(device)
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T)
    rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    for alias, port, args in (
            (boxqp_fista.fista_mpc_pallas_res, boxqp_fista.fista_mpc_res,
             (*fold, x, -1.0, 1.0, qp.lipschitz, 20)),
            (boxqp_fista.fista_mpc_pallas, boxqp_fista.fista_mpc,
             (*fold, x, -1.0, 1.0, qp.lipschitz, 20)),
            (boxqp_admm.admm_mpc_pallas_res, boxqp_admm.admm_mpc_res,
             (*fold, x, -1.0, 1.0, rho, 20)),
            (boxqp_admm.admm_mpc_pallas, boxqp_admm.admm_mpc, (*fold, x, -1.0, 1.0, rho, 20))):
        before = port.launches
        got, want = alias(*args, tile_n=16, interpret=True), port(*args)
        assert port.launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, want)), alias.__name__
