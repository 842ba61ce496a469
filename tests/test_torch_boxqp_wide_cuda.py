"""The box-QP kernels on the wide tile (128 < d <= 1024: a cluster of
ceil(d / 128) blocks, csrc/boxqp_tile.cuh) against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so run it on the
GPU machine without the conftest:

    python -m pytest --noconftest tests/test_torch_boxqp_wide_cuda.py -q

The QPs of the kernel tests are synthetic and well conditioned (H's
eigenvalues in [1, 20], |g| ~ 1), so that the bounds of the narrow instances
hold at every d (all-fp32 1e-5, a 20-iteration coarse phase 1e-4, residuals
1e-5, g 1e-5 of its size): on the quadrotor past T = 32 the condition number
grows to 783 at T = 100 and fp32 itself moves the solution by ~1e-4
(chip_smoke.py phase 27 holds the kernels there against that floor). The
serving tests run the quadrotor at T = 100.
"""

import numpy as np
import pytest
import torch

from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import MPCController, MPCState, quadrotor12

pytestmark = pytest.mark.cuda
ITERS, N_FOLD, N_STATE = 40, 24, 12
WIDTHS = (129, 200, 256, 400, 1000, 1024)
BATCHES = (1, 37, 4096)


def _costs():
    return (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
            np.eye(12, dtype=np.float32) * 5.0)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


_PROBLEMS = {}


def _problem(d, device):
    """A seeded QP of width d: H = V diag(1..20) V', Sx' (12, 24), (Su'Q)'
    (24, d) scaled so that |g| ~ 1; 4096 x0s, a warm start and g."""
    if d not in _PROBLEMS:
        rng = np.random.default_rng(d)
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        H = (V * np.linspace(1.0, 20.0, d)) @ V.T
        t = {"H": 0.5 * (H + H.T),
             "SxT": rng.standard_normal((N_STATE, N_FOLD)) / np.sqrt(N_FOLD),
             "SuTQT": rng.standard_normal((N_FOLD, d)) / np.sqrt(N_STATE),
             "x0s": 0.3 * rng.standard_normal((4096, N_STATE)),
             "U0": 0.8 * rng.standard_normal((4096, d))}
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in t.items()}
        t["U0"] = t["U0"].clamp(-0.5, 0.5)
        t["lip"] = torch.linalg.eigvalsh(t["H"].double()).max().float()
        t["rho"] = torch.sqrt(t["lip"] * 1.0)
        t["g"] = (t["x0s"] @ (t["SxT"] @ t["SuTQT"])).contiguous()
        _PROBLEMS[d] = t
    return _PROBLEMS[d]


def _run(name, p, N, coarse, warm, kernel=True, **kw):
    """Kernel `name` (or its plain version) on the first N scenarios."""
    fold = (p["H"], p["SxT"], p["SuTQT"])
    x0s, U0, g = p["x0s"][:N], (p["U0"][:N] if warm else None), p["g"][:N]
    mod = boxqp_fista if name.startswith("fista") else boxqp_admm
    fn = getattr(mod, name if kernel else f"{name}_reference")
    if name == "fista_mpc_res":
        return fn(*fold, x0s, -0.5, 0.5, p["lip"], ITERS, coarse, U0, **kw)
    if name == "admm_mpc_res":
        return fn(*fold, x0s, -0.5, 0.5, p["rho"], ITERS, coarse, U0=U0, **kw)
    if name == "fista_boxqp":
        return (fn(p["H"], g, -0.5, 0.5, p["lip"], ITERS, coarse, U0),)
    if name == "admm_boxqp":
        return fn(p["H"], g, -0.5, 0.5, p["rho"], ITERS, coarse, U0=U0)
    if name == "fista_mpc":
        return fn(*fold, x0s, -0.5, 0.5, p["lip"], ITERS, coarse)
    return fn(*fold, x0s, -0.5, 0.5, p["rho"], ITERS, coarse)


def _assert_matches_plain(name, p, N, coarse, warm, **kw):
    counter = getattr(boxqp_fista if name.startswith("fista") else boxqp_admm, name)
    before = counter.launches
    got = _run(name, p, N, coarse, warm, **kw)
    assert counter.launches == before + 1
    want = _run(name, p, N, coarse, warm, kernel=False, **kw)
    tol = 1e-5 if coarse == 0 else 1e-4
    if kw.get("tail_precision") == "bf16x3":
        tol = max(tol, 3e-5)  # the bf16x3 tail's all-fp32 bound (chip_smoke.py phase 17)
    if name in ("fista_mpc", "admm_mpc"):  # g last, within 1e-5 of its size
        scale = want[-1].abs().max().item()
        torch.testing.assert_close(got[-1], want[-1], rtol=0, atol=1e-5 * scale)
        got, want = got[:-1], want[:-1]
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.shape == b.shape
        if a.ndim:
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
        else:
            assert abs(a.item() - b.item()) <= 1e-5
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("N", BATCHES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_boxqp", "admm_boxqp"])
def test_wide_kernel_matches_plain(device, name, start, d, N):
    _assert_matches_plain(name, _problem(d, device), N, 0, start == "warm")


@pytest.mark.parametrize("N", BATCHES)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", ["fista_mpc", "admm_mpc"])
def test_wide_kernel_forming_g_matches_plain(device, name, d, N):
    _assert_matches_plain(name, _problem(d, device), N, 0, False)


@pytest.mark.parametrize("d", [200, 1024])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_boxqp", "admm_boxqp",
                                  "fista_mpc", "admm_mpc"])
def test_wide_coarse_phase_matches_plain(device, name, d):
    """20 of 40 products with both operands rounded to bf16 (one pass)."""
    _assert_matches_plain(name, _problem(d, device), 4096, 20, name in ("fista_mpc_res",
                                                                        "admm_mpc_res"))


@pytest.mark.parametrize("d", [200, 400, 1024])
@pytest.mark.parametrize("kw", [{"form": "zy"}, {"form": "sp"}, {"c_precision": "bf16x4"},
                                {"c_precision": "bf16x3"}, {"form": "zy", "c_precision": "bf16x3"}],
                         ids=str)
def test_wide_admm_forms_and_classes_match_plain(device, kw, d):
    _assert_matches_plain("admm_mpc_res", _problem(d, device), 4096, 0, True, **kw)


@pytest.mark.parametrize("d", [200, 400, 1024])
@pytest.mark.parametrize("tail", ["bf16x3", "highest"])
@pytest.mark.parametrize("g", ["highest", "bf16x4", "bf16x3"])
def test_wide_fista_classes_match_plain(device, tail, g, d):
    _assert_matches_plain("fista_mpc_res", _problem(d, device), 4096, 0, True,
                          tail_precision=tail, g_precision=g)


# -- the tile with every wgmma issued by both warpgroups and slab s's passes
# issued before slab s + 1 loads: the paths' widths, a ragged batch, the
# cluster's edges ---

@pytest.mark.parametrize("N", [1003, 4096])
@pytest.mark.parametrize("d", [132, 400, 1024])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_boxqp", "admm_boxqp",
                                  "fista_mpc", "admm_mpc"])
def test_tile_at_the_paths_widths_matches_plain(device, name, d, N):
    """phase 27's widths (d = 132, 400, 1024: clusters of 2, 4 and 8
    blocks), the full batch and a ragged one whose last tile is partly past
    N."""
    _assert_matches_plain(name, _problem(d, device), N, 0, name in ("fista_mpc_res",
                                                                    "admm_mpc_res"))


@pytest.mark.parametrize("N", [1, 32, 33, 64])
@pytest.mark.parametrize("d", [384, 512, 513])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res"])
def test_tile_cluster_edges_match_plain(device, name, d, N):
    """One scenario, a whole tile, one past it and two tiles; the last
    block's rows all real (d = 384, 512) or all but one past d (513: a
    warpgroup whose rows are all padding still issues its passes)."""
    _assert_matches_plain(name, _problem(d, device), N, 0, True)


@pytest.mark.parametrize("d", [132, 400, 1024])
@pytest.mark.parametrize("tail,g", [("bf16x3", "highest"), ("highest", "bf16x4"),
                                    ("bf16x3", "bf16x3")])
def test_tile_precision_classes_match_plain(device, tail, g, d):
    _assert_matches_plain("fista_mpc_res", _problem(d, device), 1003, 20, True,
                          tail_precision=tail, g_precision=g)


@pytest.mark.parametrize("T", [20, 30])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_mpc", "admm_mpc"])
def test_tile_at_the_formation_matches_plain(device, name, T):
    """The four-quadrotor formation's MPC (n = 48, T = 20 and 30: d = 320
    and 480, phase 31's), its fold in two chunks of the state, against the
    plain version at the bound of phase 31's narrow runs (1e-4)."""
    from chip_smoke import formation_mpc
    from numpower_tpu_torch.models import condense

    A, B, Q, R, QF = formation_mpc(4)
    qp = condense(A, B, Q, R, QF, T, device=device)
    rng = np.random.default_rng(T)
    x0s = torch.as_tensor(0.3 * rng.standard_normal((1003, 48)), dtype=torch.float32,
                          device=device)
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, -1.0, 1.0)
    rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    mod = boxqp_fista if name.startswith("fista") else boxqp_admm
    step = qp.lipschitz if name.startswith("fista") else rho
    got = getattr(mod, name)(*fold, step, ITERS, 0)
    want = getattr(mod, f"{name}_reference")(*fold, step, ITERS, 0)
    assert _err(got[0], want[0]) <= 1e-4 and bool(torch.isfinite(got[0]).all())


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


def test_past_1024_raises(device):
    p = _problem(200, device)
    big = torch.eye(1025, device=device)
    x0s, SxT = p["x0s"][:37], p["SxT"]
    SuTQT = torch.zeros((N_FOLD, 1025), device=device)
    before = (boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches)
    with pytest.raises(ValueError, match="envelope"):
        boxqp_fista.fista_mpc_res(big, SxT, SuTQT, x0s, -1, 1, 1.0)
    with pytest.raises(ValueError, match="envelope"):
        boxqp_admm.admm_mpc_res(big, SxT, SuTQT, x0s, -1, 1, 1.0)
    with pytest.raises(ValueError, match="envelope"):
        boxqp_fista.fista_boxqp(big, torch.zeros((37, 1025), device=device), -1, 1, 1.0)
    assert (boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches) == before


def test_every_cluster_size_can_be_scheduled(device):
    lib = _build.library()
    for b in range(2, 9):
        assert lib.npt_boxqp_wide_clusters(N_STATE, 128 * b) >= 1


@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_boxqp", "admm_boxqp",
                                  "fista_mpc", "admm_mpc"])
def test_failed_cluster_launch_raises_without_fallback(device, name, monkeypatch):
    """A launch the card refuses (here cudaErrorInvalidConfiguration, what
    launch_wide returns for a cluster cudaOccupancyMaxActiveClusters cannot
    place) raises; nothing falls back to the plain version and the counter
    does not move."""
    lib = _build.library()
    entry = {"fista_mpc_res": "npt_fista_mpc_res", "admm_mpc_res": "npt_admm_mpc_res",
             "fista_boxqp": "npt_fista_boxqp", "admm_boxqp": "npt_admm_boxqp",
             "fista_mpc": "npt_fista_mpc", "admm_mpc": "npt_admm_mpc"}[name]
    monkeypatch.setattr(lib, f"{entry}_wide", lambda *args: 9)  # cudaErrorInvalidConfiguration
    counter = getattr(boxqp_fista if name.startswith("fista") else boxqp_admm, name)
    before = counter.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _run(name, _problem(400, device), 37, 0, False)
    assert counter.launches == before


@pytest.mark.parametrize("case", ["fista", "admm", "x_ref"])
def test_captured_tick_at_horizon_100_is_the_eager_tick(device, case):
    """MPCController(horizon=100): the first tick eager (one counted launch
    of the wide kernel) and captured, then replays, which call no wrapper,
    each bit for bit _step_impl run eagerly from the same state, one graph.
    (chip_smoke.py phase 27 counts the replays' kernel runs with
    torch.profiler, which late in a long process such as this file's may
    keep no GPU record.)"""
    A, B = quadrotor12(0.02)
    x_ref = torch.as_tensor(0.2 * np.random.default_rng(5).standard_normal(12),
                            dtype=torch.float32, device=device)
    kw = {"x_ref": x_ref} if case == "x_ref" else {"solver": case}
    ctrl = MPCController(A, B, *_costs(), 100, -1.0, 1.0, iters=30, device=device, **kw)
    counter = {"fista": boxqp_fista.fista_mpc_res, "admm": boxqp_admm.admm_mpc_res,
               "x_ref": boxqp_fista.fista_boxqp}[case]
    x = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((512, 12)),
                        dtype=torch.float32, device=device)
    A_t, B_t = torch.as_tensor(A, device=device), torch.as_tensor(B, device=device)
    state = ctrl.init(512)
    for t in range(4):
        twin = MPCState(U_prev=state.U_prev.clone(), tick=state.tick)
        before = counter.launches
        u0, new = ctrl.step(state, x)
        assert counter.launches == before + (t == 0)
        u_e, eager, _ = ctrl._step_impl(ctrl.qp, twin, x)
        assert torch.equal(u0, u_e) and torch.equal(new.U_prev, eager.U_prev)
        assert bool(((u0 >= -1) & (u0 <= 1)).all())
        state, x = new, x @ A_t.T + u0 @ B_t.T
    assert ctrl.compile_cache_size() == 1 and state.U_prev.shape == (512, 400)
