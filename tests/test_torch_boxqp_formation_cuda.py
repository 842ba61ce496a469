"""The box-QP kernels that form g (or c) from x0 in the kernel, K1
admm_mpc_res, K2 fista_mpc_res, K1' admm_mpc and K2' fista_mpc, past a state
dimension of 32, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so run it on the
GPU machine without the conftest, from the repository's root (it imports
chip_smoke):

    python -m pytest --noconftest tests/test_torch_boxqp_formation_cuda.py -q

- The entries at the four-quadrotor formation (chip_smoke.formation_mpc: n =
  48, m = 16, T = 20, d = 320, N = 4096): solve_mpc_boxqp and
  solve_mpc_boxqp_admm with and without x_ref, MPCController ticks (FISTA,
  ADMM, FISTA + x_ref; the captured replays bit for bit the eager tick) and
  the DP solves on a one-rank NCCL group, each through its kernel (counted),
  U within 1e-4 of the same iteration run by the plain version in float64.
- The kernels against their plain versions at n = 33, 48, 64, 100 and 300
  on both tiles (d = 32, 128, 132, 480, 1024), every precision class of K2's
  g and K1's c, and a ragged N = 1003, on seeded well-conditioned QPs (H's
  eigenvalues in [1, 20], |g| ~ 1): all-fp32 1e-5, a 20-iteration coarse
  phase 1e-4, residuals 1e-5, g 1e-5 of its size, the bounds of the narrow
  instances.
- A launch the card refuses at n = 48 raises, with nothing falling back.
- At n <= 32 the kernels compute what they computed before the fold was
  staged in chunks: fixed-seed SHA-256 digests of K2, K1, K2' and K1' at
  d = 120 and 400 (chip_smoke.fold_checksums) equal those the kernels gave
  before that change on the H100 (probes/boxqp_fold_turns.py prints both).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import fold_checksums, formation_mpc
from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import (
    MPCController, MPCState, condense, solve_mpc_boxqp, solve_mpc_boxqp_admm,
)
from numpower_tpu_torch.models.condensed import (
    admm_coarse_iters, default_coarse_iters, gradient_offset,
)
from numpower_tpu_torch.parallel import (
    make_mesh, shard_batch, solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp,
)

pytestmark = pytest.mark.cuda
ITERS, N, T_FORM, LO, HI = 40, 4096, 20, -1.0, 1.0
STATES = (33, 48, 64, 100, 300)
WIDTHS = (32, 128, 132, 480, 1024)
# fold_checksums' digests from the kernels before the fold was chunked (the
# parent checkout, probes/boxqp_fold_turns.py on one H100 80GB HBM3, 700 W)
NARROW_DIGESTS = {
    "K2 d = 120": "1e83a42ce51ef236",
    "K2 g bf16x3 d = 120": "d11eed621c616809",
    "K1 d = 120": "78523bab1bf90ec9",
    "K1 c bf16x4 d = 120": "e649640f01b6f591",
    "K2' d = 120": "b791aa8d1f78112d",
    "K1' d = 120": "303342e11a6cf92f",
    "K2 d = 400": "52de45e4ffa66deb",
    "K2 g bf16x3 d = 400": "562078601f6ba231",
    "K1 d = 400": "ce8bb39c20a4ee56",
    "K1 c bf16x4 d = 400": "be190aa2ba7b6a8b",
    "K2' d = 400": "e1d28ce06d907f2e",
    "K1' d = 400": "892e18dc7eaaee38",
}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


# -- the entries at the formation ---------------------------------------------

@pytest.fixture(scope="module")
def formation(device):
    A, B, Q, R, QF = formation_mpc(4)
    qp = condense(A, B, Q, R, QF, T_FORM, device=device)
    rng = np.random.default_rng(0)
    t = dict(A=A, B=B, costs=(Q, R, QF), qp=qp,
             x0s=torch.as_tensor(0.3 * rng.standard_normal((N, 48)), dtype=torch.float32,
                                 device=device),
             x_ref=torch.as_tensor(0.2 * np.random.default_rng(5).standard_normal(48),
                                   dtype=torch.float32, device=device))
    t["rho"] = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    t["f64"] = [M.double() for M in (qp.H, qp.Sx.T, qp.SuTQ.T)]
    return t


def _float64(p, solver, x_ref):
    """The same iteration as the kernel route's, run by the plain version in
    float64 on the card: the default schedule's coarse products round their
    operands to bf16 as the kernel's do."""
    qp, (H, SxT, SuTQT) = p["qp"], p["f64"]
    x0s = p["x0s"].double()
    lip, rho = qp.lipschitz.double(), p["rho"].double()
    if solver == "fista":
        ci = default_coarse_iters(qp, ITERS)
        if x_ref is None:
            return boxqp_fista.fista_mpc_res_reference(H, SxT, SuTQT, x0s, LO, HI, lip, ITERS,
                                                       ci)[0]
        g = gradient_offset(qp, p["x0s"], x_ref).double()
        return boxqp_fista.fista_boxqp_reference(H, g, LO, HI, lip, ITERS, ci)
    ci = admm_coarse_iters(qp, ITERS)
    if x_ref is None:
        return boxqp_admm.admm_mpc_res_reference(H, SxT, SuTQT, x0s, LO, HI, rho, ITERS, ci)[0]
    g = gradient_offset(qp, p["x0s"], x_ref).double()
    return boxqp_admm.admm_boxqp_reference(H, g, LO, HI, rho, ITERS, ci)[0]


@pytest.mark.parametrize("x_ref", [False, True], ids=["regulation", "x_ref"])
@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_formation_solve_runs_its_kernel_within_1e4_of_float64(formation, solver, x_ref):
    """solve_mpc_boxqp and solve_mpc_boxqp_admm at n = 48: "auto" takes the
    fused kernel (K2, K1), or the two-step one (K3b, K3a) after g with an
    x_ref. Before the fold was chunked the fused kernels raised ValueError
    here (n > 32)."""
    ref = formation["x_ref"] if x_ref else None
    counter = {("fista", False): boxqp_fista.fista_mpc_res,
               ("fista", True): boxqp_fista.fista_boxqp,
               ("admm", False): boxqp_admm.admm_mpc_res,
               ("admm", True): boxqp_admm.admm_boxqp}[solver, x_ref]
    entry = solve_mpc_boxqp if solver == "fista" else solve_mpc_boxqp_admm
    before = counter.launches
    res = entry(formation["qp"], formation["x0s"], LO, HI, x_ref=ref, iters=ITERS)
    assert counter.launches == before + 1
    assert res.U.shape == (N, 16 * T_FORM) and res.U.device.type == "cuda"
    assert _err(res.U, _float64(formation, solver, ref)) <= 1e-4


@pytest.mark.parametrize("case", ["fista", "admm", "x_ref"])
def test_formation_ticks_replay_the_eager_tick(formation, case):
    """MPCController at the formation: the first tick eager (one counted
    launch of K2, K1 or K3b) and captured, the replays bit for bit
    _step_impl run eagerly from the same state, one graph, u0 in the box."""
    device = formation["x0s"].device
    kw = {"x_ref": formation["x_ref"]} if case == "x_ref" else {"solver": case}
    ctrl = MPCController(formation["A"], formation["B"], *formation["costs"], T_FORM, LO, HI,
                         iters=30, device=device, **kw)
    counter = {"fista": boxqp_fista.fista_mpc_res, "admm": boxqp_admm.admm_mpc_res,
               "x_ref": boxqp_fista.fista_boxqp}[case]
    A_t = torch.as_tensor(formation["A"], device=device)
    B_t = torch.as_tensor(formation["B"], device=device)
    x, state = formation["x0s"], ctrl.init(N)
    for t in range(4):
        twin = MPCState(U_prev=state.U_prev.clone(), tick=state.tick)
        before = counter.launches
        u0, new = ctrl.step(state, x)
        assert counter.launches == before + (t == 0)
        u_e, eager, _ = ctrl._step_impl(ctrl.qp, twin, x)
        assert torch.equal(u0, u_e) and torch.equal(new.U_prev, eager.U_prev)
        assert bool(((u0 >= LO) & (u0 <= HI)).all())
        state, x = new, x @ A_t.T + u0 @ B_t.T
    assert ctrl.compile_cache_size() == 1 and state.U_prev.shape == (N, 16 * T_FORM)


@pytest.fixture(scope="module")
def nccl_mesh(device, tmp_path_factory):
    """A one-rank NCCL group over a FileStore, and its (1, 1) mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield make_mesh((1, 1))
    dist.destroy_process_group()


def test_formation_dp_solves_run_their_kernels(formation, nccl_mesh):
    """The DP solvers at n = 48 on a one-rank NCCL group, beside K2' and K1'
    called directly: one K2 and one K1 launch, each solve within 1e-4 of
    float64, the FISTA DP solve equal to the direct K2' within 1e-5."""
    qp, rho = formation["qp"], formation["rho"]
    xb = shard_batch(formation["x0s"], nccl_mesh)
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T, xb, LO, HI)
    counters = (boxqp_fista.fista_mpc_res, boxqp_admm.admm_mpc_res, boxqp_fista.fista_mpc,
                boxqp_admm.admm_mpc)
    before = [c.launches for c in counters]
    U2p, _ = boxqp_fista.fista_mpc(*fold, qp.lipschitz, ITERS, default_coarse_iters(qp, ITERS))
    r_f = solve_mpc_boxqp_dp(qp, xb, LO, HI, nccl_mesh, ITERS)
    z1p, _, _ = boxqp_admm.admm_mpc(*fold, rho, ITERS, admm_coarse_iters(qp, ITERS))
    r_a = solve_mpc_boxqp_admm_dp(qp, xb, LO, HI, nccl_mesh, iters=ITERS)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    assert _err(r_f.U, U2p) <= 1e-5
    assert _err(r_f.U, _float64(formation, "fista", None)) <= 1e-4
    assert _err(r_a.U, _float64(formation, "admm", None)) <= 1e-4
    assert _err(z1p, _float64(formation, "admm", None)) <= 1e-4


# -- the kernels against their plain versions ---------------------------------

_PROBLEMS = {}


def _problem(n, d, device):
    """A seeded QP of width d at state dimension n: H = V diag(1..20) V',
    Sx' (n, 2n), (Su'Q)' (2n, d) scaled so that |g| ~ 1; 4096 x0s and a warm
    start."""
    if (n, d) not in _PROBLEMS:
        rng = np.random.default_rng(1000 * n + d)
        V, _ = np.linalg.qr(rng.standard_normal((d, d)))
        H = (V * np.linspace(1.0, 20.0, d)) @ V.T
        t = {"H": 0.5 * (H + H.T),
             "SxT": rng.standard_normal((n, 2 * n)) / np.sqrt(2 * n),
             "SuTQT": rng.standard_normal((2 * n, d)) / np.sqrt(n),
             "x0s": 0.3 * rng.standard_normal((N, n)),
             "U0": np.clip(0.8 * rng.standard_normal((N, d)), -0.5, 0.5)}
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in t.items()}
        t["lip"] = torch.linalg.eigvalsh(t["H"].double()).max().float()
        t["rho"] = torch.sqrt(t["lip"] * 1.0)
        _PROBLEMS[n, d] = t
    return _PROBLEMS[n, d]


def _run(name, p, N_, coarse, warm, kernel=True, **kw):
    """Kernel `name` (or its plain version) on the first N_ scenarios."""
    fold = (p["H"], p["SxT"], p["SuTQT"], p["x0s"][:N_], -0.5, 0.5)
    U0 = p["U0"][:N_] if warm else None
    mod = boxqp_fista if name.startswith("fista") else boxqp_admm
    fn = getattr(mod, name if kernel else f"{name}_reference")
    if name == "fista_mpc_res":
        return fn(*fold, p["lip"], ITERS, coarse, U0, **kw)
    if name == "admm_mpc_res":
        return fn(*fold, p["rho"], ITERS, coarse, U0=U0, **kw)
    if name == "fista_mpc":
        return fn(*fold, p["lip"], ITERS, coarse)
    return fn(*fold, p["rho"], ITERS, coarse)


def _assert_matches_plain(name, p, N_, coarse, warm, **kw):
    counter = getattr(boxqp_fista if name.startswith("fista") else boxqp_admm, name)
    before = counter.launches
    got = _run(name, p, N_, coarse, warm, **kw)
    assert counter.launches == before + 1
    want = _run(name, p, N_, coarse, warm, kernel=False, **kw)
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


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("n", STATES)
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_mpc", "admm_mpc"])
def test_kernel_past_32_states_matches_plain(device, name, n, d):
    _assert_matches_plain(name, _problem(n, d, device), N, 0,
                          name in ("fista_mpc_res", "admm_mpc_res"))


@pytest.mark.parametrize("n,d", [(48, 128), (100, 480)])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_mpc", "admm_mpc"])
def test_kernel_past_32_states_ragged_and_coarse_matches_plain(device, name, n, d):
    """A ragged batch (N = 1003) and a 20-iteration coarse phase."""
    p = _problem(n, d, device)
    warm = name in ("fista_mpc_res", "admm_mpc_res")
    _assert_matches_plain(name, p, 1003, 0, warm)
    _assert_matches_plain(name, p, N, 20, warm)


@pytest.mark.parametrize("n,d", [(33, 32), (300, 128), (64, 132), (48, 480)])
@pytest.mark.parametrize("tail", ["bf16x3", "highest"])
@pytest.mark.parametrize("g", ["highest", "bf16x4", "bf16x3"])
def test_fista_g_classes_past_32_states_match_plain(device, g, tail, n, d):
    _assert_matches_plain("fista_mpc_res", _problem(n, d, device), N, 0, True,
                          tail_precision=tail, g_precision=g)


@pytest.mark.parametrize("n,d", [(33, 32), (300, 128), (64, 132), (48, 480)])
@pytest.mark.parametrize("kw", [{"c_precision": "bf16x4"}, {"c_precision": "bf16x3"},
                                {"c_precision": "highest"}, {"form": "zy"}, {"form": "sp"}],
                         ids=str)
def test_admm_c_classes_past_32_states_match_plain(device, kw, n, d):
    _assert_matches_plain("admm_mpc_res", _problem(n, d, device), N, 0, True, **kw)


@pytest.mark.parametrize("d", [120, 320])
@pytest.mark.parametrize("name", ["fista_mpc_res", "admm_mpc_res", "fista_mpc", "admm_mpc"])
def test_failed_launch_at_48_states_raises_without_fallback(device, name, d, monkeypatch):
    """A launch the card refuses (cudaErrorInvalidConfiguration) raises at
    n = 48 on either tile; nothing falls back to the plain version and the
    counter does not move."""
    entry = {"fista_mpc_res": "npt_fista_mpc_res", "admm_mpc_res": "npt_admm_mpc_res",
             "fista_mpc": "npt_fista_mpc", "admm_mpc": "npt_admm_mpc"}[name]
    lib = _build.library()
    monkeypatch.setattr(lib, f"{entry}_wide" if d > 128 else entry, lambda *args: 9)
    counter = getattr(boxqp_fista if name.startswith("fista") else boxqp_admm, name)
    before = counter.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _run(name, _problem(48, d, device), 37, 0, False)
    assert counter.launches == before


# -- unchanged at n <= 32 -----------------------------------------------------

def test_narrow_state_dimension_is_bit_for_bit_unchanged(device):
    """At n = 12 (one chunk of the fold) K2, K1, K2' and K1' return the bits
    they returned before the fold was chunked, at d = 120 and 400."""
    got = {case: digest for case, (digest, _) in fold_checksums(device).items()}
    assert got == NARROW_DIGESTS
