"""The box-QP kernels that form g (or c) from x0, K2 fista_mpc_res, K1
admm_mpc_res, K2' fista_mpc and K1' admm_mpc, past a state dimension of 32,
against the JAX package on the same numpy inputs (CPU).

The configuration is the four-quadrotor formation's MPC
(chip_smoke.formation_mpc: A = kron(I_4, quadrotor12(0.02).A), n = 48,
m = 16, Q = I + kron(L_ring, E_pos), R = 0.1 I, QF = 5 I) at T = 2 (d = 32)
and T = 9 (d = 144), N = 24, and random stable plants at n = 33 and 100
(m = 2, T = 4). On the CPU the port's wrappers run their plain PyTorch
versions; the JAX side runs fista_mpc_pallas_res / admm_mpc_pallas_res /
fista_mpc_pallas / admm_mpc_pallas in interpret mode (tile_n=16), as
tests/test_torch_boxqp_kernels.py does, on the identical QP (carried over
with condensed_from_jax), with that file's tolerances: all-fp32
(coarse_iters=0) 1e-5 on the solutions and the residuals, the default
bf16 + fp32 schedules 1e-4 (JAX on the CPU computes the coarse
DEFAULT-precision products in fp32 while the port rounds their operands to
bf16 as the TPU does), g at rtol 1e-5, atol 1e-5. Each precision class of
K2's g and K1's c runs at one of the two schedules, and each schedule with
the classes of both. Also the slice's entries (solve_mpc_boxqp and
solve_mpc_boxqp_admm on the kernel route with and without x_ref, and the
controller's ticks) against the JAX package's same entries, and the routes
that send a 48-state plant to the kernels on a CUDA device, as the JAX rule
sends it to its kernels on the TPU. The kernels themselves are held against
these plain versions on the card by tests/test_torch_boxqp_formation_cuda.py
and chip_smoke.py phase 31.
"""

import functools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from chip_smoke import formation_mpc, stable_mpc_plant  # noqa: E402
from numpower_tpu.kernels.boxqp_admm import admm_mpc_pallas, admm_mpc_pallas_res  # noqa: E402
from numpower_tpu.kernels.boxqp_fista import (  # noqa: E402
    fista_mpc_pallas, fista_mpc_pallas_res,
)
from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista  # noqa: E402
from numpower_tpu_torch.models.admm import route_mpc_boxqp_admm  # noqa: E402
from numpower_tpu_torch.models.boxqp import route_mpc_boxqp  # noqa: E402
from numpower_tpu_torch.models.condensed import (  # noqa: E402
    admm_coarse_iters, condensed_from_jax, default_coarse_iters,
)
from numpower_tpu_torch.parallel.sharding import _pick_method  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
N, ITERS, LO, HI = 24, 40, -0.5, 0.5


@functools.lru_cache(maxsize=None)
def _plant(kind):
    """(A, B, Q, R, QF) numpy float32: the formation, or a random stable
    plant of n states and m = 2 (chip_smoke.stable_mpc_plant)."""
    return formation_mpc(4) if kind == "formation" else stable_mpc_plant(int(kind), 2, int(kind))


@functools.lru_cache(maxsize=None)
def _pair(kind, T):
    """The plant's condensed QP at horizon T in both packages."""
    A, B, Q, R, QF = _plant(kind)
    jqp = jm.condense(*(jnp.asarray(M) for M in (A, B, Q, R, QF)), T)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS}, T=T,
                             n=A.shape[0], m=B.shape[1], kappa=float(jqp.kappa), device="cpu")
    return jqp, tqp


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (0.3 * rng.standard_normal((N, n))).astype(np.float32)
    # a warm start that leaves the box in places: FISTA takes U0 as it is,
    # ADMM clips it
    U0 = (0.8 * rng.standard_normal((N, d))).astype(np.float32)
    return x0s, U0


def _rho(jqp):
    return jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12))


def _schedule(tqp, name, schedule):
    if schedule == "fp32":
        return 0
    return (default_coarse_iters if name.startswith("fista") else admm_coarse_iters)(tqp, ITERS)


def _compare(kind, T, name, schedule, **kw):
    """Kernel `name` of both packages on the same QP and inputs: the port's
    plain version (its wrapper on a CPU tensor) against the JAX kernel in
    interpret mode; K2 and K1 from a warm start, K2' and K1' cold."""
    jqp, tqp = _pair(kind, T)
    n, d = tqp.Sx.shape[1], tqp.H.shape[0]
    coarse = _schedule(tqp, name, schedule)
    x0s, U0 = _inputs(n, d)
    jfold = (jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI))
    tfold = (tqp.H, tqp.Sx.T, tqp.SuTQ.T, torch.from_numpy(x0s), LO, HI)
    jkw = dict(iters=ITERS, coarse_iters=coarse, tile_n=16, interpret=True)
    rho = _rho(jqp)
    rho_t = torch.from_numpy(np.array(rho))
    if name == "fista_mpc_res":
        want = fista_mpc_pallas_res(*jfold, jqp.lipschitz, **jkw, U0=jnp.asarray(U0),
                                    tail_precision="highest", **kw)
        got = boxqp_fista.fista_mpc_res(*tfold, tqp.lipschitz, ITERS, coarse,
                                        torch.from_numpy(U0), **kw)
    elif name == "admm_mpc_res":
        want = admm_mpc_pallas_res(*jfold, rho, **jkw, U0=jnp.asarray(U0), **kw)
        got = boxqp_admm.admm_mpc_res(*tfold, rho_t, ITERS, coarse, U0=torch.from_numpy(U0),
                                      **kw)
    elif name == "fista_mpc":
        want = fista_mpc_pallas(*jfold, jqp.lipschitz, **jkw)
        got = boxqp_fista.fista_mpc(*tfold, tqp.lipschitz, ITERS, coarse)
    else:
        want = admm_mpc_pallas(*jfold, rho, **jkw)
        got = boxqp_admm.admm_mpc(*tfold, rho_t, ITERS, coarse)
    tol = 1e-5 if coarse == 0 else 1e-4
    if name in ("fista_mpc", "admm_mpc"):  # g last
        np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]), rtol=1e-5, atol=1e-5)
        got, want = got[:-1], want[:-1]
    assert got[0].shape == (N, d)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


# K2's g classes and K1's c classes, each at one schedule, each schedule
# with classes of both (K2's "highest" g at coarse_iters = 0 also runs in
# test_formation_entries_on_the_kernel_route_match_jax); fp32 at T = 2
# (d = 32), the default schedule at T = 9 (d = 144)
CLASS_CASES = [("fista_mpc_res", "default", {"g_precision": "highest"}),
               ("fista_mpc_res", "fp32", {"g_precision": "bf16x4"}),
               ("fista_mpc_res", "default", {"g_precision": "bf16x3"}),
               ("admm_mpc_res", "fp32", {"c_precision": "highest"}),
               ("admm_mpc_res", "default", {"c_precision": "bf16x4"}),
               ("admm_mpc_res", "fp32", {"c_precision": "bf16x3"}),
               ("fista_mpc", "fp32", {}),
               ("admm_mpc", "default", {})]


@pytest.mark.parametrize("name,schedule,kw", CLASS_CASES,
                         ids=[f"{a}-{b}-{'-'.join(c.values()) or 'g'}" for a, b, c in CLASS_CASES])
def test_formation_kernel_matches_jax(name, schedule, kw):
    _compare("formation", 2 if schedule == "fp32" else 9, name, schedule, **kw)


@pytest.mark.parametrize("name,kind,schedule", [("fista_mpc_res", "33", "fp32"),
                                                 ("admm_mpc_res", "100", "default")])
def test_random_plant_kernel_matches_jax(name, kind, schedule):
    """Past the fold's first 32-row chunk (n = 33) and past three of them
    (n = 100), m = 2, T = 4."""
    _compare(kind, 4, name, schedule)


@pytest.mark.parametrize("x_ref", [False, True], ids=["regulation", "x_ref"])
@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_formation_entries_on_the_kernel_route_match_jax(solver, x_ref):
    """solve_mpc_boxqp and solve_mpc_boxqp_admm at the formation (T = 9)
    with method="pallas", the JAX route name, all-fp32: the fused kernel,
    or the two-step one after g with an x_ref, in both packages."""
    jqp, tqp = _pair("formation", 9)
    x0s, U0 = _inputs(48, tqp.H.shape[0], seed=1)
    ref = (0.2 * np.random.default_rng(5).standard_normal(48)).astype(np.float32)
    kw = dict(iters=ITERS, method="pallas", coarse_iters=0)
    jref, tref = (jnp.asarray(ref), torch.from_numpy(ref)) if x_ref else (None, None)
    if solver == "fista":
        want = jm.solve_mpc_boxqp(jqp, jnp.asarray(x0s), LO, HI, x_ref=jref, **kw)
        got = tm.solve_mpc_boxqp(tqp, torch.from_numpy(x0s), LO, HI, x_ref=tref, **kw)
        pairs = [(got.residual, want.residual)]
    else:
        want = jm.solve_mpc_boxqp_admm(jqp, jnp.asarray(x0s), LO, HI, x_ref=jref, **kw)
        got = tm.solve_mpc_boxqp_admm(tqp, torch.from_numpy(x0s), LO, HI, x_ref=tref, **kw)
        pairs = [(got.primal_residual, want.primal_residual),
                 (got.dual_residual, want.dual_residual)]
    # the JAX fused FISTA kernel's tail is "bf16x3" by default, the port's
    # "highest": within the default schedule's bound
    tol = 1e-4 if solver == "fista" and not x_ref else 1e-5
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=tol)
    for a, b in pairs:
        np.testing.assert_allclose(float(a), float(b), rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["fista", "admm", "x_ref"])
def test_formation_controller_ticks_match_jax(case):
    """MPCController at the formation (T = 9), both packages on the CPU from
    the same x0s, three ticks of a closed loop, u0 within 1e-4."""
    A, B, Q, R, QF = _plant("formation")
    x0s, _ = _inputs(48, 1, seed=2)
    ref = (0.2 * np.random.default_rng(5).standard_normal(48)).astype(np.float32)
    kw = {"x_ref": ref} if case == "x_ref" else {"solver": case}
    jc = jm.MPCController(A, B, Q, R, QF, 9, LO, HI, iters=30, **kw)
    tc = tm.MPCController(A, B, Q, R, QF, 9, LO, HI, iters=30, **kw, device="cpu")
    j_state, t_state = jc.init(N), tc.init(N)
    x = x0s
    for _ in range(3):
        u_j, j_state = jc.step(j_state, jnp.asarray(x))
        u_t, t_state = tc.step(t_state, torch.from_numpy(x))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
        x = (x @ A.T + np.asarray(u_j) @ B.T).astype(np.float32)
    assert t_state.U_prev.shape == (N, 16 * 9)


@pytest.mark.parametrize("d", [32, 320, 480, 1024])
def test_routes_send_48_states_to_the_kernels_on_the_card(d):
    """"auto" on a CUDA device takes the kernels at n = 48 wherever the JAX
    rule takes its kernels on the TPU (d <= 1024, with no look at n):
    route_mpc_boxqp, route_mpc_boxqp_admm and the DP solvers' _pick_method;
    the CPU keeps the plain routes."""
    qp = types.SimpleNamespace(H=torch.empty(d, d), Sx=torch.empty(48 * 4, 48))
    for device_type, want in (("cuda", "kernel"), ("cpu", None)):
        mesh = types.SimpleNamespace(device=torch.device(device_type))
        assert route_mpc_boxqp(device_type, d, False, 2) == (want or "fista")
        assert route_mpc_boxqp(device_type, d, True, 2) == (want or "fista")
        assert route_mpc_boxqp_admm(device_type, d, False, 2) == (want or "plain")
        assert _pick_method(qp, mesh, "auto") == (want or "plain")
