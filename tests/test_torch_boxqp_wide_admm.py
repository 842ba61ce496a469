"""The ADMM box-QP kernels past d = 128 (K1 admm_mpc_res, K3a admm_boxqp, K1'
admm_mpc on the wide tile) against the JAX package on the same numpy inputs
(CPU), at the long-horizon quadrotor (T = 100, d = 400) and at T = 33
(d = 132), and the routes of the ADMM and data-parallel solvers.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs admm_mpc_pallas_res / admm_boxqp_pallas / admm_mpc_pallas in interpret
mode (tile_n=16), as tests/test_kernels.py does, on the identical QP, all-fp32
(coarse_iters=0) with c "highest" on both sides, within rtol = atol = 1e-4
(the bound of tests/test_kernels.py's long-horizon test); y and g rtol 1e-5 of
their magnitude beside it (JAX's interpret-mode tail is bf16x3). Also
solve_mpc_boxqp_admm with method="pallas" (with and without x_ref), a few
MPCController(horizon=100, solver="admm") ticks, and the routes: the JAX
package's on-TPU rules (admm.py:134-136, "pallas" if d <= 1024 and x0s is a
batch; sharding.py:41-50, the sharded solvers' "pallas" if d <= 1024, run
here through the JAX function with its TPU test patched in) mirrored for a
CUDA device. The kernels themselves are held against these plain versions on
the card by tests/test_torch_boxqp_wide_cuda.py and chip_smoke.py phase 27.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu.parallel.sharding as jsh  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.kernels.boxqp_admm import (  # noqa: E402
    admm_boxqp_pallas, admm_mpc_pallas, admm_mpc_pallas_res,
)
from numpower_tpu_torch.kernels import boxqp_admm  # noqa: E402
from numpower_tpu_torch.models.admm import route_mpc_boxqp_admm  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402
from numpower_tpu_torch.parallel import sharding as tsh  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
N, ITERS, LO, HI = 16, 40, -0.5, 0.5
BOUND = dict(rtol=1e-4, atol=1e-4)


def _costs():
    return (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
            np.eye(12, dtype=np.float32) * 5.0)


@functools.lru_cache(maxsize=None)
def _pair(T):
    """Config #4's model and weights at horizon T, in both packages."""
    A, B = jm.quadrotor12(0.02)
    jqp = jm.condense(jnp.asarray(A), jnp.asarray(B), *(jnp.asarray(c) for c in _costs()), T)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS}, T=T, n=12, m=4,
                             kappa=float(jqp.kappa), device="cpu")
    return jqp, tqp


@pytest.fixture(scope="module", params=[100, 33], ids=lambda T: f"T{T}")
def qps(request):
    return _pair(request.param)


def _inputs(T, seed=9):
    rng = np.random.default_rng(seed)
    x0s = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
    U0 = (0.8 * rng.standard_normal((N, 4 * T))).astype(np.float32)
    x_ref = (0.2 * rng.standard_normal(12)).astype(np.float32)
    return x0s, U0, x_ref


def _rho(jqp):
    return jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12))


def _jfold(jqp, x0s):
    return (jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI))


def _fold(tqp):
    return tqp.H, tqp.Sx.T, tqp.SuTQ.T


def _close_rel(got, want):
    """Within 1e-5 of the magnitude of `want`, or the bound's atol."""
    want = np.asarray(want)
    atol = max(BOUND["atol"], 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_admm_mpc_res_matches_jax_kernel(qps, start):
    """K1: z and the in-kernel residuals."""
    jqp, tqp = qps
    x0s, U0, _ = _inputs(tqp.T)
    U0 = U0 if start == "warm" else None
    rho = _rho(jqp)
    z_j, rp_j, rd_j = admm_mpc_pallas_res(
        *_jfold(jqp, x0s), rho, iters=ITERS, coarse_iters=0, tile_n=16, interpret=True,
        U0=None if U0 is None else jnp.asarray(U0), c_precision="highest")
    z_t, rp_t, rd_t = boxqp_admm.admm_mpc_res(
        *_fold(tqp), torch.from_numpy(x0s), LO, HI, torch.from_numpy(np.array(rho)), ITERS, 0,
        U0=None if U0 is None else torch.from_numpy(U0))
    assert z_t.shape == (N, 4 * tqp.T)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **BOUND)
    np.testing.assert_allclose(float(rp_t), float(rp_j), atol=1e-4)
    np.testing.assert_allclose(float(rd_t), float(rd_j), atol=1e-4)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_admm_boxqp_matches_jax_kernel(qps, start):
    """K3a on the g of an x_ref: z and the scaled dual y."""
    jqp, tqp = qps
    x0s, U0, x_ref = _inputs(tqp.T)
    g_j = jm.gradient_offset(jqp, jnp.asarray(x0s), jnp.asarray(x_ref))
    U0 = U0 if start == "warm" else None
    rho = _rho(jqp)
    z_j, y_j = admm_boxqp_pallas(jqp.H, g_j, jnp.float32(LO), jnp.float32(HI), rho, iters=ITERS,
                                 coarse_iters=0, tile_n=16, interpret=True,
                                 U0=None if U0 is None else jnp.asarray(U0))
    z_t, y_t = boxqp_admm.admm_boxqp(tqp.H, torch.from_numpy(np.array(g_j)), LO, HI,
                                     torch.from_numpy(np.array(rho)), ITERS, 0,
                                     U0=None if U0 is None else torch.from_numpy(U0))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **BOUND)
    _close_rel(y_t, y_j)


def test_admm_mpc_matches_jax_kernel(qps):
    """K1': z, y and the g it forms."""
    jqp, tqp = qps
    x0s, _, _ = _inputs(tqp.T)
    rho = _rho(jqp)
    z_j, y_j, g_j = admm_mpc_pallas(*_jfold(jqp, x0s), rho, iters=ITERS, coarse_iters=0,
                                    tile_n=16, interpret=True)
    z_t, y_t, g_t = boxqp_admm.admm_mpc(*_fold(tqp), torch.from_numpy(x0s), LO, HI,
                                        torch.from_numpy(np.array(rho)), ITERS, 0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **BOUND)
    _close_rel(y_t, y_j)
    _close_rel(g_t, g_j)


@pytest.mark.parametrize("x_ref", [False, True], ids=["regulation", "x_ref"])
def test_solve_mpc_boxqp_admm_pallas_matches_jax(x_ref):
    """The slice's ADMM entry with method="pallas" at T = 100: the fused
    kernel, or the two-step one after g with an x_ref, in both packages.

    Bound: JAX's solve runs its defaults (c in "bf16x4", the tail in
    "bf16x3") and forms g in its own order, the port's "highest"; at T = 100
    (kappa 783, |g| up to ~400) fp32 ADMM itself sits ~1-3e-4 from float64
    after 40 iterations, so the two are held within JAX's own distance from
    the float64 solve of the same iteration (the port's plain route run in
    float64) plus the kernels' 1e-4; the residuals within that, or 1e-3 of
    their size."""
    jqp, tqp = _pair(100)
    x0s, U0, ref = _inputs(tqp.T)
    kw = dict(iters=ITERS, coarse_iters=0)
    want = jm.solve_mpc_boxqp_admm(jqp, jnp.asarray(x0s), LO, HI,
                                   x_ref=jnp.asarray(ref) if x_ref else None,
                                   U0=jnp.asarray(U0), method="pallas", **kw)
    got = tm.solve_mpc_boxqp_admm(tqp, torch.from_numpy(x0s), LO, HI,
                                  x_ref=torch.from_numpy(ref) if x_ref else None,
                                  U0=torch.from_numpy(U0), method="pallas", **kw)
    q64 = tqp.replace(**{f: getattr(tqp, f).double() for f in FIELDS})
    f64 = tm.solve_mpc_boxqp_admm(q64, torch.from_numpy(x0s).double(), LO, HI,
                                  x_ref=torch.from_numpy(ref).double() if x_ref else None,
                                  U0=torch.from_numpy(U0).double(), method="plain", **kw)
    fp32_floor = float(np.abs(np.asarray(want.U) - f64.U.numpy()).max())
    assert fp32_floor < 5e-4
    atol = fp32_floor + BOUND["atol"]
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=atol)
    # the residuals (~0.17 here: 40 iterations do not converge at kappa 783)
    # are maxima over the same iterates: the same floor, or 1e-3 of their size
    for name in ("primal_residual", "dual_residual"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-3, atol=atol)


def test_admm_controller_ticks_at_horizon_100_match_jax():
    """MPCController(horizon=100, solver="admm") for three ticks of a closed
    loop, both packages on the CPU from the same x0s, u0 within 1e-4."""
    A, B = jm.quadrotor12(0.02)
    x0s, _, _ = _inputs(100)
    jc = jm.MPCController(A, B, *_costs(), 100, LO, HI, iters=30, solver="admm")
    tc = tm.MPCController(A, B, *_costs(), 100, LO, HI, iters=30, solver="admm", device="cpu")
    j_state, t_state = jc.init(N), tc.init(N)
    x = x0s
    for _ in range(3):
        u_j, j_state = jc.step(j_state, jnp.asarray(x))
        u_t, t_state = tc.step(t_state, torch.from_numpy(x))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
        x = (x @ A.T + np.asarray(u_j) @ B.T).astype(np.float32)
    assert t_state.U_prev.shape == (N, 400) and tc.compile_cache_size() == 1


def _jax_tpu_rule_admm(d: int, x0_ndim: int) -> str:
    """The JAX package's auto rule on the TPU (admm.py:134-136), in the
    port's names: "pallas" if d <= 1024 and x0s is a batch, else plain."""
    return "kernel" if d <= 1024 and x0_ndim == 2 else "plain"


@pytest.mark.parametrize("d", [129, 400, 1024, 1025])
@pytest.mark.parametrize("x0_ndim", [2, 1])
def test_admm_route_takes_the_kernel_to_1024(d, x0_ndim):
    """On a CUDA device "auto" takes the ADMM kernel wherever the JAX package
    takes its Pallas kernel on the TPU, past d = 128 up to d = 1024."""
    assert route_mpc_boxqp_admm("cuda", d, False, x0_ndim) == _jax_tpu_rule_admm(d, x0_ndim)
    assert route_mpc_boxqp_admm("cuda", d, True, x0_ndim) == _jax_tpu_rule_admm(d, x0_ndim)
    assert route_mpc_boxqp_admm("cpu", d, False, x0_ndim) == "plain"


@pytest.mark.parametrize("d", [129, 400, 1024, 1025])
def test_dp_route_takes_the_kernel_to_1024(d, monkeypatch):
    """The sharded solvers' "auto" on a mesh of CUDA devices is the JAX
    package's _pick_method on a TPU mesh (its TPU test patched in), in the
    port's names; a CPU mesh keeps the plain scan."""
    monkeypatch.setattr(jsh, "_mesh_is_tpu", lambda mesh: True)
    want = {"pallas": "kernel", "xla": "plain"}[
        jsh._pick_method(SimpleNamespace(H=np.zeros((d, d), np.float32)), None, "auto")]
    qp = SimpleNamespace(H=torch.empty((d, d)))
    assert tsh._pick_method(qp, SimpleNamespace(device=torch.device("cuda", 0)), "auto") == want
    assert want == ("kernel" if d <= 1024 else "plain")
    assert tsh._pick_method(qp, SimpleNamespace(device=torch.device("cpu")), "auto") == "plain"
