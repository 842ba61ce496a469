"""The FISTA box-QP kernels past d = 128 (K2 fista_mpc_res, K3b fista_boxqp,
K2' fista_mpc on the wide tile) against the JAX package on the same numpy
inputs (CPU), at the long-horizon quadrotor the JAX package tests its kernel
at (T = 100, d = 400, tests/test_kernels.py:285-307) and at T = 33 (d = 132,
the first width past the narrow tile).

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs fista_mpc_pallas_res / fista_boxqp_pallas / fista_mpc_pallas in
interpret mode (tile_n=16), as tests/test_kernels.py does, on the identical
QP (carried over with condensed_from_jax), all-fp32 (coarse_iters=0), within
rtol = atol = 1e-4, the JAX test's bound (at d = 400 the folded-chain and
two-product g formations differ by fp32 accumulation order). Also the slice
as a whole (solve_mpc_boxqp with method="pallas", with and without x_ref,
and a few MPCController(horizon=100) ticks), the route rule (the JAX
package's on-TPU rule "pallas if d <= 1024", boxqp.py:156-161, mirrored for
a CUDA device), and the wide tile's operand layout that the kernels read
(kernels/boxqp_fista._wide_operand). The kernels themselves are held against
these plain versions on the card by tests/test_torch_boxqp_wide_cuda.py and
chip_smoke.py phase 27.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.kernels.boxqp_fista import (  # noqa: E402
    fista_boxqp_pallas, fista_mpc_pallas, fista_mpc_pallas_res,
)
from numpower_tpu_torch.kernels import boxqp_fista  # noqa: E402
from numpower_tpu_torch.kernels._build import MAX_D, TILE_D  # noqa: E402
from numpower_tpu_torch.kernels.precision import bf16_split3  # noqa: E402
from numpower_tpu_torch.models.boxqp import route_mpc_boxqp  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402

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
    assert tqp.H.shape[0] == 4 * T > TILE_D
    return jqp, tqp


@pytest.fixture(scope="module", params=[100, 33], ids=lambda T: f"T{T}")
def qps(request):
    return _pair(request.param)


def _inputs(T, seed=8):
    rng = np.random.default_rng(seed)
    x0s = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
    U0 = (0.8 * rng.standard_normal((N, 4 * T))).astype(np.float32)
    x_ref = (0.2 * rng.standard_normal(12)).astype(np.float32)
    return x0s, U0, x_ref


def _jfold(jqp, x0s):
    return (jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI))


def _fold(tqp):
    return tqp.H, tqp.Sx.T, tqp.SuTQ.T


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fista_mpc_res_matches_jax_kernel(qps, start):
    """K2: U and the in-kernel residual."""
    jqp, tqp = qps
    x0s, U0, _ = _inputs(tqp.T)
    U0 = U0 if start == "warm" else None
    U_j, r_j = fista_mpc_pallas_res(*_jfold(jqp, x0s), jqp.lipschitz, iters=ITERS,
                                    coarse_iters=0, tile_n=16, interpret=True,
                                    U0=None if U0 is None else jnp.asarray(U0))
    U_t, r_t = boxqp_fista.fista_mpc_res(*_fold(tqp), torch.from_numpy(x0s), LO, HI,
                                         tqp.lipschitz, ITERS, 0,
                                         None if U0 is None else torch.from_numpy(U0))
    assert U_t.shape == (N, 4 * tqp.T)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), **BOUND)
    np.testing.assert_allclose(float(r_t), float(r_j), atol=1e-4)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fista_boxqp_matches_jax_kernel(qps, start):
    """K3b on the g of an x_ref, as solve_mpc_boxqp forms it."""
    jqp, tqp = qps
    x0s, U0, x_ref = _inputs(tqp.T)
    g_j = jm.gradient_offset(jqp, jnp.asarray(x0s), jnp.asarray(x_ref))
    g_t = tm.gradient_offset(tqp, torch.from_numpy(x0s), torch.from_numpy(x_ref))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-4)
    U0 = U0 if start == "warm" else None
    U_j = fista_boxqp_pallas(jqp.H, g_j, jnp.float32(LO), jnp.float32(HI), jqp.lipschitz,
                             iters=ITERS, coarse_iters=0, tile_n=16, interpret=True,
                             U0=None if U0 is None else jnp.asarray(U0))
    U_t = boxqp_fista.fista_boxqp(tqp.H, torch.from_numpy(np.array(g_j)), LO, HI,
                                  tqp.lipschitz, ITERS, 0,
                                  None if U0 is None else torch.from_numpy(U0))
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), **BOUND)


def test_fista_mpc_matches_jax_kernel(qps):
    """K2': U and the g it forms (g at rtol 1e-5 of the JAX kernel's)."""
    jqp, tqp = qps
    x0s, _, _ = _inputs(tqp.T)
    U_j, g_j = fista_mpc_pallas(*_jfold(jqp, x0s), jqp.lipschitz, iters=ITERS, coarse_iters=0,
                                tile_n=16, interpret=True)
    U_t, g_t = boxqp_fista.fista_mpc(*_fold(tqp), torch.from_numpy(x0s), LO, HI, tqp.lipschitz,
                                     ITERS, 0)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), **BOUND)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("x_ref", [False, True], ids=["regulation", "x_ref"])
def test_solve_mpc_boxqp_pallas_matches_jax(x_ref):
    """The slice's entry with method="pallas" at T = 100: the fused kernel,
    or the two-step one after g with an x_ref, in both packages."""
    jqp, tqp = _pair(100)
    x0s, U0, ref = _inputs(tqp.T)
    kw = dict(iters=ITERS, method="pallas", coarse_iters=0)
    want = jm.solve_mpc_boxqp(jqp, jnp.asarray(x0s), LO, HI,
                              x_ref=jnp.asarray(ref) if x_ref else None,
                              U0=jnp.asarray(U0), **kw)
    got = tm.solve_mpc_boxqp(tqp, torch.from_numpy(x0s), LO, HI,
                             x_ref=torch.from_numpy(ref) if x_ref else None,
                             U0=torch.from_numpy(U0), **kw)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), **BOUND)
    np.testing.assert_allclose(float(got.residual), float(want.residual), atol=1e-4)


@pytest.mark.parametrize("x_ref", [False, True], ids=["regulation", "x_ref"])
def test_controller_ticks_at_horizon_100_match_jax(x_ref):
    """MPCController(horizon=100) for three ticks of a closed loop, both
    packages on the CPU from the same x0s, u0 within 1e-4."""
    A, B = jm.quadrotor12(0.02)
    x0s, _, ref = _inputs(100)
    kw = dict(iters=30, x_ref=ref if x_ref else None)
    jc = jm.MPCController(A, B, *_costs(), 100, LO, HI, **kw)
    tc = tm.MPCController(A, B, *_costs(), 100, LO, HI, **kw, device="cpu")
    j_state, t_state = jc.init(N), tc.init(N)
    x = x0s
    for _ in range(3):
        u_j, j_state = jc.step(j_state, jnp.asarray(x))
        u_t, t_state = tc.step(t_state, torch.from_numpy(x))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-4)
        x = (x @ A.T + np.asarray(u_j) @ B.T).astype(np.float32)
    assert t_state.U_prev.shape == (N, 400) and tc.compile_cache_size() == 1


def _jax_tpu_rule(d: int) -> str:
    """The JAX package's auto rule on the TPU (boxqp.py:156-161), in the
    port's names: "pallas" if d <= 1024, else the plain FISTA scan."""
    return "kernel" if d <= 1024 else "fista"


@pytest.mark.parametrize("d", [129, 400, 1024, 1025])
@pytest.mark.parametrize("has_x_ref", [False, True], ids=["regulation", "x_ref"])
def test_route_takes_the_kernel_to_1024(d, has_x_ref):
    """On a CUDA device "auto" takes the kernel wherever the JAX package
    takes its Pallas kernel on the TPU, past the narrow tile's d = 128 up to
    d = 1024, and plain FISTA above; the CPU keeps plain FISTA."""
    assert MAX_D == 1024
    assert route_mpc_boxqp("cuda", d, has_x_ref, 2) == _jax_tpu_rule(d)
    assert route_mpc_boxqp("cpu", d, has_x_ref, 2) == "fista"


@pytest.mark.parametrize("d", [129, 200, 400, 1024])
def test_wide_operand_is_the_split_laid_out_by_slab(d):
    """The wide tile's operand (csrc/boxqp_tile.cuh, WideTile): for block r,
    part p and 64-column slab s, entry (j, k) of the 128 x 64 block sits at
    (j / 8) 512 + (k / 8) 64 + (j % 8) 8 + k % 8 and holds part p of the
    exact bf16 split of A = m' (zero-padded to 128 ceil(d / 128)) at
    (128 r + j, 64 s + k); the parts sum to A exactly."""
    m = torch.from_numpy(np.random.default_rng(d).standard_normal((d, d)).astype(np.float32))
    wide = boxqp_fista._wide_operand(m)
    b = -(-d // TILE_D)
    D = TILE_D * b
    assert wide.shape == (b, 3, 2 * b, 8192) and wide.dtype == torch.bfloat16
    assert wide.is_contiguous()
    A = torch.zeros((D, D))
    A[:d, :d] = m.T
    parts = bf16_split3(A)
    assert torch.equal(parts[0] + parts[1] + parts[2], A)
    j, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    at = torch.from_numpy((j // 8) * 512 + (k // 8) * 64 + (j % 8) * 8 + k % 8)
    for r in range(b):
        for s in range(2 * b):
            for p in range(3):
                block = parts[p][128 * r:128 * (r + 1), 64 * s:64 * (s + 1)]
                assert torch.equal(wide[r, p, s][at].float(), block)


def test_wide_operand_is_none_on_the_narrow_tile_and_checked():
    """d <= 128 keeps the narrow tile (the kernel stages m itself); a split
    operand of another d is refused before any launch."""
    m = torch.eye(TILE_D)
    assert boxqp_fista._wide_operand(m) is None
    assert boxqp_fista._matrix_operand("H'", m, None, torch.device("cpu"), TILE_D) is m
    m400 = torch.eye(400)
    wide = boxqp_fista._matrix_operand("H'", m400, None, torch.device("cpu"), 400)
    assert torch.equal(wide, boxqp_fista._wide_operand(m400))
    with pytest.raises(ValueError, match="split"):
        boxqp_fista._matrix_operand("H'", torch.eye(520), boxqp_fista._wide_operand(m400),
                                    torch.device("cpu"), 520)
    Ht, W, split = boxqp_fista._fista_folds(m400, torch.eye(12), torch.zeros((12, 400)))
    assert split is None and Ht.shape == (400, 400)  # formed on the card only
