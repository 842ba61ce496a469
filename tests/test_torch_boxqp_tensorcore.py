"""The arithmetic of the tensor-core box-QP kernels, emulated on the CPU.

On the card every iteration product of K1-K3, K1' and K2' is a number of
bf16 passes over the exact three-way split x = hi + mid + lo
(csrc/boxqp_tile.cuh): 1 for a coarse product, 3 for "bf16x3", 4 for
"bf16x4", 6 for "highest", the hi@hi pass summed apart from the corrections.
kernels/precision.py holds the same sum in plain PyTorch
(bf16_split3, bf16_pass_product). Here:

- the split is exact over a wide exponent range, both signs;
- the 6-pass product is no further from the float64 product than twice the
  fp32 product is (largest error over the matrix), and the 3- and 4-pass
  products stay within 2^-14 of |x| @ |y| of it;
- FISTA and ADMM at the flagship QP (BASELINE config #4, d = 120, N = 64
  scenarios from seed 0) with the emulated 6-pass tail stay within 2e-6 of
  the fp32 plain versions, no further from float64 than those are, and
  within the tolerances of tests/test_torch_boxqp_kernels.py (1e-5 all-fp32,
  1e-4 at the default schedule) of the JAX package's kernels in interpret
  mode at its box +-0.5. 2e-6 and not 1e-6: at 40 iterations the fp32 plain
  solve itself sits 1.1e-6 to 1.9e-6 from float64 here, and two fp32 sum
  orders of the same product part by up to 1.4e-6 (seeds 0-3). At the box
  +-1 the JAX ADMM kernel's residual parts from the fp32 plain version by
  1.1e-5 as well: its bf16x3 x-update (ROADMAP queue 3).

The kernels themselves are held against the plain versions on the card by
tests/test_torch_boxqp_tensorcore_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from numpower_tpu.kernels.boxqp_admm import admm_mpc_pallas_res  # noqa: E402
from numpower_tpu.kernels.boxqp_fista import fista_mpc_pallas_res  # noqa: E402
from numpower_tpu.models import condense as jax_condense  # noqa: E402
from numpower_tpu.models import quadrotor12  # noqa: E402
from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista  # noqa: E402
from numpower_tpu_torch.kernels.boxqp_admm import _admm_loop, _fold  # noqa: E402
from numpower_tpu_torch.kernels.boxqp_fista import _fista_loop  # noqa: E402
from numpower_tpu_torch.kernels.precision import (  # noqa: E402
    PRECISION_CODES, TENSOR_PASSES, bf16_pass_product, bf16_split3, make_tail_dot,
)
from numpower_tpu_torch.models.condensed import (  # noqa: E402
    admm_coarse_iters, condensed_from_jax, default_coarse_iters,
)

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
N, ITERS, ALPHA = 64, 40, 1.6


@pytest.fixture(scope="module")
def qps():
    """The flagship QP (quadrotor, T = 30, d = 120) in both packages, value
    for value."""
    A, B = quadrotor12(0.02)
    jqp = jax_condense(jnp.asarray(A), jnp.asarray(B), jnp.eye(12), jnp.eye(4) * 0.1,
                       jnp.eye(12) * 5.0, 30)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                             T=30, n=jqp.n, m=jqp.m, kappa=jqp.kappa, device="cpu")
    return jqp, tqp


def _inputs(warm: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    x0s = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
    U0 = (0.8 * rng.standard_normal((N, 120))).astype(np.float32) if warm else None
    return x0s, U0


def _err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


# -- the split and the products ------------------------------------------------

@pytest.mark.parametrize("exponents", [(-100, -60), (-60, -20), (-20, 20), (20, 60), (60, 100)])
def test_split3_is_exact(exponents):
    rng = np.random.default_rng(abs(exponents[0]) + 7)
    x = (rng.choice([-1.0, 1.0], 20000) * rng.uniform(1.0, 2.0, 20000)
         * np.exp2(rng.integers(*exponents, 20000))).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = bf16_split3(x)
    # three fp32 values of 24 bits in all: their float64 sum is exact
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


def _operands(kind: str, qps):
    """(x, y) pairs on which the products are held against float64."""
    rng = np.random.default_rng(3)
    if kind == "gaussian":
        return (torch.from_numpy(rng.standard_normal((N, 120)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal((120, 120)).astype(np.float32)))
    if kind == "wide":  # entries over 2^-8 .. 2^8, both signs
        x = rng.standard_normal((N, 128)) * np.exp2(rng.uniform(-8, 8, (N, 128)))
        y = rng.standard_normal((128, 96)) * np.exp2(rng.uniform(-8, 8, (128, 96)))
        return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y.astype(np.float32))
    _, tqp = qps
    _, U0 = _inputs(warm=True)
    if kind == "fista":  # the warm start against H'
        return torch.from_numpy(U0), tqp.H.T.contiguous()
    rho = torch.sqrt(tqp.lipschitz * torch.clamp(tqp.mu, min=1e-12))
    rminvT, _ = _fold(tqp.H, tqp.Sx.T, tqp.SuTQ.T, rho, None)
    return torch.from_numpy(U0), rminvT  # "admm": against (rho Minv)'


@pytest.mark.parametrize("kind", ["gaussian", "wide", "fista", "admm"])
def test_six_passes_as_accurate_as_fp32(kind, qps):
    x, y = _operands(kind, qps)
    exact = x.double() @ y.double()
    e_fp32 = _err(x @ y, exact)
    e_six = _err(bf16_pass_product(x, y, TENSOR_PASSES["highest"]), exact)
    assert e_six <= 2.0 * e_fp32, (e_six, e_fp32)


@pytest.mark.parametrize("cls", ["bf16x3", "bf16x4"])
@pytest.mark.parametrize("kind", ["gaussian", "wide", "fista", "admm"])
def test_split_classes_bound(kind, cls, qps):
    """3 and 4 passes drop terms of at most 2^-18 relative per operand pair
    (and keep the fp32 sums'): within 2^-14 |x| @ |y| of the exact product,
    and of the plain version's class, whose lo stays fp32."""
    x, y = _operands(kind, qps)
    scale = x.double().abs() @ y.double().abs()
    got = bf16_pass_product(x, y, TENSOR_PASSES[cls]).double()
    assert bool(((got - x.double() @ y.double()).abs() <= 2.0 ** -14 * scale).all())
    assert bool(((got - make_tail_dot(y, cls)(x).double()).abs() <= 2.0 ** -14 * scale).all())


def test_pass_counts_cover_the_classes():
    assert set(PRECISION_CODES) | {"coarse"} == set(TENSOR_PASSES)
    x, y = _operands("gaussian", None)
    # one pass is the coarse phase's product: both operands rounded to bf16
    one = bf16_pass_product(x, y, TENSOR_PASSES["coarse"])
    assert torch.equal(one, x.to(torch.bfloat16).float() @ y.to(torch.bfloat16).float())
    with pytest.raises(ValueError):
        bf16_pass_product(x, y, 2)


# -- the solves with the emulated tail ----------------------------------------

def _coarse(tqp, solver: str, schedule: str) -> int:
    if schedule == "fp32":
        return 0
    return (default_coarse_iters if solver == "fista" else admm_coarse_iters)(tqp, ITERS)


def _rho(qp):
    return torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))


def _emulated(tqp, solver, x0s, lo, hi, coarse, U0):
    """The fused kernel's plain version with its tail and residual products
    as the card's 6 bf16 passes: FISTA (U, resid), ADMM (z, r_prim, r_dual)."""
    fold = (tqp.H, tqp.Sx.T, tqp.SuTQ.T)
    if solver == "fista":
        g = x0s @ (fold[1] @ fold[2])
        Ht = tqp.H.T
        tail = lambda Y: bf16_pass_product(Y, Ht, 6)  # noqa: E731
        U = _fista_loop(tqp.H, g, lo, hi, tqp.lipschitz, ITERS, coarse, U0, tail)
        grad = tail(U) + g
        return U, torch.abs(U - torch.clamp(U - grad / tqp.lipschitz, lo, hi)).max()
    rho = _rho(tqp)
    rminvT, Wc = _fold(*fold, rho, None)
    c = x0s @ Wc
    tail = lambda t: bf16_pass_product(t, rminvT, 6)  # noqa: E731
    s = _admm_loop(c, rminvT, lo, hi, ALPHA, ITERS, coarse, U0, tail)
    z = torch.clamp(s, lo, hi)
    x = tail(2.0 * z - s) - c
    z_next = torch.clamp(s + ALPHA * (x - z), lo, hi)
    return z, torch.abs(x - z).max(), rho * torch.abs(z_next - z).max()


def _plain(tqp, solver, x0s, lo, hi, coarse, U0):
    fold = (tqp.H, tqp.Sx.T, tqp.SuTQ.T)
    if solver == "fista":
        return boxqp_fista.fista_mpc_res_reference(*fold, x0s, lo, hi, tqp.lipschitz, ITERS,
                                                   coarse, U0)
    return boxqp_admm.admm_mpc_res_reference(*fold, x0s, lo, hi, _rho(tqp), ITERS, coarse,
                                             ALPHA, U0=U0)


def _float64(tqp):
    return type(tqp)(**{f: getattr(tqp, f).double() for f in FIELDS}, T=tqp.T, n=tqp.n,
                     m=tqp.m, kappa=tqp.kappa)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_emulated_tail_solve_near_fp32_plain(qps, solver, schedule, start):
    _, tqp = qps
    x0s, U0 = _inputs(start == "warm")
    x0s, U0 = torch.from_numpy(x0s), None if U0 is None else torch.from_numpy(U0)
    coarse = _coarse(tqp, solver, schedule)
    got = _emulated(tqp, solver, x0s, -1.0, 1.0, coarse, U0)
    ref = _plain(tqp, solver, x0s, -1.0, 1.0, coarse, U0)
    assert _err(got[0], ref[0]) <= 2e-6
    for a, b in zip(got[1:], ref[1:]):
        assert abs(float(a) - float(b)) <= 2e-6


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_emulated_tail_solve_no_further_from_float64(qps, solver, start):
    """All-fp32 schedule: the 6-pass solve within 1.5x of the fp32 plain
    solve's distance from the same algorithm run in float64."""
    _, tqp = qps
    x0s, U0 = _inputs(start == "warm")
    x0s, U0 = torch.from_numpy(x0s), None if U0 is None else torch.from_numpy(U0)
    got = _emulated(tqp, solver, x0s, -1.0, 1.0, 0, U0)[0]
    ref = _plain(tqp, solver, x0s, -1.0, 1.0, 0, U0)[0]
    exact = _plain(_float64(tqp), solver, x0s.double(), -1.0, 1.0, 0,
                   None if U0 is None else U0.double())[0]
    assert _err(got, exact) <= 1.5 * _err(ref, exact)


@pytest.mark.parametrize("jax_classes", ["highest", "jax_defaults"])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("schedule", ["fp32", "default"])
@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_emulated_tail_solve_matches_jax_kernel(qps, solver, schedule, start, jax_classes):
    """Against fista_mpc_pallas_res / admm_mpc_pallas_res in interpret mode,
    at the box +-0.5 of tests/test_torch_boxqp_kernels.py and its
    tolerances: 1e-5 all-fp32, 1e-4 at the default schedule (JAX on the CPU
    runs its coarse products in fp32). The JAX kernels run at their
    "highest" classes (FISTA's tail and g, ADMM's c; ADMM's tail is bf16x3
    there) or at their defaults."""
    jqp, tqp = qps
    lo, hi = -0.5, 0.5
    x0s, U0 = _inputs(start == "warm")
    coarse = _coarse(tqp, solver, schedule)
    args = (jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(lo), jnp.float32(hi))
    kw = dict(iters=ITERS, coarse_iters=coarse, tile_n=16, interpret=True,
              U0=None if U0 is None else jnp.asarray(U0))
    if solver == "fista":
        if jax_classes == "highest":
            kw.update(tail_precision="highest", g_precision="highest")
        want = fista_mpc_pallas_res(*args, jqp.lipschitz, **kw)
    else:
        if jax_classes == "highest":
            kw.update(c_precision="highest")
        want = admm_mpc_pallas_res(*args, jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12)),
                                   over_relax=ALPHA, **kw)
    got = _emulated(tqp, solver, torch.from_numpy(x0s), lo, hi, coarse,
                    None if U0 is None else torch.from_numpy(U0))
    tol = 1e-5 if coarse == 0 else 1e-4
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=tol)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=0, atol=tol)
