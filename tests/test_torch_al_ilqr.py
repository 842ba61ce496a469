"""models/al_ilqr.py of numpower_tpu_torch against the JAX package, on the
same numpy inputs (CPU).

The penalty terms and one backward pass are held tightly (1e-5, and rtol
1e-4 / atol 1e-5: the same fp32 formulas). Full solves are held to the JAX
package's cross-backend bounds for AL-iLQR (tests/test_solvers_extra.py, the
fused-against-vmap test): cost rtol 2e-3 and atol 1e-3, controls 5e-3 (two
line-search alphas can nearly tie, BASELINE.md:49), max_violation 5e-3
(tests/test_kernels.py:612-618). The fused backend's kernels run their plain
versions here; the JAX side runs its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.models import al_ilqr as jal  # noqa: E402
from numpower_tpu_torch.models import al_ilqr as tal  # noqa: E402

# the AL-iLQR bench problem (bench.py:524-544): pendulum swing-up, box +-2
QP = np.diag([1.0, 0.1]).astype(np.float32)
RP = np.eye(1, dtype=np.float32) * 0.01
QFP = np.diag([100.0, 10.0]).astype(np.float32)
GOAL = np.zeros(2, np.float32)
LO, HI = -2.0, 2.0
COST_BOUND = dict(rtol=2e-3, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x0s(N, seed=8):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (N, 2)).astype(np.float32)


def test_al_terms_match_jax():
    rng = np.random.default_rng(0)
    us = (3.0 * rng.standard_normal((3, 10, 1))).astype(np.float32)
    lam_hi = np.maximum(0.0, rng.standard_normal((3, 10, 1))).astype(np.float32)
    lam_lo = np.maximum(0.0, rng.standard_normal((3, 10, 1))).astype(np.float32)
    got = tal._al_terms(_t(us), _t(lam_hi), _t(lam_lo), torch.tensor(8.0), LO, HI)
    for i in range(3):
        want = jal._al_terms(us[i], lam_hi[i], lam_lo[i], jnp.float32(8.0), LO, HI)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_backward_pass_al_matches_jax():
    N, T = 3, 10
    rng = np.random.default_rng(1)
    x0s = jnp.asarray(_x0s(N))
    us = jnp.asarray((2.5 * rng.standard_normal((N, T, 1))).astype(np.float32))
    xs = jax.vmap(lambda a, b: jm.rollout_nonlinear(jm.pendulum_step, a, b))(x0s, us)
    As, Bs = jax.vmap(lambda x, u: jm.linearize_trajectory(jm.pendulum_step, x, u))(xs, us)
    lam = jnp.asarray(np.maximum(0.0, rng.standard_normal((N, T, 1))).astype(np.float32))
    _, lu_pen, luu_pen = jal._al_terms(us, lam, lam, jnp.float32(4.0), LO, HI)
    got = tal._backward_pass_al(_t(As), _t(Bs), _t(xs), _t(us), _t(QP), _t(RP), _t(QFP),
                                _t(GOAL), 1e-3, _t(lu_pen), _t(luu_pen))
    for i in range(N):
        want = jal._backward_pass_al(As[i], Bs[i], xs[i], us[i], QP, RP, QFP, GOAL, 1e-3,
                                     lu_pen[i], luu_pen[i])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_al_ilqr_solve_matches_jax():
    x0 = _x0s(1)[0]
    kw = dict(al_iters=2, ilqr_iters=3)
    want = jm.al_ilqr_solve(jm.pendulum_step, jnp.asarray(x0), QP, RP, QFP, GOAL, 12, LO, HI, **kw)
    got = tm.al_ilqr_solve(tm.pendulum_step, _t(x0), QP, RP, QFP, GOAL, 12, LO, HI, **kw)
    assert got.us.shape == (12, 1) and got.costs.shape == (2,) and got.max_violation.shape == ()
    np.testing.assert_allclose(float(got.cost), float(want.cost), **COST_BOUND)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), **COST_BOUND)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(got.max_violation), float(want.max_violation), atol=5e-3)
    assert float(got.us.abs().max()) <= HI


def test_al_ilqr_solve_batched_backends_match_jax():
    x0s = _x0s(4)
    kw = dict(al_iters=2, ilqr_iters=2)
    args = (QP, RP, QFP, GOAL, 10, LO, HI)
    want_v = jm.al_ilqr_solve_batched(jm.pendulum_step, jnp.asarray(x0s), *args, **kw)
    want_f = jm.al_ilqr_solve_batched(jm.pendulum_step, jnp.asarray(x0s), *args,
                                      backend="fused", interpret=True, **kw)
    got_v = tm.al_ilqr_solve_batched(tm.pendulum_step, _t(x0s), *args, **kw)
    got_f = tm.al_ilqr_solve_batched(tm.pendulum_step, _t(x0s), *args, backend="fused", **kw)
    got_p = tm.al_ilqr_solve_batched(tm.pendulum_step, _t(x0s), *args, backend="fused",
                                     forward="plain", **kw)
    assert torch.equal(got_f.us, got_p.us)  # K8's wrapper on the CPU is the plain rollout
    for got, want in ((got_v, want_v), (got_f, want_f)):
        assert got.us.shape == (4, 10, 1) and got.costs.shape == (4, 2)
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), **COST_BOUND)
        np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(got.max_violation.numpy(), np.asarray(want.max_violation),
                                   atol=5e-3)
        assert float(got.us.abs().max()) <= HI
    with pytest.raises(ValueError, match="backend"):
        tm.al_ilqr_solve_batched(tm.pendulum_step, _t(x0s), *args, backend="xla", **kw)


DEVICE_CALLS = {
    "al_ilqr_solve": lambda x0s: tm.al_ilqr_solve(
        tm.pendulum_step, x0s[0], QP, RP, QFP, GOAL, 4, -2.0, 2.0, al_iters=1, ilqr_iters=1),
    "al_ilqr_solve_batched_vmap": lambda x0s: tm.al_ilqr_solve_batched(
        tm.pendulum_step, x0s, QP, RP, QFP, GOAL, 4, -2.0, 2.0, al_iters=1, ilqr_iters=1),
    "al_ilqr_solve_batched_fused": lambda x0s: tm.al_ilqr_solve_batched(
        tm.pendulum_step, x0s, QP, RP, QFP, GOAL, 4, -2.0, 2.0, backend="fused", al_iters=1,
        ilqr_iters=1),
}


@pytest.mark.parametrize("call", list(DEVICE_CALLS.values()), ids=list(DEVICE_CALLS))
def test_entry_points_default_to_the_card(call):
    """A numpy state goes to the card as float32: without CUDA the call
    raises, because it reaches for it; CPU tensors keep the solve on the CPU."""
    x0s = _x0s(2)
    if torch.cuda.is_available():
        got = call(x0s)
        assert got.us.device.type == "cuda" and got.us.dtype == torch.float32
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(x0s)
    assert call(_t(x0s)).us.device.type == "cpu"
