"""numpower_tpu_torch.models.{plants,condensed} against the JAX package on the
same numpy inputs (CPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from numpower_tpu.models import condensed as jc  # noqa: E402
from numpower_tpu.models import plants as jp  # noqa: E402
from numpower_tpu_torch.models import condensed as tc  # noqa: E402
from numpower_tpu_torch.models import plants as tp  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")


def _costs(n, m, r, qf):
    return (np.eye(n, dtype=np.float32), np.eye(m, dtype=np.float32) * r,
            np.eye(n, dtype=np.float32) * qf)


# (plant name, horizon, R scale, QF scale): the quadrotor flagship costs of
# bench.py and the double-integrator costs of BASELINE config #1
CASES = {
    "quadrotor12-T10": ("quadrotor12", 10, 0.1, 5.0),
    "quadrotor12-T30": ("quadrotor12", 30, 0.1, 5.0),
    "double_integrator-T30": ("double_integrator", 30, 0.1, 100.0),
}


def _both(case):
    name, T, r, qf = CASES[case]
    A, B = getattr(jp, name)()
    Q, R, QF = _costs(A.shape[0], B.shape[1], r, qf)
    jqp = jc.condense(jnp.asarray(A), jnp.asarray(B), jnp.asarray(Q), jnp.asarray(R),
                      jnp.asarray(QF), T)
    tqp = tc.condense(*getattr(tp, name)(), Q, R, QF, T, device="cpu")
    return jqp, tqp


@pytest.mark.parametrize("name", ["quadrotor12", "double_integrator"])
def test_plants_match_jax(name):
    jA, jB = getattr(jp, name)()
    plant = getattr(tp, name)()
    np.testing.assert_array_equal(plant.A, jA)
    np.testing.assert_array_equal(plant.B, jB)
    x = np.ones(plant.n, np.float32)
    u = np.ones(plant.m, np.float32)
    stepped = plant.step(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_allclose(stepped.numpy(), jA @ x + jB @ u, rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_condense_matches_jax(case):
    jqp, tqp = _both(case)
    assert (tqp.T, tqp.n, tqp.m) == (jqp.T, jqp.n, jqp.m)
    for f in ("H", "Sx", "Su", "SuTQ"):
        np.testing.assert_allclose(getattr(tqp, f).numpy(), np.asarray(getattr(jqp, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("lipschitz", "mu"):
        np.testing.assert_allclose(float(getattr(tqp, f)), float(getattr(jqp, f)),
                                   rtol=1e-5, err_msg=f)
    assert tqp.kappa == pytest.approx(jqp.kappa, rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_coarse_schedules_match_jax(case):
    jqp, tqp = _both(case)
    for iters in (30, 40, 60):
        assert tc.default_coarse_iters(tqp, iters) == jc.default_coarse_iters(jqp, iters)
        assert tc.admm_coarse_iters(tqp, iters) == jc.admm_coarse_iters(jqp, iters)


@pytest.mark.parametrize("case", list(CASES))
def test_condensed_from_jax_round_trips(case):
    jqp, _ = _both(case)
    arrays = {f: np.asarray(getattr(jqp, f)) for f in FIELDS}
    qp = tc.condensed_from_jax(arrays, T=jqp.T, n=jqp.n, m=jqp.m, kappa=jqp.kappa,
                               device="cpu")
    for f in FIELDS:
        back = getattr(qp, f).numpy()
        assert back.dtype == arrays[f].dtype and back.shape == arrays[f].shape
        np.testing.assert_array_equal(back, arrays[f], err_msg=f)
    assert (qp.T, qp.n, qp.m, qp.kappa) == (jqp.T, jqp.n, jqp.m, jqp.kappa)


@pytest.mark.parametrize("x0_rank,x_ref_rank", [(2, None), (1, None), (2, 1), (1, 2)])
def test_gradient_offset_matches_jax(x0_rank, x_ref_rank):
    jqp, _ = _both("quadrotor12-T10")
    qp = tc.condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                               T=jqp.T, n=jqp.n, m=jqp.m, kappa=jqp.kappa, device="cpu")
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((8, 12) if x0_rank == 2 else (12,)).astype(np.float32)
    x_ref = None
    if x_ref_rank is not None:
        x_ref = rng.standard_normal((12,) if x_ref_rank == 1 else (10, 12)).astype(np.float32)
    want = jc.gradient_offset(jqp, jnp.asarray(x0),
                              None if x_ref is None else jnp.asarray(x_ref))
    got = tc.gradient_offset(qp, torch.from_numpy(x0),
                             None if x_ref is None else torch.from_numpy(x_ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
