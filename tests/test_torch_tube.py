"""models/tube.py of numpower_tpu_torch against the JAX package on the same
numpy inputs (CPU): tube_mpc_solve at N = 32 scenarios, T = 20, field by
field, on the identical condensed QP (carried over with condensed_from_jax).

Tolerance 1e-5 (absolute) on every field, the bound the JAX package's and the
port's FISTA solves are held to (tests/test_torch_mpc.py); the tube's own
properties as in tests/test_mpc.py:265-278.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")


@pytest.mark.parametrize("x_ref", [False, True], ids=["regulate", "x_ref"])
def test_tube_mpc_solve_matches_jax(x_ref):
    A, B = (np.asarray(x) for x in jm.quadrotor12(0.02))
    Q, R, QF = np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1, \
        np.eye(12, dtype=np.float32) * 5.0
    T = 20
    jqp = jm.condense(*(jnp.asarray(a) for a in (A, B, Q, R, QF)), T)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS}, T=T, n=jqp.n,
                             m=jqp.m, kappa=jqp.kappa, device="cpu")
    rng = np.random.default_rng(2)
    w = (0.001 * rng.standard_normal((32, T, 12))).astype(np.float32)
    x0 = (0.2 * rng.standard_normal(12)).astype(np.float32)
    ref = (0.1 * rng.standard_normal(12)).astype(np.float32) if x_ref else None

    want = jm.tube_mpc_solve(jqp, jnp.asarray(A), jnp.asarray(B), jnp.asarray(Q), jnp.asarray(R),
                             jnp.asarray(x0), jnp.asarray(w), -1.0, 1.0,
                             x_ref=None if ref is None else jnp.asarray(ref))
    got = tm.tube_mpc_solve(tqp, A, B, Q, R, torch.from_numpy(x0), torch.from_numpy(w), -1.0,
                            1.0, x_ref=None if ref is None else torch.from_numpy(ref))
    assert isinstance(got, tm.TubeMPCResult)
    for field in got._fields:
        g, wv = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == wv.shape, field
        np.testing.assert_allclose(g.numpy(), wv, rtol=0, atol=1e-5, err_msg=field)
    assert got.xs_scenarios.shape == (32, T + 1, 12)
    assert float(got.tube_radius[0]) == 0.0  # all scenarios start at x0
    assert float(got.max_violation) <= 1e-6  # feedback clipped to the bounds
    assert float(got.tube_radius.max()) < 0.5


@pytest.mark.parametrize("device", ["default", "cpu"])
def test_tube_inputs_follow_the_qp(device):
    """x0_nominal and the disturbances may be numpy arrays: they go to the
    QP's device. A QP condensed on the default device (the card) raises
    without CUDA, because it reaches for it; a CPU QP runs on the CPU."""
    A, B = (np.asarray(x) for x in jm.double_integrator(0.1))
    Q, R, QF = np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32) * 0.1, \
        np.eye(2, dtype=np.float32) * 10.0
    T = 8
    w = (0.01 * np.random.default_rng(3).standard_normal((4, T, 2))).astype(np.float32)
    x0 = np.array([0.5, 0.0], np.float32)

    def solve():
        qp = tm.condense(A, B, Q, R, QF, T, **({} if device == "default" else {"device": "cpu"}))
        return tm.tube_mpc_solve(qp, A, B, Q, R, x0, w, -1.0, 1.0)

    if device == "default" and not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            solve()
        return
    got = solve()
    assert got.xs_scenarios.shape == (4, T + 1, 2)
    assert got.xs_scenarios.device.type == ("cpu" if device == "cpu" else "cuda")
    assert float(got.max_violation) <= 1e-6
