"""The closed-loop simulation of numpower_tpu_torch (models/simulate.py)
against the JAX package's, on the CPU.

With the noise off (w_std = v_std = 0) both packages are deterministic, so
the loops are compared tick for tick on tests/test_simulate.py's double
integrator: LQR full-state feedback, and the output-feedback loop of a
Kalman estimator and the MPC controller; and on BASELINE config #4, the
quadrotor MPC controller in full-state feedback. With the noise on, the port's
generator makes the run reproducible from its seed.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402


@pytest.fixture(scope="module")
def di():
    A, B = jm.double_integrator(0.1)
    return np.asarray(A), np.asarray(B)


def _lti(A, B):
    A_t, B_t = torch.from_numpy(A), torch.from_numpy(B)
    return lambda x, u: x @ A_t.T + u @ B_t.T


def test_lqr_feedback_loop_matches_jax(di):
    """test_lqr_full_state_feedback_stabilizes' loop (three scenarios, 100
    ticks); states to 1e-5, the bound of the port's LQR parity
    (tests/test_torch_lqr.py)."""
    A, B = di
    K, _ = jm.lqr_infinite_gain(A, B, jnp.eye(2), jnp.eye(1) * 0.1)
    x0s = np.array([[2.0, 0.0], [-1.0, 0.5], [0.0, -2.0]], np.float32)
    want = jm.simulate_closed_loop(lambda x, u: A @ x + B @ u, jm.lqr_feedback(), K, x0s, 100)
    got = tm.simulate_closed_loop(_lti(A, B), tm.lqr_feedback(), torch.from_numpy(np.array(K)),
                                  torch.from_numpy(x0s), 100)
    assert got.xs.shape == (101, 3, 2) and got.us.shape == (100, 3, 1)
    assert got.ys is None and got.xhats is None
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=0, atol=1e-5)
    assert np.abs(got.xs[-1].numpy()).max() < 1e-2
    clipped = tm.simulate_closed_loop(_lti(A, B), tm.lqr_feedback(-0.5, 0.5),
                                      torch.from_numpy(np.array(K)), torch.from_numpy(x0s), 10)
    assert float(clipped.us.abs().max()) <= 0.5


def test_kalman_mpc_loop_matches_jax(di):
    """test_output_feedback_kalman_mpc's loop (N = 4, 80 ticks, horizon 15,
    position measured), noise off: the controls, true states, measurements
    and estimates tick for tick, within 1e-4, the port's controller-parity
    bound (tests/test_torch_mpc.py::test_controller_matches_jax)."""
    A, B = di
    C = np.array([[1.0, 0.0]], np.float32)
    Qn, Rn, P0 = (np.eye(2, dtype=np.float32) * 1e-4, np.eye(1, dtype=np.float32) * 1e-2,
                  np.eye(2, dtype=np.float32) * 0.5)
    costs = (np.eye(2, dtype=np.float32), 0.1 * np.eye(1, dtype=np.float32),
             10 * np.eye(2, dtype=np.float32))
    N = 4
    x0s = np.random.default_rng(0).uniform(-2, 2, (N, 2)).astype(np.float32)
    jctrl = jm.MPCController(A, B, *costs, horizon=15, u_lo=-1.0, u_hi=1.0, iters=30)
    make, update = jm.kalman_estimator(A, C, Qn, Rn, P0, B=B)
    want = jm.simulate_closed_loop(
        lambda x, u: A @ x + B @ u, jctrl.callback(), jctrl.callback_init(N), jnp.asarray(x0s),
        steps=80, h=lambda x: x[:1], estimator=update, est_state0=make(jnp.asarray(x0s)))
    tctrl = tm.MPCController(A, B, *costs, horizon=15, u_lo=-1.0, u_hi=1.0, iters=30,
                             device="cpu")
    make_t, update_t = tm.kalman_estimator(A, C, Qn, Rn, P0, B=B)
    x0 = torch.from_numpy(x0s)
    got = tm.simulate_closed_loop(_lti(A, B), tctrl.callback(), tctrl.callback_init(N), x0,
                                  steps=80, h=tm.first_components, estimator=update_t,
                                  est_state0=make_t(x0))
    assert got.ys.shape == (80, N, 1) and got.xhats.shape == (80, N, 2)
    for field in ("xs", "us", "ys", "xhats"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-4, err_msg=field)
    assert float(got.us.abs().max()) <= 1.0 + 1e-6


def test_config4_full_state_loop_matches_jax():
    """BASELINE config #4's controller (quadrotor12(0.02), horizon 30, box
    +-1, 30 iterations, FISTA) in full-state feedback with the noise off:
    64 scenarios from x0 = 0.3 N(0, 1) (seed 0), 100 ticks. The port's true
    states and controls match the JAX package's within 1e-4, the
    controller-parity bound. The mean state norm more than triples in both:
    the box binds, and the reference controller does the same."""
    Aj, Bj = jm.quadrotor12(0.02)
    A, B = np.asarray(Aj), np.asarray(Bj)
    costs = (np.eye(12, dtype=np.float32), 0.1 * np.eye(4, dtype=np.float32),
             5 * np.eye(12, dtype=np.float32))
    N, steps = 64, 100
    x0s = (0.3 * np.random.default_rng(0).standard_normal((N, 12))).astype(np.float32)
    jctrl = jm.MPCController(A, B, *costs, horizon=30, u_lo=-1.0, u_hi=1.0, iters=30)
    want = jm.simulate_closed_loop(lambda x, u: A @ x + B @ u, jctrl.callback(),
                                   jctrl.callback_init(N), jnp.asarray(x0s), steps=steps)
    tctrl = tm.MPCController(A, B, *costs, horizon=30, u_lo=-1.0, u_hi=1.0, iters=30,
                             device="cpu")
    got = tm.simulate_closed_loop(_lti(A, B), tctrl.callback(), tctrl.callback_init(N),
                                  torch.from_numpy(x0s), steps)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=0, atol=1e-4)
    norms = [np.linalg.norm(np.asarray(xs)[[0, -1]], axis=-1).mean(axis=-1)
             for xs in (want.xs, got.xs)]
    assert all(last > 3 * first for first, last in norms)


def _noisy_loop(di, generator):
    A, B = di
    K, _ = tm.lqr_infinite_gain(torch.from_numpy(A), B, np.eye(2, dtype=np.float32),
                                np.eye(1, dtype=np.float32) * 0.1)
    x0s = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    make, update = tm.kalman_estimator(A, np.array([[1.0, 0.0]], np.float32),
                                       np.eye(2, dtype=np.float32) * 1e-4,
                                       np.eye(1, dtype=np.float32) * 1e-2,
                                       np.eye(2, dtype=np.float32) * 0.5, B=B)
    return tm.simulate_closed_loop(_lti(A, B), tm.lqr_feedback(), K, x0s, 50,
                                   generator=generator, w_std=0.05, h=tm.first_components,
                                   v_std=0.05, estimator=update, est_state0=make(x0s))


def test_noise_is_reproducible_from_the_generator(di):
    """test_noise_is_reproducible_and_keyed, with a torch.Generator for the key."""
    r1 = _noisy_loop(di, torch.Generator().manual_seed(5))
    r2 = _noisy_loop(di, torch.Generator().manual_seed(5))
    r3 = _noisy_loop(di, torch.Generator().manual_seed(6))
    for field in ("xs", "us", "ys", "xhats"):
        assert torch.equal(getattr(r1, field), getattr(r2, field)), field
    assert not torch.allclose(r1.xs, r3.xs)
    # the default generator is seeded 0
    seeded_0 = _noisy_loop(di, torch.Generator().manual_seed(0))
    assert torch.equal(_noisy_loop(di, None).xs, seeded_0.xs)
    # noise keeps the state near but not at the origin
    tail = r1.xs[30:].abs().mean().item()
    assert 0 < tail < 0.5


def test_estimator_requires_a_measurement_model(di):
    make, update = tm.kalman_estimator(*di, np.eye(2), np.eye(2), np.eye(2))
    with pytest.raises(ValueError, match="measurement model"):
        tm.simulate_closed_loop(_lti(*di), tm.lqr_feedback(), torch.zeros((1, 2)),
                                torch.zeros((2, 2)), 3, estimator=update)
