"""models/lqr.py and utils/associative_scan.py of numpower_tpu_torch against
the JAX package on the same numpy inputs (CPU).

Tolerances are those of the JAX package's own tests of the same functions
(tests/test_mpc.py): the Riccati gains rtol 1e-3 / atol 1e-4 and the
cost-to-go 1e-3 where the engines differ in their order of operations
(associative against sequential), and 1e-4 where both run the same
recurrence; the LQR controls rtol 1e-3 / atol 1e-4 and, for the batched
rollout, rtol 1e-5 / atol 1e-6 against the single solve.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.models.lqr import route_riccati_per_scenario  # noqa: E402
from numpower_tpu_torch.utils.associative_scan import associative_scan  # noqa: E402


def _di(QF=10.0):
    A, B = jm.double_integrator(0.1)
    return (np.asarray(A), np.asarray(B), np.eye(2, dtype=np.float32),
            np.eye(1, dtype=np.float32) * 0.1, np.eye(2, dtype=np.float32) * QF)


def _quad():
    A, B = jm.quadrotor12(0.02)
    return (np.asarray(A), np.asarray(B), np.eye(12, dtype=np.float32),
            np.eye(4, dtype=np.float32) * 0.1, np.eye(12, dtype=np.float32) * 5.0)


def _cpu(arrays):
    """The port's operands: numpy inputs would go to the card, the port's default."""
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_riccati_scan_matches_jax():
    sys_ = _di()
    Ks, Ps = tm.riccati_scan(*_cpu(sys_), 30)
    Ks_j, Ps_j = jm.riccati_scan(*sys_, 30)
    assert Ks.shape == (30, 1, 2) and Ps.shape == (31, 2, 2)
    _close(Ks, Ks_j, 1e-4, 1e-4)
    _close(Ps, Ps_j, 1e-4, 1e-3)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "associative"])
def test_lqr_solve_config1_matches_jax(parallel):
    sys_ = _di(QF=100.0)  # BASELINE config #1 (bench.py:316-319)
    x0 = np.array([1.0, 0.0], np.float32)
    us, xs = tm.lqr_solve(*_cpu(sys_), x0, 30, parallel=parallel)
    us_j, xs_j = jm.lqr_solve(*sys_, jnp.asarray(x0), 30, parallel=parallel)
    assert us.shape == (30, 1) and xs.shape == (31, 2)
    _close(us, us_j, 1e-3, 1e-4)
    _close(xs, xs_j, 1e-3, 1e-4)
    assert float(xs[-1].norm()) < 5e-2


def test_lqr_solve_batched_config2_matches_jax():
    sys_ = _di(QF=100.0)
    x0s = np.random.default_rng(1).standard_normal((16, 2)).astype(np.float32)
    us, xs = tm.lqr_solve_batched(*_cpu(sys_), x0s, 30)
    us_j, xs_j = jm.lqr_solve_batched(*sys_, jnp.asarray(x0s), 30)
    assert us.shape == (16, 30, 1) and xs.shape == (16, 31, 2)
    _close(us, us_j, 1e-3, 1e-4)
    _close(xs, xs_j, 1e-3, 1e-4)
    us0, _ = tm.lqr_solve(*_cpu(sys_), x0s[0], 30)
    torch.testing.assert_close(us[0], us0, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("refs", ["ramp", "zero"])
def test_lqt_solve_matches_jax(refs):
    sys_ = _di()
    T = 12
    x0 = np.array([0.5, -0.2], np.float32)
    x_refs = np.zeros((T + 1, 2), np.float32)
    if refs == "ramp":
        x_refs[:, 0] = 0.1 * np.arange(T + 1)
    us, xs = tm.lqt_solve(*_cpu(sys_), x0, x_refs, T)
    us_j, xs_j = jm.lqt_solve(*sys_, jnp.asarray(x0), jnp.asarray(x_refs), T)
    assert us.shape == (T, 1) and xs.shape == (T + 1, 2)
    _close(us, us_j, 1e-4, 1e-5)
    _close(xs, xs_j, 1e-4, 1e-5)
    if refs == "zero":
        torch.testing.assert_close(us, tm.lqr_solve(*_cpu(sys_), x0, T)[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("plant", ["double_integrator", "quadrotor"])
def test_lqr_infinite_gain_matches_jax(plant):
    A, B, Q, R, _ = _di() if plant == "double_integrator" else _quad()
    K, P = tm.lqr_infinite_gain(*_cpu((A, B, Q, R)))
    K_j, P_j = jm.lqr_infinite_gain(A, B, Q, R)
    _close(K, K_j, 1e-4, 1e-4)
    _close(P, P_j, 1e-4, 1e-3)
    assert np.max(np.abs(np.linalg.eigvals(A - B @ K.numpy()))) < 1.0


@pytest.mark.parametrize("nopivot", [False, True], ids=["pivoted", "nopivot"])
@pytest.mark.parametrize("T", [30, 64])
def test_riccati_associative_matches_jax(T, nopivot):
    sys_ = _quad()
    Ks, Ps = tm.riccati_associative(*_cpu(sys_), T, nopivot=nopivot)
    Ks_j, Ps_j = jm.riccati_associative(*sys_, T, nopivot=nopivot)
    assert Ks.shape == (T, 4, 12) and Ps.shape == (T + 1, 12, 12)
    _close(Ks, Ks_j, 1e-3, 1e-4)
    _close(Ps, Ps_j, 1e-3, 1e-3)
    Ks_seq, Ps_seq = tm.riccati_scan(*_cpu(sys_), T)
    torch.testing.assert_close(Ks, Ks_seq, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(Ps, Ps_seq, rtol=1e-3, atol=1e-3)


DEVICE_CALLS = {
    "riccati_scan": lambda s, x0: tm.riccati_scan(*s, 5),
    "riccati_associative": lambda s, x0: tm.riccati_associative(*s, 5),
    "lqr_solve": lambda s, x0: tm.lqr_solve(*s, x0, 5),
    "lqr_solve_batched": lambda s, x0: tm.lqr_solve_batched(*s, x0[None], 5),
    "lqt_solve": lambda s, x0: tm.lqt_solve(*s, x0, np.zeros((6, 2), np.float32), 5),
    "lqr_infinite_gain": lambda s, x0: tm.lqr_infinite_gain(*s[:4], iters=3),
}


@pytest.mark.parametrize("call", list(DEVICE_CALLS.values()), ids=list(DEVICE_CALLS))
def test_entry_points_default_to_the_card(call):
    """With numpy matrices (no tensor whose device to follow) the LQR entry
    points compute on the card: on a machine without CUDA they raise,
    because they reach for it; with CPU tensors they run on the CPU."""
    sys_, x0 = _di(), np.array([1.0, 0.0], np.float32)
    if torch.cuda.is_available():
        assert call(sys_, x0)[0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call(sys_, x0)
    assert call(_cpu(sys_), x0)[0].device.type == "cpu"


def _affine_combine(lib):
    """Composition of affine maps x -> F x + f, earlier first: non-commutative."""
    einsum = jnp.einsum if lib == "jax" else torch.einsum

    def fn(a, b):
        return b[0] @ a[0], einsum("tij,tj->ti", b[0], a[1]) + b[1]
    return fn


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [1, 2, 5, 13, 64])
def test_associative_scan_matches_jax_on_a_noncommutative_combine(T, reverse):
    rng = np.random.default_rng(T)
    F = np.linalg.qr(rng.standard_normal((T, 3, 3)))[0].astype(np.float32)  # bounded products
    f = rng.standard_normal((T, 3)).astype(np.float32)
    want = jax.lax.associative_scan(_affine_combine("jax"), (jnp.asarray(F), jnp.asarray(f)),
                                    reverse=reverse)
    got = associative_scan(_affine_combine("torch"), (torch.from_numpy(F), torch.from_numpy(f)),
                           reverse=reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [2, 3, 8, 13, 100])
def test_associative_scan_uses_jaxs_combine_tree(T, reverse):
    """A combine that is not associative in floating point gives the same
    bits only if the tree and the argument order are JAX's."""
    x = np.random.default_rng(T).standard_normal(T).astype(np.float32)
    want = jax.lax.associative_scan(lambda a, b: (1.1 * a[0] + 0.7 * b[0],), (jnp.asarray(x),),
                                    reverse=reverse)
    got = associative_scan(lambda a, b: (1.1 * a[0] + 0.7 * b[0],), (torch.from_numpy(x),),
                           reverse=reverse)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("bs", ["broadcast", "per_scenario"])
def test_riccati_scan_per_scenario_plain_matches_jax_xla(bs):
    A, B, Q, R, QF = _quad()
    N, rng = 8, np.random.default_rng(5)
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 12))).astype(np.float32)
    if bs == "broadcast":
        Bs_j = jnp.broadcast_to(jnp.asarray(B), (N, 12, 4))
        Bs_t = torch.from_numpy(B).expand(N, 12, 4)
    else:
        Bs_np = (np.tile(B, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 4))).astype(np.float32)
        Bs_j, Bs_t = jnp.asarray(Bs_np), torch.from_numpy(Bs_np)
    Ks, P0 = tm.riccati_scan_per_scenario(torch.from_numpy(As), Bs_t, Q, R, QF, 20, method="plain")
    Ks_j, P0_j = jm.riccati_scan_per_scenario(jnp.asarray(As), Bs_j, Q, R, QF, 20, method="xla")
    assert Ks.shape == (N, 20, 4, 12) and P0.shape == (N, 12, 12)
    _close(Ks, Ks_j, 1e-3, 1e-4)
    _close(P0, P0_j, 1e-3, 1e-3)
    Ks_0, Ps_0 = tm.riccati_scan(torch.from_numpy(As[3]), Bs_t[3], Q, R, QF, 20)
    torch.testing.assert_close(Ks[3], Ks_0, rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(P0[3], Ps_0[0], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("args,want", [
    (("cuda", 12, 4), "fused"),         # the quadrotor
    (("cuda", 2, 1), "fused"),          # the double integrator
    (("cuda", 48, 48), "fused"),        # the envelope's corner
    (("cuda", 17, 4), "fused"),         # past the narrow kernel: the wide one
    (("cuda", 12, 9), "fused"),
    (("cpu", 12, 4), "plain"),
    (("cpu", 12, 4, "fused"), "fused"),  # runs the kernel's plain version on the CPU
    (("cuda", 12, 4, "psd"), "psd"),
    (("cuda", 12, 4, "plain"), "plain"),
    (("cuda", 17, 4, "plain"), "plain"),
    (("cuda", 16, 8), "fused"),         # the narrow kernel's corner
    (("cuda", 48, 16), "fused"),        # the four-quadrotor formation
    (("cuda", 49, 4), "plain"),         # past the envelope
    (("cuda", 12, 49), "plain"),
    (("cuda", 48, 48, "psd"), "psd"),
    (("cuda", 49, 4, "plain"), "plain"),
])
def test_route_riccati_per_scenario(args, want):
    assert route_riccati_per_scenario(*args) == want


@pytest.mark.parametrize("args", [
    ("cuda", 12, 4, "cuda"),    # a name neither package knows
    ("cuda", 12, 49, "pallas"),  # JAX's name for "psd", outside the solve kernel's envelope
    ("cpu", 12, 4, "cholesky"),
    ("cuda", 49, 4, "fused"),   # explicit kernel routes outside the envelopes
    ("cuda", 12, 49, "fused"),
    ("cpu", 49, 4, "fused"),
    ("cuda", 49, 4, "psd"),
    ("cuda", 12, 49, "psd"),
    ("cuda", 49, 4, "pallas"),
])
def test_route_riccati_per_scenario_rejects(args):
    with pytest.raises(ValueError):
        route_riccati_per_scenario(*args)
