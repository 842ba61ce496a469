"""The condensed box-QP MPC path of numpower_tpu_torch as a whole, against
the JAX package on the same numpy inputs (CPU): the batched solvers, the
serving controller, the routing rule and the package's import boundary."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu_torch.kernels import boxqp_fista  # noqa: E402
from numpower_tpu_torch.models.admm import route_mpc_boxqp_admm  # noqa: E402
from numpower_tpu_torch.models.boxqp import route_mpc_boxqp  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
REPO = Path(__file__).resolve().parents[1]


def _costs():
    return (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
            np.eye(12, dtype=np.float32) * 5.0)


@pytest.fixture(scope="module")
def qps():
    A, B = jm.quadrotor12(0.02)
    jqp = jm.condense(*(jnp.asarray(a) for a in (A, B, *_costs())), 10)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                             T=10, n=jqp.n, m=jqp.m, kappa=jqp.kappa, device="cpu")
    return jqp, tqp


def _x0s(n_scen=24, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal((n_scen, 12))).astype(np.float32)


@pytest.mark.parametrize("method,variant", [
    ("fista", "cold"), ("fista", "warm"), ("fista", "x_ref"), ("fista", "single"),
    ("pg", "cold"), ("pg", "warm"),
])
def test_solve_mpc_boxqp_matches_jax(qps, method, variant):
    jqp, tqp = qps
    x0s = _x0s()
    if variant == "single":
        x0s = x0s[0]
    rng = np.random.default_rng(3)
    U0 = (0.3 * rng.standard_normal((24, 40))).astype(np.float32) if variant == "warm" else None
    x_ref = rng.standard_normal(12).astype(np.float32) * 0.2 if variant == "x_ref" else None
    to_j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    to_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jm.solve_mpc_boxqp(jqp, jnp.asarray(x0s), -0.5, 0.5, x_ref=to_j(x_ref),
                              iters=40, method=method, U0=to_j(U0))
    got = tm.solve_mpc_boxqp(tqp, torch.from_numpy(x0s), -0.5, 0.5, x_ref=to_t(x_ref),
                             iters=40, method=method, U0=to_t(U0))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=0, atol=1e-5)
    assert got.iterations == 40


def test_solve_mpc_boxqp_kernel_method_on_cpu_matches_jax_pallas(qps):
    """method="kernel" on a CPU tensor runs the plain version of the fused
    kernel, as the JAX package's method="pallas" runs its kernel in
    interpret mode off the TPU."""
    jqp, tqp = qps
    x0s = _x0s()
    want = jm.solve_mpc_boxqp(jqp, jnp.asarray(x0s), -1.0, 1.0, iters=40, method="pallas")
    got = tm.solve_mpc_boxqp(tqp, torch.from_numpy(x0s), -1.0, 1.0, iters=40,
                             method="kernel")
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["cold", "warm", "single"])
def test_solve_mpc_boxqp_admm_matches_jax(qps, variant):
    jqp, tqp = qps
    x0s = _x0s()
    if variant == "single":
        x0s = x0s[0]
    U0 = None
    if variant == "warm":
        U0 = (0.3 * np.random.default_rng(4).standard_normal((24, 40))).astype(np.float32)
    want = jm.solve_mpc_boxqp_admm(jqp, jnp.asarray(x0s), 0.1, 0.5, iters=40, method="xla",
                                   U0=None if U0 is None else jnp.asarray(U0))
    got = tm.solve_mpc_boxqp_admm(tqp, torch.from_numpy(x0s), 0.1, 0.5, iters=40,
                                  method="plain",
                                  U0=None if U0 is None else torch.from_numpy(U0))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.primal_residual), float(want.primal_residual),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.dual_residual), float(want.dual_residual),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_controller_matches_jax(solver):
    A, B = jm.quadrotor12(0.02)
    Q, R, QF = _costs()
    jctrl = jm.MPCController(A, B, Q, R, QF, horizon=10, u_lo=-0.5, u_hi=0.5, solver=solver)
    tctrl = tm.MPCController(A, B, Q, R, QF, horizon=10, u_lo=-0.5, u_hi=0.5, solver=solver,
                             device="cpu")
    assert tctrl.coarse_iters == jctrl.coarse_iters
    jstate, tstate = jctrl.init(32), tctrl.init(32)
    x = _x0s(32, seed=1)
    for tick in range(3):
        ju0, jstate, jres = jctrl.step_with_residual(jstate, jnp.asarray(x))
        tu0, tstate, tres = tctrl.step_with_residual(tstate, torch.from_numpy(x))
        np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tstate.U_prev.numpy(), np.asarray(jstate.U_prev),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(tres), float(jres), rtol=0, atol=1e-4)
        assert tstate.tick == int(jstate.tick) == tick + 1
        x = (x @ A.T + np.asarray(ju0) @ B.T).astype(np.float32)


def test_controller_reuses_the_state_buffer():
    A, B = tm.quadrotor12(0.02)
    ctrl = tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1, u_hi=1, device="cpu")
    state = ctrl.init(8)
    buf = state.U_prev.data_ptr()
    u0, state = ctrl.step(state, torch.from_numpy(_x0s(8)))
    assert state.U_prev.data_ptr() == buf and state.tick == 1
    assert u0.shape == (8, 4)
    fn = ctrl.callback()
    u0_cb, (qp, cb_state) = fn(ctrl.callback_init(8), torch.from_numpy(_x0s(8)), 0)
    assert qp is ctrl.qp and cb_state.tick == 1
    torch.testing.assert_close(u0_cb, u0, rtol=0, atol=0)


def test_controller_rejects_unported_and_invalid_options():
    A, B = tm.quadrotor12(0.02)
    # serving on a mesh (parallel/mesh.py) is the regulation solve: no x_ref
    with pytest.raises(ValueError):
        tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1, u_hi=1, mesh=object(),
                         x_ref=np.zeros(12, np.float32))
    with pytest.raises(ValueError):
        tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1, u_hi=1, solver="admm",
                         x_ref=np.zeros(12, np.float32))
    with pytest.raises(ValueError):
        tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1, u_hi=1, solver="osqp")


def test_controller_and_condense_default_to_the_card():
    """With no device named, the serving controller and condense (numpy
    inputs) build on the card: on a machine without CUDA they raise, because
    they reach for it; with device="cpu" both run on the CPU. A tensor input
    keeps its own device."""
    A, B = tm.quadrotor12(0.02)
    if torch.cuda.is_available():
        assert tm.condense(A, B, *_costs(), 10).H.device.type == "cuda"
        assert tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1,
                                u_hi=1).qp.H.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tm.condense(A, B, *_costs(), 10)
        with pytest.raises((RuntimeError, AssertionError)):
            tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1, u_hi=1)
    assert tm.condense(A, B, *_costs(), 10, device="cpu").H.device.type == "cpu"
    ctrl = tm.MPCController(A, B, *_costs(), horizon=10, u_lo=-1, u_hi=1, device="cpu")
    assert ctrl.qp.H.device.type == "cpu" and ctrl.init(4).U_prev.device.type == "cpu"
    assert tm.condense(torch.from_numpy(A), B, *_costs(), 10).H.device.type == "cpu"


@pytest.mark.parametrize("args,want", [
    (("cuda", 120, False, 2), "kernel"),          # the flagship shape
    (("cuda", boxqp_fista.MAX_D, False, 2), "kernel"),
    (("cuda", boxqp_fista.MAX_D + 1, False, 2), "fista"),  # above the envelope
    (("cuda", 1100, True, 2), "fista"),  # x_ref above the envelope
    (("cpu", 120, False, 2), "fista"),
    (("cpu", 120, True, 1), "fista"),
    (("cuda", 120, False, 2, "pg"), "pg"),
])
def test_route_mpc_boxqp(args, want):
    assert route_mpc_boxqp(*args) == want


@pytest.mark.parametrize("args,want", [
    (("cuda", 120, False, 2), "kernel"),
    (("cuda", boxqp_fista.MAX_D + 1, False, 2), "plain"),
    (("cuda", 120, False, 1), "plain"),
    (("cpu", 120, False, 2), "plain"),
])
def test_route_mpc_boxqp_admm(args, want):
    assert route_mpc_boxqp_admm(*args) == want


@pytest.mark.parametrize("route", [route_mpc_boxqp, route_mpc_boxqp_admm])
@pytest.mark.parametrize("args", [
    ("cuda", 120, True, 2),            # x_ref: the two-step kernel (K3)
    ("cuda", 120, False, 1, "kernel"),  # one x0 asked for on the kernel route: K3
    ("cpu", 120, True, 2, "kernel"),
])
def test_route_to_unported_kernel_raises(route, args):
    """The x_ref and single-x0 solves that once had no kernel now take the
    kernel route (the two-step kernels K3a/K3b) and raise nothing."""
    assert route(*args) == "kernel"


def test_route_rejects_unknown_method():
    # a name neither package knows ("pallas" and "xla" are the JAX package's:
    # tests/test_torch_jax_route_names.py)
    with pytest.raises(ValueError):
        route_mpc_boxqp("cpu", 120, False, 2, "cuda")
    with pytest.raises(ValueError):
        route_mpc_boxqp_admm("cpu", 120, False, 2, "cuda")


def test_import_leaves_jax_out():
    code = ("import sys, numpower_tpu_torch, numpower_tpu_torch.ops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'numpower_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_import_jax():
    paths = [*(REPO / "numpower_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    assert REPO / "numpower_tpu_torch" / "parallel" / "sharding.py" in paths
    assert REPO / "numpower_tpu_torch" / "ops" / "statistics.py" in paths
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "numpower_tpu"), (path, line)
