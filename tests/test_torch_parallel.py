"""numpower_tpu_torch.parallel (mesh, distributed, sharding) and
MPCController(mesh=...) against the JAX package's sharded solvers (CPU).

Two runs of the port: in this process at world size 1 (gloo over a FileStore
in a temporary directory, so no port is opened; the group is destroyed when
the module's tests end), and one spawned run at world size 4 (gloo, meshes
(4, 1) and (2, 2)), whose ranks write their blocks to files. The spawned
ranks import this module, which imports JAX only inside the fixtures that
compute the reference, so they never load it (checked). The JAX results come
from the 8-device virtual CPU mesh of tests/conftest.py, on the identical QP
(carried over with condensed_from_jax); the blocks the ranks return are put
together in mesh order and compared with them.

Bounds: the DP, DP x TP and ADMM-DP solvers (kernel and plain routes)
against the JAX ones 1e-4 (the kernel routes run the default bf16 + fp32
schedule: JAX on the CPU forms the coarse products in fp32, the port rounds
their operands to bf16); the DP kernel route against the port's direct
fista_mpc_res 1e-5 (the bound of the verify check sharded_solvers_on_mesh);
ADMM-DP against FISTA-DP 2e-3 (two solvers of one QP); the statistics and
the Kalman blocks as tests/test_parallel.py; the mesh controller against the
single-device one 1e-5 and against JAX's mesh controller 1e-4.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import MPCController
from numpower_tpu_torch.models.condensed import condensed_from_jax, default_coarse_iters
from numpower_tpu_torch.parallel import (
    data_sharding, distributed, kalman_filter_batched_dp, kalman_smoother_batched_dp,
    make_mesh, model_sharding, place, replicated, shard_batch, solve_mpc_boxqp_admm_dp,
    solve_mpc_boxqp_dp, solve_mpc_boxqp_dp_tp, sweep_statistics_dp,
)

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
T_QP, N, ITERS, PLAIN_ITERS = 8, 32, 40, 50  # d = 32: splits into 2 column blocks
CTRL = dict(horizon=12, u_lo=-1.0, u_hi=1.0, coarse_iters=0)
CTRL_ITERS = {"fista": 80, "admm": 60}  # as tests/test_parallel.py's mesh controllers
N_CTRL, TICKS = 16, 5
WORLD, SPAWN_TIMEOUT_S = 4, 300
# parts of a result that every rank holds whole (all_reduced); the rest are blocks
GLOBAL_PARTS = ("residual", "rp", "rd", "mean", "max_dev", "ll")


def _problem_arrays():
    """The numpy inputs of every case (the QP comes from the JAX package)."""
    rng = np.random.default_rng(0)
    di_A, di_B = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32), np.array([[0.005], [0.1]],
                                                                           np.float32)
    return {
        "x0s": (0.3 * rng.standard_normal((N, 12))).astype(np.float32),
        "U0": (0.3 * rng.standard_normal((N, 4 * T_QP))).astype(np.float32),
        "xs": rng.standard_normal((N, 9, 12)).astype(np.float32),
        "kf_x0s": rng.standard_normal((N, 2)).astype(np.float32),
        "kf_yss": rng.standard_normal((N, 20, 1)).astype(np.float32),
        "di_A": di_A, "di_B": di_B,
        "ctrl_x": rng.standard_normal((N_CTRL, 2)).astype(np.float32),
    }


def _kf_mats(prob):
    return (prob["di_A"], np.array([[1.0, 0.0]], np.float32), np.eye(2, dtype=np.float32) * 1e-3,
            np.eye(1, dtype=np.float32) * 1e-2, np.eye(2, dtype=np.float32) * 0.1)


def _ctrl_costs():
    return (np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32) * 0.1,
            np.eye(2, dtype=np.float32) * 10.0)


def _blocks(mesh, prob, which):
    """This rank's results on ``mesh``: {case: {part: tensor}}, the blocks'
    leading dimension the rank's scenarios."""
    qp = condensed_from_jax({f: prob[f] for f in FIELDS}, T=T_QP, n=12, m=4,
                            kappa=float(prob["kappa"]), device=mesh.device)
    x0s, U0 = shard_batch(prob["x0s"], mesh), shard_batch(prob["U0"], mesh)
    out = {}

    def box(name, r):
        out[name] = {"U": r.U, "residual": r.residual}

    def admm(name, r):
        out[name] = {"U": r.U, "rp": r.primal_residual, "rd": r.dual_residual}

    if "tp" in which:
        box("tp_kernel", solve_mpc_boxqp_dp_tp(qp, x0s, -1.0, 1.0, mesh, ITERS, method="kernel"))
        box("tp_plain", solve_mpc_boxqp_dp_tp(qp, x0s, -1.0, 1.0, mesh, PLAIN_ITERS,
                                              method="plain"))
    if "dp" not in which:
        return out
    box("dp_kernel", solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, ITERS, method="kernel"))
    box("dp_kernel_warm", solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, ITERS, method="kernel",
                                             U0=U0))
    box("dp_plain", solve_mpc_boxqp_dp(qp, x0s, -1.0, 1.0, mesh, PLAIN_ITERS, method="plain"))
    admm("admm_kernel", solve_mpc_boxqp_admm_dp(qp, x0s, -1.0, 1.0, mesh, iters=ITERS,
                                                method="kernel"))
    admm("admm_plain_warm", solve_mpc_boxqp_admm_dp(qp, x0s, -1.0, 1.0, mesh, iters=ITERS,
                                                    method="plain", U0=U0))
    mean, max_dev = sweep_statistics_dp(shard_batch(prob["xs"], mesh), mesh)
    out["sweep"] = {"mean": mean, "max_dev": max_dev}
    A, C, Q, R, P0 = _kf_mats(prob)
    res, ll = kalman_filter_batched_dp(A, C, Q, R, shard_batch(prob["kf_x0s"], mesh), P0,
                                       shard_batch(prob["kf_yss"], mesh), mesh)
    sm = kalman_smoother_batched_dp(A, res, mesh)
    out["kf"] = {"means": res.means, "ll": ll, "sm_means": sm.means, "sm_covs": sm.covs}
    for solver, iters in CTRL_ITERS.items():
        ctrl = MPCController(prob["di_A"], prob["di_B"], *_ctrl_costs(), iters=iters,
                             solver=solver, mesh=mesh, **CTRL)
        state, x, us = ctrl.init(N_CTRL), shard_batch(prob["ctrl_x"], mesh), []
        for _ in range(TICKS):
            u0, state = ctrl.step(state, x)
            us.append(u0.clone())
            x = x @ torch.as_tensor(prob["di_A"]).T + u0 @ torch.as_tensor(prob["di_B"]).T
        out[f"ctrl_{solver}"] = {"u0": torch.stack(us, dim=1)}  # (N_local, ticks, m)
    return out


def _assemble(per_rank):
    """{case: {part: global array}} from [(coords, blocks)] of every rank:
    blocks concatenated in data order; whole parts, and the copies of a
    block along the model axis, must agree on every rank."""
    data_len = max(c[0] for c, _ in per_rank) + 1
    first = {c[0]: out for c, out in per_rank if c[1] == 0}
    result = {}
    for case, parts in per_rank[0][1].items():
        result[case] = {}
        for part, value in parts.items():
            for c, out in per_rank:
                if part in GLOBAL_PARTS:
                    assert torch.equal(out[case][part], value), (case, part, c)
                else:
                    assert torch.equal(out[case][part], first[c[0]][case][part]), (case, part, c)
            if part in GLOBAL_PARTS:
                result[case][part] = value.numpy()
            else:
                result[case][part] = torch.cat([first[i][case][part]
                                                for i in range(data_len)]).numpy()
    return result


def _rank_main(rank, world, tmp):
    """One rank of the spawned world: both meshes, blocks to files."""
    torch.set_num_threads(1)
    prob = dict(np.load(os.path.join(tmp, "problem.npz")))
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        for name, shape, which in (("dp", (4, 1), ("dp",)), ("tp", (2, 2), ("tp",))):
            mesh = make_mesh(shape)
            torch.save((mesh.coords, _blocks(mesh, prob, which)),
                       os.path.join(tmp, f"{name}{rank}.pt"))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "numpower_tpu"))
        torch.save(loaded, os.path.join(tmp, f"modules{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The inputs, with the JAX package's condensed QP, also as a file for
    the spawned ranks."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from numpower_tpu.models import condense, quadrotor12

    A, B = quadrotor12(0.02)
    jqp = condense(jnp.asarray(A), jnp.asarray(B), jnp.eye(12), jnp.eye(4) * 0.1,
                   jnp.eye(12) * 5.0, T_QP)
    prob = _problem_arrays()
    prob.update({f: np.asarray(getattr(jqp, f)) for f in FIELDS})
    prob["kappa"] = np.asarray(jqp.kappa)
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "problem.npz", **prob)
    return prob, jqp, tmp


@pytest.fixture(scope="module")
def jax_results(problem):
    """The JAX package's sharded solvers on its 8-device virtual CPU mesh."""
    import jax.numpy as jnp

    from numpower_tpu.models import MPCController as JaxController
    from numpower_tpu.parallel import make_mesh as jax_mesh
    from numpower_tpu.parallel import shard_batch as jax_shard
    from numpower_tpu.parallel import (
        solve_mpc_boxqp_admm_dp as j_admm, solve_mpc_boxqp_dp as j_dp,
        solve_mpc_boxqp_dp_tp as j_tp, sweep_statistics_dp as j_sweep,
    )
    from numpower_tpu.parallel.sharding import (
        kalman_filter_batched_dp as j_kf, kalman_smoother_batched_dp as j_ks,
    )

    prob, jqp, _ = problem
    m41, m22 = jax_mesh((4, 1)), jax_mesh((2, 2))
    x0s = jax_shard(jnp.asarray(prob["x0s"]), m41)
    U0 = jax_shard(jnp.asarray(prob["U0"]), m41)
    out = {}

    def box(name, r):
        out[name] = {"U": np.asarray(r.U), "residual": np.asarray(r.residual)}

    def admm(name, r):
        out[name] = {"U": np.asarray(r.U), "rp": np.asarray(r.primal_residual),
                     "rd": np.asarray(r.dual_residual)}

    box("dp_kernel", j_dp(jqp, x0s, -1.0, 1.0, m41, ITERS, method="pallas"))
    box("dp_kernel_warm", j_dp(jqp, x0s, -1.0, 1.0, m41, ITERS, method="pallas", U0=U0))
    box("dp_plain", j_dp(jqp, x0s, -1.0, 1.0, m41, PLAIN_ITERS, method="xla"))
    box("tp_kernel", j_tp(jqp, jnp.asarray(prob["x0s"]), -1.0, 1.0, m22, ITERS, method="pallas"))
    box("tp_plain", j_tp(jqp, jnp.asarray(prob["x0s"]), -1.0, 1.0, m22, PLAIN_ITERS,
                         method="xla"))
    admm("admm_kernel", j_admm(jqp, x0s, -1.0, 1.0, m41, iters=ITERS, method="pallas"))
    admm("admm_plain_warm", j_admm(jqp, x0s, -1.0, 1.0, m41, iters=ITERS, method="xla", U0=U0))
    mean, max_dev = j_sweep(jax_shard(jnp.asarray(prob["xs"]), m41), m41)
    out["sweep"] = {"mean": np.asarray(mean), "max_dev": np.asarray(max_dev)}
    A, C, Q, R, P0 = (jnp.asarray(M) for M in _kf_mats(prob))
    res, ll = j_kf(A, C, Q, R, jax_shard(jnp.asarray(prob["kf_x0s"]), m41), P0,
                   jax_shard(jnp.asarray(prob["kf_yss"]), m41), m41)
    sm = j_ks(A, res, m41)
    out["kf"] = {"means": np.asarray(res.means), "ll": np.asarray(ll),
                 "sm_means": np.asarray(sm.means), "sm_covs": np.asarray(sm.covs)}
    for solver, iters in CTRL_ITERS.items():
        ctrl = JaxController(prob["di_A"], prob["di_B"], *_ctrl_costs(), iters=iters,
                             solver=solver, mesh=m41, **CTRL)
        state, x, us = ctrl.init(N_CTRL), jax_shard(jnp.asarray(prob["ctrl_x"]), m41), []
        for _ in range(TICKS):
            u0, state = ctrl.step(state, x)
            us.append(np.asarray(u0))
            x = x @ jnp.asarray(prob["di_A"]).T + u0 @ jnp.asarray(prob["di_B"]).T
        out[f"ctrl_{solver}"] = {"u0": np.stack(us, axis=1)}
    return out


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """The default process group of this process at world size 1."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("group1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world1(problem, group1):
    mesh = make_mesh((1, 1))
    return _assemble([(mesh.coords, _blocks(mesh, problem[0], ("dp", "tp")))])


@pytest.fixture(scope="module")
def world4(problem):
    tmp = str(problem[2])
    ranks = torch.multiprocessing.spawn(_rank_main, args=(WORLD, tmp), nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ranks.join(timeout=1.0):  # raises if a rank failed
        if time.monotonic() > deadline:
            for proc in ranks.processes:
                proc.kill()
            pytest.fail(f"the spawned ranks did not finish within {SPAWN_TIMEOUT_S} s")
    result = {}
    for name in ("dp", "tp"):
        result.update(_assemble([torch.load(os.path.join(tmp, f"{name}{r}.pt"))
                                 for r in range(WORLD)]))
    result["modules"] = [torch.load(os.path.join(tmp, f"modules{r}.pt")) for r in range(WORLD)]
    return result


@pytest.fixture(params=["world1", "world4"])
def port(request):
    return request.getfixturevalue(request.param)


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=tol)


@pytest.mark.parametrize("case", ["dp_kernel", "dp_kernel_warm", "dp_plain"])
def test_dp_matches_jax(port, jax_results, case):
    _close(port[case]["U"], jax_results[case]["U"], 1e-4)
    _close(port[case]["residual"], jax_results[case]["residual"], 1e-4)


def test_dp_kernel_route_matches_direct_kernel(port, problem):
    """The mirror of the verify check sharded_solvers_on_mesh: the DP
    kernel route equals the direct K2 solve of the whole batch."""
    prob = problem[0]
    qp = condensed_from_jax({f: prob[f] for f in FIELDS}, T=T_QP, n=12, m=4,
                            kappa=float(prob["kappa"]), device="cpu")
    U, resid = boxqp_fista.fista_mpc_res(qp.H, qp.Sx.T, qp.SuTQ.T, torch.from_numpy(prob["x0s"]),
                                         -1.0, 1.0, qp.lipschitz, ITERS,
                                         default_coarse_iters(qp, ITERS))
    _close(port["dp_kernel"]["U"], U.numpy(), 1e-5)
    _close(port["dp_kernel"]["residual"], resid.numpy(), 1e-5)


@pytest.mark.parametrize("case", ["tp_kernel", "tp_plain"])
def test_dp_tp_matches_jax(port, jax_results, case):
    _close(port[case]["U"], jax_results[case]["U"], 1e-4)
    _close(port[case]["residual"], jax_results[case]["residual"], 1e-4)


@pytest.mark.parametrize("case", ["admm_kernel", "admm_plain_warm"])
def test_admm_dp_matches_jax(port, jax_results, case):
    for part in ("U", "rp", "rd"):
        _close(port[case][part], jax_results[case][part], 1e-4)


def test_admm_dp_matches_fista_dp(port):
    """Two solvers of one strongly convex QP, at tests/test_parallel_1dev.py's
    bound."""
    _close(port["admm_kernel"]["U"], port["dp_kernel"]["U"], 2e-3)


def test_sweep_statistics_matches_jax(port, jax_results):
    for part in ("mean", "max_dev"):
        _close(port["sweep"][part], jax_results["sweep"][part], 1e-5, rtol=1e-4)


def test_kalman_dp_matches_jax(port, jax_results):
    got, want = port["kf"], jax_results["kf"]
    _close(got["means"], want["means"], 1e-5, rtol=1e-4)
    _close(got["ll"], want["ll"], 0.0, rtol=1e-5)
    _close(got["sm_means"], want["sm_means"], 1e-5, rtol=1e-4)
    _close(got["sm_covs"], want["sm_covs"], 1e-6, rtol=1e-4)


@pytest.mark.parametrize("solver", ["fista", "admm"])
def test_mesh_controller_matches_single_device_and_jax(port, jax_results, problem, solver):
    prob = problem[0]
    ctrl = MPCController(prob["di_A"], prob["di_B"], *_ctrl_costs(), iters=CTRL_ITERS[solver],
                         solver=solver, device="cpu", **CTRL)
    state, x, us = ctrl.init(N_CTRL), torch.from_numpy(prob["ctrl_x"]), []
    for _ in range(TICKS):
        u0, state = ctrl.step(state, x)
        us.append(u0.clone())
        x = x @ torch.as_tensor(prob["di_A"]).T + u0 @ torch.as_tensor(prob["di_B"]).T
    got = port[f"ctrl_{solver}"]["u0"]
    _close(got, torch.stack(us, dim=1).numpy(), 1e-5)
    _close(got, jax_results[f"ctrl_{solver}"]["u0"], 1e-4)


def test_spawned_ranks_never_import_jax(world4):
    assert world4["modules"] == [[]] * WORLD


def test_mesh_and_placement(group1):
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert mesh.coords == (0, 0) and mesh.device == torch.device("cpu")
    assert mesh.size(("data", "model")) == 1 and mesh.index("model") == 0
    with pytest.raises(ValueError):
        make_mesh((2, 1))
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    block = shard_batch(x, mesh)
    assert block.dtype == torch.float32 and torch.equal(block, torch.from_numpy(x))
    assert data_sharding(mesh) == ("data",) and replicated(mesh) == ()
    assert model_sharding(mesh, 1) == (None, "model")
    assert torch.equal(place(x, mesh, model_sharding(mesh, 1)), torch.from_numpy(x))


def test_distributed_helpers(group1):
    distributed.initialize()  # already initialized: nothing happens
    assert dist.get_world_size() == 1 and not distributed.is_multi_host()
    assert distributed.local_scenario_slice(10) == slice(0, 10)
    rep = distributed.scaling_report(1000.0, 900.0)
    assert rep["devices"] == 1 and abs(rep["efficiency"] - 0.9) < 1e-12


def test_initialize_without_a_cluster_runs_alone(monkeypatch):
    """Only the no-cluster-found case runs single-process: no launcher
    environment, no group; an explicit coordinator goes to
    init_process_group as it is given, and its failures propagate."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert calls == []
    distributed.initialize("localhost:29500", 2, 1, backend="gloo")
    assert calls == [(("gloo",), dict(init_method="tcp://localhost:29500", world_size=2,
                                      rank=1))]

    def refuse(*a, **k):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError):
        distributed.initialize("file:///nonexistent/store", 2, 0)


def test_dp_routes_and_options(group1, problem):
    """On a CPU mesh "auto" is the plain scan and launches nothing; the
    kernel route on a CPU block runs the kernel's plain version; an unknown
    method raises; mesh serving refuses x_ref."""
    prob = problem[0]
    mesh = make_mesh((1, 1))
    qp = condensed_from_jax({f: prob[f] for f in FIELDS}, T=T_QP, n=12, m=4,
                            kappa=float(prob["kappa"]), device="cpu")
    counters = (boxqp_fista.fista_mpc_res, boxqp_admm.admm_mpc_res)
    before = [c.launches for c in counters]
    auto = solve_mpc_boxqp_dp(qp, prob["x0s"], -1.0, 1.0, mesh, 12)
    plain = solve_mpc_boxqp_dp(qp, prob["x0s"], -1.0, 1.0, mesh, 12, method="plain")
    assert torch.equal(auto.U, plain.U)
    solve_mpc_boxqp_admm_dp(qp, prob["x0s"], -1.0, 1.0, mesh, iters=6, method="kernel")
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError):  # JAX's "pallas" is taken, this is not
        solve_mpc_boxqp_dp(qp, prob["x0s"], -1.0, 1.0, mesh, method="cuda")
    with pytest.raises(ValueError):
        MPCController(prob["di_A"], prob["di_B"], *_ctrl_costs(), mesh=mesh,
                      x_ref=np.zeros(2, np.float32), **CTRL)
