"""numpower_tpu_torch.parallel (mesh, distributed, sharding, solvers_dp,
sampling, riccati_sp, kalman_sp, pipeline) and MPCController(mesh=...)
against the JAX package's sharded solvers (CPU).

Two runs of the port: in this process at world size 1 (gloo over a FileStore
in a temporary directory, so no port is opened; the group is destroyed when
the module's tests end), and one spawned run at world size 4 (gloo, meshes
(4, 1), (2, 2) and (1, 4)), whose ranks write their blocks to files. The
box-QP and Kalman DP solvers run on (4, 1), DP x TP on (2, 2), the
horizon-sharded Riccati and Kalman filter and the pipeline on (1, 4) over the
model axis (ragged T of 7, 37 and 129, ragged (N, T) of (13, 30), (16, 37)
and (5, 7), as tests/test_parallel.py), the samplers on (4, 1) and (2, 2),
AL-iLQR and MHE on (4, 1); at world size 1 everything runs on (1, 1). The spawned
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
single-device one 1e-5 and against JAX's mesh controller 1e-4. The rest of
parallel/ at tests/test_parallel.py's bounds: Riccati Ks rtol 1e-4 / atol
1e-5 and Ps rtol 1e-4 / atol 1e-4, the Kalman moments rtol 1e-4 / atol 2e-4
and its log-likelihood 1e-4 max(1, |ll|), the pipeline rtol 1e-5 / atol
1e-6, all against the JAX functions on a (1, 4) mesh of its devices. The
samplers run twice: through their public entry points on a torch.Generator
(the mesh shapes (1, 1), (4, 1) and (2, 2) against each other and against
the single-device solvers, JAX's invariance bounds: MPPI us rtol 1e-4 /
atol 5e-5; the particle filter means rtol 1e-4 / atol 1e-5, ll rtol 1e-4),
and through their private cores on the JAX package's own draws against
JAX's mppi_solve_dp and particle_filter_dp (JAX's parity bounds). AL-iLQR
and MHE DP equal the port's single-device solvers within 1e-6 and match
JAX's DP solvers within the port's AL-iLQR twin bounds (us 5e-3, cost rtol
2e-3 / atol 1e-3) and tests/test_parallel.py's MHE bound (1e-4).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
from numpower_tpu_torch.models import (
    MPCController, al_ilqr_solve_batched, batched_rollout_lti, double_integrator, kalman_filter,
    mhe_solve,
    mppi_solve_batched, particle_filter, pendulum_step, quadratic_mppi_cost, riccati_scan,
)
from numpower_tpu_torch.models.condensed import condensed_from_jax, default_coarse_iters
from numpower_tpu_torch.parallel import (
    al_ilqr_solve_dp, data_sharding, distributed, kalman_filter_associative_sharded,
    kalman_filter_batched_dp, kalman_smoother_batched_dp, make_mesh, mhe_solve_dp, model_sharding,
    mppi_solve_dp, particle_filter_dp, place, replicated, riccati_associative_sharded,
    rollout_lti_pipelined, shard_batch, solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp,
    solve_mpc_boxqp_dp_tp, sweep_statistics_dp,
)
from numpower_tpu_torch.parallel.sampling import _mppi_dp_core, _particle_filter_dp_core

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
T_QP, N, ITERS, PLAIN_ITERS = 8, 32, 40, 50  # d = 32: splits into 2 column blocks
CTRL = dict(horizon=12, u_lo=-1.0, u_hi=1.0, coarse_iters=0)
CTRL_ITERS = {"fista": 80, "admm": 60}  # as tests/test_parallel.py's mesh controllers
N_CTRL, TICKS = 16, 5
WORLD, SPAWN_TIMEOUT_S = 4, 300
# parts of a result that every rank holds whole (all_reduced); the rest are blocks
GLOBAL_PARTS = ("residual", "rp", "rd", "mean", "max_dev", "ll", "pf_mean", "pf_cov", "pf_ess",
                "worst")
# the rest of parallel/: horizons and pipeline shapes (tests/test_parallel.py), the
# samplers' problems (tests/test_parallel.py's sampling tests)
SP_T, PP_SHAPES = (7, 37, 129), ((13, 30), (16, 37), (5, 7))
MPPI = dict(horizon=15, samples=64, iters=4, m=1, u_lo=-2.0, u_hi=2.0)
MPPI_SEED, N_MPPI, PF_SEED = 3, 16, 7
PF_CASES = {"pf": dict(T=20, N=256, threshold=0.5, key=7),   # PF_CASES keys: JAX keys of no
            "pf1": dict(T=10, N=64, threshold=1.0, key=1)}   # resampling tie (test_torch_particle)
AL = dict(al_iters=2, ilqr_iters=3)
PEND_COST = (np.diag([1.0, 0.1]).astype(np.float32), (np.eye(1) * 0.01).astype(np.float32),
             np.diag([100.0, 10.0]).astype(np.float32), np.zeros(2, np.float32))


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
        **{f"sp_ys{T}": rng.standard_normal((T, 1)).astype(np.float32) for T in SP_T},
        **{f"sp_us{T}": (0.2 * rng.standard_normal((T, 1))).astype(np.float32) for T in SP_T},
        **{f"pp_x0s{N}_{T}": rng.standard_normal((N, 2)).astype(np.float32)
           for N, T in PP_SHAPES},
        **{f"pp_us{N}_{T}": (0.1 * rng.standard_normal((N, T, 1))).astype(np.float32)
           for N, T in PP_SHAPES},
        "mppi_x0s": rng.uniform(-2, 2, (N_MPPI, 2)).astype(np.float32),
        **{f"{c}_ys": (0.3 * rng.standard_normal((PF_CASES[c]["T"], 1))).astype(np.float32)
           for c in PF_CASES},
        "al_x0s": rng.uniform(-1, 1, (16, 2)).astype(np.float32),
        "mhe_xp": rng.standard_normal((16, 2)).astype(np.float32),
        "mhe_yss": rng.standard_normal((16, 8, 1)).astype(np.float32),
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


def _pend_cost():
    return quadratic_mppi_cost(*PEND_COST)


def _h(x):
    return x[..., :1]


def _sp_blocks(mesh, prob):
    """This rank's horizon blocks on ``mesh`` (the model axis): the sharded
    Riccati and Kalman filter at each T, the pipeline at each (N, T)."""
    A, B = torch.from_numpy(prob["sp_A"]), torch.from_numpy(prob["sp_B"])
    out = {}
    for T in SP_T:
        Ks, Ps = riccati_associative_sharded(A, B, np.eye(2, dtype=np.float32),
                                             np.eye(1, dtype=np.float32) * 0.1,
                                             np.eye(2, dtype=np.float32) * 10.0, T, mesh)
        out[f"ric{T}"] = {"Ks": Ks, "Ps": Ps}
        A_kf, C, Q, R, P0 = (torch.from_numpy(M) for M in _kf_mats(prob))
        for tag, kw in (("", {}), ("_u", {"B": prob["di_B"], "us": prob[f"sp_us{T}"]})):
            r = kalman_filter_associative_sharded(A_kf, C, Q, R, torch.tensor([1.0, -0.3]), P0,
                                                  prob[f"sp_ys{T}"], mesh, **kw)
            out[f"kf{T}{tag}"] = {"means": r.means, "covs": r.covs, "pred_means": r.pred_means,
                                  "pred_covs": r.pred_covs, "ll": r.log_likelihood}
    for N, T in PP_SHAPES:
        xs = rollout_lti_pipelined(prob["di_A"], prob["di_B"],
                                   torch.from_numpy(prob[f"pp_x0s{N}_{T}"]),
                                   prob[f"pp_us{N}_{T}"], mesh)
        out[f"pp{N}_{T}"] = {"xs": xs}
    return out


def _pf_parts(r):
    return {"pf_mean": r.means, "pf_cov": r.covs, "pf_ess": r.ess, "ll": r.log_likelihood,
            "particles": r.particles}


def _sampler_blocks(mesh, prob, tag):
    """The samplers on ``mesh``: through their entry points on a
    torch.Generator, and through their private cores on the JAX package's
    draws (cases suffixed @tag)."""
    cost = _pend_cost()
    x0s = shard_batch(prob["mppi_x0s"], mesh)
    kw = dict(MPPI)
    horizon = kw.pop("horizon")
    r = mppi_solve_dp(pendulum_step, x0s, cost, horizon,
                      torch.Generator().manual_seed(MPPI_SEED), mesh, **kw)
    out = {f"mppi@{tag}": {"us": r.us, "cost": r.cost, "ess": r.ess}}
    n_loc, k_loc = x0s.shape[0], MPPI["samples"] // mesh.shape[1]
    rows = slice(mesh.coords[0] * n_loc, (mesh.coords[0] + 1) * n_loc)
    cols = slice(mesh.coords[1] * k_loc, (mesh.coords[1] + 1) * k_loc)
    r = _mppi_dp_core(pendulum_step, x0s, cost, torch.from_numpy(prob["mppi_eps"])[rows, :, cols],
                      mesh, "model", u_lo=MPPI["u_lo"], u_hi=MPPI["u_hi"])
    out[f"mppi_jax@{tag}"] = {"us": r.us, "cost": r.cost, "ess": r.ess}
    A, C, Q, R, P0 = _kf_mats(prob)
    for case, c in PF_CASES.items():
        args = (pendulum_step, _h, Q, R, torch.tensor([0.4, 0.0]), P0, prob[f"{case}_ys"],
                torch.zeros((c["T"], 1)))
        r = particle_filter_dp(*args, torch.Generator().manual_seed(PF_SEED), mesh,
                               n_particles=c["N"], resample_threshold=c["threshold"])
        out[f"{case}@{tag}"] = _pf_parts(r)
        n_loc = c["N"] // mesh.shape[0]
        rows = slice(mesh.coords[0] * n_loc, (mesh.coords[0] + 1) * n_loc)
        noise0, prop, u0s = (torch.tensor(prob[f"{case}_{d}"]) for d in ("noise0", "prop", "u0s"))
        mats = [torch.as_tensor(a, dtype=torch.float32) for a in args[2:]]
        r = _particle_filter_dp_core(*args[:2], *mats, noise0[rows], prop[:, rows], u0s, c["N"],
                                     mesh, "data", c["threshold"], "auto")
        out[f"{case}_jax@{tag}"] = _pf_parts(r)
    return out


def _dp2_blocks(mesh, prob):
    """AL-iLQR and MHE on the data axis."""
    r, worst = al_ilqr_solve_dp(pendulum_step, shard_batch(prob["al_x0s"], mesh), *PEND_COST, 20,
                                -2.0, 2.0, mesh, **AL)
    out = {"al": {"us": r.us, "cost": r.cost, "viol": r.max_violation, "worst": worst}}
    A, C, Q, R, P0 = _kf_mats(prob)
    r, worst = mhe_solve_dp(A, C, Q, R, P0, shard_batch(prob["mhe_xp"], mesh),
                            shard_batch(prob["mhe_yss"], mesh), mesh)
    out["mhe"] = {"xs": r.xs, "resid": r.primal_residual, "worst": worst}
    return out


def _assemble_model(per_rank):
    """{case: {part: global array}} from the horizon blocks of a (1, D)
    mesh: blocks concatenated in model order (the pipeline's along the
    horizon, dim 1), whole parts equal on every rank."""
    ranks = sorted(per_rank, key=lambda r: r[0][1])
    result = {}
    for case, parts in ranks[0][1].items():
        result[case] = {}
        for part, value in parts.items():
            if part in GLOBAL_PARTS:
                assert all(torch.equal(out[case][part], value) for _, out in ranks), (case, part)
                result[case][part] = value.numpy()
            else:
                result[case][part] = torch.cat([out[case][part] for _, out in ranks],
                                               dim=1 if part == "xs" else 0).numpy()
    return result


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
        for name, shape, blocks in (
                ("sp", (1, 4), lambda mesh: _sp_blocks(mesh, prob)),
                ("samp41", (4, 1), lambda mesh: _sampler_blocks(mesh, prob, "41")),
                ("samp22", (2, 2), lambda mesh: _sampler_blocks(mesh, prob, "22")),
                ("dp2", (4, 1), lambda mesh: _dp2_blocks(mesh, prob))):
            mesh = make_mesh(shape)
            torch.save((mesh.coords, blocks(mesh)), os.path.join(tmp, f"{name}{rank}.pt"))
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
    prob["sp_A"], prob["sp_B"] = (np.asarray(M, np.float32) for M in double_integrator(0.05))
    prob.update(_jax_draws())
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "problem.npz", **prob)
    return prob, jqp, tmp


def _jax_draws():
    """The JAX package's draws of the sampling DP solvers: mppi_solve_dp's
    (split(key, N), then split(scenario key, iters), normal((K, T, m))) as
    (N, iters, K, T, m), and particle_filter's (parallel/sampling.py's DP
    filter carries the same key chain) for each PF case."""
    import jax
    import jax.numpy as jnp

    K, T, m, iters = MPPI["samples"], MPPI["horizon"], MPPI["m"], MPPI["iters"]
    eps = [[np.asarray(jax.random.normal(k, (K, T, m), jnp.float32))
            for k in jax.random.split(sk, iters)]
           for sk in jax.random.split(jax.random.key(MPPI_SEED), N_MPPI)]
    out = {"mppi_eps": np.asarray(eps)}
    for case, c in PF_CASES.items():
        key, k_init = jax.random.split(jax.random.key(c["key"]))
        out[f"{case}_noise0"] = np.asarray(jax.random.normal(k_init, (c["N"], 2), jnp.float32))
        prop, u0s = [], []
        for _ in range(c["T"]):
            key, k_prop, k_res = jax.random.split(key, 3)
            prop.append(np.asarray(jax.random.normal(k_prop, (c["N"], 2), jnp.float32)))
            u0s.append(np.asarray(jax.random.uniform(k_res, (), jnp.float32)))
        out[f"{case}_prop"], out[f"{case}_u0s"] = np.stack(prop), np.asarray(u0s, np.float32)
    return out


@pytest.fixture(scope="module")
def jax_rest(problem):
    """The JAX package's rest of parallel/ on its virtual CPU mesh: the SP
    solvers and the pipeline on (1, 4), the DP samplers, AL-iLQR and MHE on
    (4, 1)."""
    import jax
    import jax.numpy as jnp

    from numpower_tpu.models import pendulum_step as j_pend
    from numpower_tpu.models import quadratic_mppi_cost as j_cost
    from numpower_tpu.parallel import (
        al_ilqr_solve_dp as j_al, kalman_filter_associative_sharded as j_kf_sp,
        make_mesh as jax_mesh, mhe_solve_dp as j_mhe, mppi_solve_dp as j_mppi,
        particle_filter_dp as j_pf, riccati_associative_sharded as j_ric,
        rollout_lti_pipelined as j_pp, shard_batch as jax_shard,
    )

    prob = problem[0]
    m14, m41 = jax_mesh((1, 4)), jax_mesh((4, 1))
    out = {}
    for T in SP_T:
        Ks, Ps = j_ric(jnp.asarray(prob["sp_A"]), jnp.asarray(prob["sp_B"]), jnp.eye(2),
                       jnp.eye(1) * 0.1, jnp.eye(2) * 10.0, T, m14)
        out[f"ric{T}"] = {"Ks": np.asarray(Ks), "Ps": np.asarray(Ps)}
        A, C, Q, R, P0 = (jnp.asarray(M) for M in _kf_mats(prob))
        for tag, kw in (("", {}), ("_u", {"B": jnp.asarray(prob["di_B"]),
                                          "us": jnp.asarray(prob[f"sp_us{T}"])})):
            r = j_kf_sp(A, C, Q, R, jnp.array([1.0, -0.3]), P0, jnp.asarray(prob[f"sp_ys{T}"]),
                        m14, **kw)
            out[f"kf{T}{tag}"] = {f: np.asarray(getattr(r, f)) for f in
                                  ("means", "covs", "pred_means", "pred_covs")}
            out[f"kf{T}{tag}"]["ll"] = np.asarray(r.log_likelihood)
    for N, T in PP_SHAPES:
        out[f"pp{N}_{T}"] = {"xs": np.asarray(j_pp(
            jnp.asarray(prob["di_A"]), jnp.asarray(prob["di_B"]),
            jnp.asarray(prob[f"pp_x0s{N}_{T}"]), jnp.asarray(prob[f"pp_us{N}_{T}"]), m14))}
    cost = j_cost(*(jnp.asarray(M) for M in PEND_COST))
    kw = dict(MPPI)
    horizon = kw.pop("horizon")
    r = j_mppi(j_pend, jax_shard(jnp.asarray(prob["mppi_x0s"]), m41), cost, horizon,
               jax.random.key(MPPI_SEED), m41, **kw)
    out["mppi"] = {"us": np.asarray(r.us), "cost": np.asarray(r.cost), "ess": np.asarray(r.ess)}
    A, C, Q, R, P0 = (jnp.asarray(M) for M in _kf_mats(prob))
    for case, c in PF_CASES.items():
        r = j_pf(j_pend, lambda x: x[:1], Q, R, jnp.array([0.4, 0.0]), P0,
                 jnp.asarray(prob[f"{case}_ys"]), jnp.zeros((c["T"], 1), jnp.float32),
                 jax.random.key(c["key"]), m41, n_particles=c["N"],
                 resample_threshold=c["threshold"])
        out[case] = {"pf_mean": np.asarray(r.means), "pf_cov": np.asarray(r.covs),
                     "pf_ess": np.asarray(r.ess), "ll": np.asarray(r.log_likelihood),
                     "particles": np.asarray(r.particles)}
    r, worst = j_al(j_pend, jax_shard(jnp.asarray(prob["al_x0s"]), m41),
                    *(jnp.asarray(M) for M in PEND_COST), 20, -2.0, 2.0, m41, **AL)
    out["al"] = {"us": np.asarray(r.us), "cost": np.asarray(r.cost),
                 "viol": np.asarray(r.max_violation), "worst": np.asarray(worst)}
    r, worst = j_mhe(A, C, Q, R, P0, jax_shard(jnp.asarray(prob["mhe_xp"]), m41),
                     jax_shard(jnp.asarray(prob["mhe_yss"]), m41), m41)
    out["mhe"] = {"xs": np.asarray(r.xs), "worst": np.asarray(worst)}
    return out


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
    mesh, prob = make_mesh((1, 1)), problem[0]
    result = _assemble([(mesh.coords, _blocks(mesh, prob, ("dp", "tp")))])
    result.update(_assemble_model([(mesh.coords, _sp_blocks(mesh, prob))]))
    result.update(_assemble([(mesh.coords, _sampler_blocks(mesh, prob, "11"))]))
    result.update(_assemble([(mesh.coords, _dp2_blocks(mesh, prob))]))
    return result


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
    for name in ("dp", "tp", "samp41", "samp22", "dp2"):
        result.update(_assemble([torch.load(os.path.join(tmp, f"{name}{r}.pt"))
                                 for r in range(WORLD)]))
    result.update(_assemble_model([torch.load(os.path.join(tmp, f"sp{r}.pt"))
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


# -- the rest of parallel/: SP, PP, the samplers, AL-iLQR and MHE ------------------------

PORT_MESHES = ["world1:11", "world4:41", "world4:22"]


@pytest.fixture(params=PORT_MESHES)
def port_mesh(request):
    """(the port's results of one run, the tag of one of its meshes)."""
    world, tag = request.param.split(":")
    return request.getfixturevalue(world), tag


@pytest.fixture(scope="module")
def single(problem):
    """The port's single-device solvers on the samplers' problems and draws."""
    prob = problem[0]
    kw = dict(MPPI)
    horizon = kw.pop("horizon")
    out = {"mppi": mppi_solve_batched(pendulum_step, torch.from_numpy(prob["mppi_x0s"]),
                                      _pend_cost(), horizon,
                                      torch.Generator().manual_seed(MPPI_SEED), method="xla",
                                      **kw)}
    _, _, Q, R, P0 = _kf_mats(prob)
    for case, c in PF_CASES.items():
        out[case] = particle_filter(pendulum_step, _h, Q, R, torch.tensor([0.4, 0.0]), P0,
                                    prob[f"{case}_ys"], torch.zeros((c["T"], 1)),
                                    torch.Generator().manual_seed(PF_SEED), n_particles=c["N"],
                                    resample_threshold=c["threshold"])
    return out


@pytest.mark.parametrize("T", SP_T)
def test_riccati_sharded_matches_jax_and_the_scan(port, jax_rest, problem, T):
    got, want = port[f"ric{T}"], jax_rest[f"ric{T}"]
    assert got["Ks"].shape == (T, 1, 2) and got["Ps"].shape == (T + 1, 2, 2)
    _close(got["Ks"], want["Ks"], 1e-5, rtol=1e-4)
    _close(got["Ps"], want["Ps"], 1e-4, rtol=1e-4)
    prob = problem[0]
    Ks, Ps = riccati_scan(torch.from_numpy(prob["sp_A"]), prob["sp_B"], np.eye(2, dtype=np.float32),
                          np.eye(1, dtype=np.float32) * 0.1, np.eye(2, dtype=np.float32) * 10.0, T)
    _close(got["Ks"], Ks.numpy(), 1e-5, rtol=1e-4)
    _close(got["Ps"], Ps.numpy(), 1e-4, rtol=1e-4)


@pytest.mark.parametrize("inputs", ["", "_u"])
@pytest.mark.parametrize("T", SP_T)
def test_kalman_sharded_matches_jax_and_the_filter(port, jax_rest, problem, T, inputs):
    got, want = port[f"kf{T}{inputs}"], jax_rest[f"kf{T}{inputs}"]
    prob = problem[0]
    A, C, Q, R, P0 = _kf_mats(prob)
    kw = {"B": prob["di_B"], "us": prob[f"sp_us{T}"]} if inputs else {}
    ref = kalman_filter(A, C, Q, R, torch.tensor([1.0, -0.3]), P0, prob[f"sp_ys{T}"], **kw)
    for field in ("means", "covs", "pred_means", "pred_covs"):
        assert got[field].shape[0] == T
        _close(got[field], want[field], 2e-4, rtol=1e-4)
        _close(got[field], getattr(ref, field).numpy(), 2e-4, rtol=1e-4)
    for ll in (float(want["ll"]), float(ref.log_likelihood)):
        assert abs(float(got["ll"]) - ll) <= 1e-4 * max(1.0, abs(ll))


@pytest.mark.parametrize("N,T", PP_SHAPES)
def test_pipelined_rollout_matches_jax_and_the_rollout(port, jax_rest, problem, N, T):
    got = port[f"pp{N}_{T}"]["xs"]
    prob = problem[0]
    ref = batched_rollout_lti(prob["di_A"], prob["di_B"],
                              torch.from_numpy(prob[f"pp_x0s{N}_{T}"]), prob[f"pp_us{N}_{T}"])
    assert got.shape == (N, T + 1, 2)
    _close(got, jax_rest[f"pp{N}_{T}"]["xs"], 1e-6, rtol=1e-5)
    _close(got, ref.numpy(), 1e-6, rtol=1e-5)


def test_mppi_dp_on_jax_draws_matches_jax(port_mesh, jax_rest):
    port, tag = port_mesh
    got, want = port[f"mppi_jax@{tag}"], jax_rest["mppi"]
    _close(got["us"], want["us"], 1e-5, rtol=1e-4)
    _close(got["cost"], want["cost"], 1e-4, rtol=1e-4)
    _close(got["ess"], want["ess"], 1e-3, rtol=1e-3)


def test_mppi_dp_is_mesh_shape_invariant_and_the_single_device_solver(port_mesh, world1, single):
    port, tag = port_mesh
    got, ref = port[f"mppi@{tag}"], single["mppi"]
    _close(got["us"], world1["mppi@11"]["us"], 5e-5, rtol=1e-4)
    _close(got["us"], ref.us.numpy(), 1e-5, rtol=1e-4)
    _close(got["cost"], ref.cost.numpy(), 1e-4, rtol=1e-4)
    _close(got["ess"], ref.ess.numpy(), 1e-3, rtol=1e-3)


@pytest.mark.parametrize("case", list(PF_CASES))
def test_particle_filter_dp_on_jax_draws_matches_jax(port_mesh, jax_rest, case):
    port, tag = port_mesh
    got, want = port[f"{case}_jax@{tag}"], jax_rest[case]
    _close(got["pf_mean"], want["pf_mean"], 1e-5 if case == "pf" else 1e-4, rtol=1e-4)
    _close(got["ll"], want["ll"], 0.0, rtol=1e-4)
    if case == "pf":
        _close(got["pf_ess"], want["pf_ess"], 1e-3, rtol=1e-4)
        _close(got["particles"], want["particles"], 1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", list(PF_CASES))
def test_particle_filter_dp_is_mesh_shape_invariant_and_the_single_device_filter(
        port_mesh, single, case):
    port, tag = port_mesh
    got, ref = port[f"{case}@{tag}"], single[case]
    _close(got["pf_mean"], ref.means.numpy(), 1e-5, rtol=1e-4)
    _close(got["pf_ess"], ref.ess.numpy(), 1e-3, rtol=1e-4)
    _close(got["ll"], ref.log_likelihood.numpy(), 0.0, rtol=1e-4)
    _close(got["particles"], ref.particles.numpy(), 1e-4, rtol=1e-4)


def test_al_ilqr_dp_matches_the_batched_solver_and_jax(port, jax_rest, problem):
    got, want = port["al"], jax_rest["al"]
    ref = al_ilqr_solve_batched(pendulum_step, torch.from_numpy(problem[0]["al_x0s"]), *PEND_COST,
                                20, -2.0, 2.0, **AL)
    _close(got["us"], ref.us.numpy(), 1e-6)
    assert abs(float(got["worst"]) - float(ref.max_violation.max())) <= 1e-6
    _close(got["us"], want["us"], 5e-3, rtol=5e-3)
    _close(got["cost"], want["cost"], 1e-3, rtol=2e-3)
    assert abs(float(got["worst"]) - float(want["worst"])) <= 5e-3


def test_mhe_dp_matches_the_batched_solver_and_jax(port, jax_rest, problem):
    prob = problem[0]
    got, want = port["mhe"], jax_rest["mhe"]
    A, C, Q, R, P0 = _kf_mats(prob)
    ref = mhe_solve(A, C, Q, R, P0, torch.from_numpy(prob["mhe_xp"]), prob["mhe_yss"])
    _close(got["xs"], ref.xs.numpy(), 1e-6)
    _close(got["xs"], want["xs"], 1e-4, rtol=1e-4)
    assert float(got["worst"]) == float(got["resid"].max())
    assert float(got["worst"]) >= float(want["worst"]) - 1e-6


def test_mhe_dp_fabricates_the_inputs_as_jax(group1, problem):
    """uss=None with a B of two columns: zero inputs of B's width; with
    neither, a zero B of one column (parallel/solvers_dp.py:70-77)."""
    prob = problem[0]
    mesh = make_mesh((1, 1))
    A, C, Q, R, P0 = _kf_mats(prob)
    B2 = np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)
    xp, yss = torch.from_numpy(prob["mhe_xp"]), torch.from_numpy(prob["mhe_yss"])
    got, _ = mhe_solve_dp(A, C, Q, R, P0, xp, yss, mesh, B=B2)
    plain = mhe_solve(A, C, Q, R, P0, xp, yss)
    assert torch.allclose(got.xs, plain.xs, atol=1e-6)


def test_mppi_dp_pure_scenario_dp_is_the_same_solve(group1, problem):
    """shard_samples=False keeps every sample on the rank: no collective, the
    same solve."""
    mesh = make_mesh((1, 1))
    kw = dict(MPPI)
    horizon = kw.pop("horizon")
    x0s = torch.from_numpy(problem[0]["mppi_x0s"][:4])
    a, b = (mppi_solve_dp(pendulum_step, x0s, _pend_cost(), horizon,
                          torch.Generator().manual_seed(1), mesh, shard_samples=shard, **kw)
            for shard in (True, False))
    assert torch.equal(a.us, b.us) and a.us.device.type == "cpu"
