"""The kernel layer's JAX names in numpower_tpu_torch: each function of
numpower_tpu/kernels that reaches pl.pallas_call has its name in the port's
kernel module (kalman_batched.py and rts_batched.py under the JAX package's
module names), taking the JAX function's operands in its order and layout,
and tile_b / tile_n / blk / sc / interpret where the JAX function takes them.

Each case runs, on the same seeded numpy inputs at a tiny size, the JAX
function in interpret mode, the port's JAX-named function and the port's own
wrapper (on the CPU, their plain versions). The JAX-named function equals the
port's wrapper bit for bit, and the JAX kernel within the tolerance of the
wrapper's existing twin: box-QP all-fp32 1e-5 (tests/test_torch_boxqp_*.py),
g rtol 1e-5 / atol 1e-5; K5 rtol 1e-3 / atol 1e-4 on Ks and 1e-3 on P0, K6a
1e-4, K6b rtol 2e-3 / atol 2e-4 (test_torch_riccati_kernels.py); K7
rtol 1e-3 / atol 1e-4, K8 us/xs 1e-4, costs rtol 1e-5
(test_torch_ilqr_kernels.py); K9 means 2e-5, log-likelihood rtol 2e-4 /
atol 2e-3, K10 2e-5, K11/K12 means 1e-4, covariances 1e-5, log-likelihood
rtol 1e-3 / atol 5e-3 (test_torch_estimation_kernels.py); K13 us atol 5e-4,
ess rtol 1e-3, K14 exact (test_torch_sampling_kernels.py).
"""

import functools
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.models import particle as jpart  # noqa: E402
from numpower_tpu_torch.kernels import (  # noqa: E402
    boxqp_admm, boxqp_fista, cholesky, ekf, ilqr_backward, ilqr_forward, kalman_mean, mppi,
    pf_resample, riccati, rts_mean, ukf,
)
from numpower_tpu_torch.models import plant_from_jax  # noqa: E402
from numpower_tpu_torch.models.condensed import condensed_from_jax  # noqa: E402

FIELDS = ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")
N, T_QP, ITERS, LO, HI = 8, 10, 10, -0.5, 0.5
BOXQP = (0.0, 1e-5)  # (rtol, atol) of the box-QP twins at coarse_iters = 0
G = (1e-5, 1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_kernel(module: str, name: str):
    return getattr(importlib.import_module(f"numpower_tpu.kernels.{module}"), name)


@functools.lru_cache(maxsize=None)
def _qp():
    """The quadrotor QP at T = 10 (JAX's, and the port's from its arrays),
    N x0s, a warm start that leaves the box and g of an x_ref."""
    A, B = jm.quadrotor12(0.02)
    jqp = jm.condense(jnp.asarray(A), jnp.asarray(B), jnp.eye(12), jnp.eye(4) * 0.1,
                      jnp.eye(12) * 5.0, T_QP)
    tqp = condensed_from_jax({f: np.asarray(getattr(jqp, f)) for f in FIELDS}, T=T_QP,
                             n=jqp.n, m=jqp.m, kappa=jqp.kappa, device="cpu")
    rng = np.random.default_rng(0)
    x0s = (0.3 * rng.standard_normal((N, 12))).astype(np.float32)
    U0 = (0.8 * rng.standard_normal((N, 4 * T_QP))).astype(np.float32)
    x_ref = (0.2 * rng.standard_normal(12)).astype(np.float32)
    g = np.asarray(jm.gradient_offset(jqp, jnp.asarray(x0s), jnp.asarray(x_ref)))
    rho = np.asarray(jnp.sqrt(jqp.lipschitz * jnp.maximum(jqp.mu, 1e-12)))
    return jqp, tqp, x0s, U0, g, rho


def case_fista_mpc_pallas_res():
    jqp, tqp, x0s, U0, _, _ = _qp()
    j = _jax_kernel("boxqp_fista", "fista_mpc_pallas_res")(
        jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI),
        jqp.lipschitz, ITERS, 0, 16, True, jnp.asarray(U0))
    args = (tqp.H, tqp.Sx.T, tqp.SuTQ.T, _t(x0s), LO, HI, tqp.lipschitz, ITERS, 0)
    alias = boxqp_fista.fista_mpc_pallas_res(*args, 16, True, _t(U0))
    port = boxqp_fista.fista_mpc_res(*args, _t(U0))
    return alias, port, j, (BOXQP, BOXQP)


def case_fista_mpc_pallas():
    jqp, tqp, x0s, _, _, _ = _qp()
    j = _jax_kernel("boxqp_fista", "fista_mpc_pallas")(
        jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI),
        jqp.lipschitz, iters=ITERS, coarse_iters=0, tile_n=16, interpret=True)
    args = (tqp.H, tqp.Sx.T, tqp.SuTQ.T, _t(x0s), LO, HI, tqp.lipschitz, ITERS, 0)
    return (boxqp_fista.fista_mpc_pallas(*args, tile_n=16, interpret=True),
            boxqp_fista.fista_mpc(*args), j, (BOXQP, G))


def case_fista_boxqp_pallas():
    jqp, tqp, _, U0, g, _ = _qp()
    j = _jax_kernel("boxqp_fista", "fista_boxqp_pallas")(
        jqp.H, jnp.asarray(g), jnp.float32(LO), jnp.float32(HI), jqp.lipschitz, ITERS, 0, 16,
        True, jnp.asarray(U0))
    args = (tqp.H, _t(g), LO, HI, tqp.lipschitz, ITERS, 0)
    return (boxqp_fista.fista_boxqp_pallas(*args, 16, True, _t(U0)),
            boxqp_fista.fista_boxqp(*args, _t(U0)), j, (BOXQP,))


def case_admm_mpc_pallas_res():
    jqp, tqp, x0s, U0, _, rho = _qp()
    j = _jax_kernel("boxqp_admm", "admm_mpc_pallas_res")(
        jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI),
        jnp.asarray(rho), ITERS, 0, 1.6, 16, True, None, jnp.asarray(U0))
    args = (tqp.H, tqp.Sx.T, tqp.SuTQ.T, _t(x0s), LO, HI, _t(rho), ITERS, 0, 1.6)
    alias = boxqp_admm.admm_mpc_pallas_res(*args, 16, True, None, _t(U0))
    port = boxqp_admm.admm_mpc_res(*args, None, _t(U0))
    return alias, port, j, (BOXQP, BOXQP, BOXQP)


def case_admm_boxqp_pallas():
    jqp, tqp, _, U0, g, rho = _qp()
    j = _jax_kernel("boxqp_admm", "admm_boxqp_pallas")(
        jqp.H, jnp.asarray(g), jnp.float32(LO), jnp.float32(HI), jnp.asarray(rho), ITERS, 0, 1.6,
        16, True, jnp.asarray(U0))
    args = (tqp.H, _t(g), LO, HI, _t(rho), ITERS, 0, 1.6)
    # y: the interpret-mode tail product runs as bf16x3 (test_torch_boxqp_kernels.py)
    return (boxqp_admm.admm_boxqp_pallas(*args, 16, True, _t(U0)),
            boxqp_admm.admm_boxqp(*args, _t(U0)), j, (BOXQP, (1e-5, 1e-5)))


def case_admm_mpc_pallas():
    jqp, tqp, x0s, _, _, rho = _qp()
    j = _jax_kernel("boxqp_admm", "admm_mpc_pallas")(
        jqp.H, jqp.Sx.T, jqp.SuTQ.T, jnp.asarray(x0s), jnp.float32(LO), jnp.float32(HI),
        jnp.asarray(rho), iters=ITERS, coarse_iters=0, tile_n=16, interpret=True)
    args = (tqp.H, tqp.Sx.T, tqp.SuTQ.T, _t(x0s), LO, HI, _t(rho), ITERS, 0)
    return (boxqp_admm.admm_mpc_pallas(*args, tile_n=16, interpret=True),
            boxqp_admm.admm_mpc(*args), j, (BOXQP, (1e-5, 1e-5), G))


def _spd(n_mat, n, seed, shift):
    a = np.random.default_rng(seed).standard_normal((n_mat, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + shift * np.eye(n, dtype=np.float32)


def case_cholesky_batched():
    spd = _spd(N, 6, 1, 6.0)
    j = _jax_kernel("cholesky", "cholesky_batched")(jnp.asarray(spd), tile_b=128, interpret=True)
    return (cholesky.cholesky_batched(_t(spd), tile_b=128, interpret=True),
            cholesky.cholesky_batched(_t(spd)), j, ((1e-4, 1e-4),))


def case_psd_solve_batched():
    spd, b = _spd(N, 4, 2, 4.0), np.random.default_rng(3).standard_normal((N, 4, 5))
    b = b.astype(np.float32)
    j = _jax_kernel("cholesky", "psd_solve_batched")(jnp.asarray(spd), jnp.asarray(b), 128, True)
    return (cholesky.psd_solve_batched(_t(spd), _t(b), 128, True),
            cholesky.psd_solve_batched(_t(spd), _t(b)), j, ((2e-3, 2e-4),))


def case_riccati_batched_fused():
    A, B = (np.asarray(x) for x in jm.quadrotor12(0.02))
    rng = np.random.default_rng(0)
    As = (np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 12))).astype(np.float32)
    Bs = (np.tile(B, (N, 1, 1)) + 0.01 * rng.standard_normal((N, 12, 4))).astype(np.float32)
    costs = (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
             np.eye(12, dtype=np.float32) * 5.0)
    j = _jax_kernel("riccati", "riccati_batched_fused")(jnp.asarray(As), jnp.asarray(Bs),
                                                        *costs, 12, 128, True)
    return (riccati.riccati_batched_fused(_t(As), _t(Bs), *costs, 12, 128, True),
            riccati.riccati_batched_fused(_t(As), _t(Bs), *costs, 12), j,
            ((1e-3, 1e-4), (1e-3, 1e-3)))


@functools.lru_cache(maxsize=None)
def _trajectory(name, n_traj, T, seed):
    """A rollout of small random controls and its linearization (JAX, exact
    Jacobians) with the costs Q = I, R = 0.1 I, QF = 10 I
    (test_torch_ilqr_kernels.py's problem)."""
    f = getattr(jm, name)
    n, m = {"cartpole_step": (4, 1), "unicycle_step": (3, 2)}[name]
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray((0.3 * rng.standard_normal((n_traj, n))).astype(np.float32))
    us = jnp.asarray((0.1 * rng.standard_normal((n_traj, T, m))).astype(np.float32))
    xs = jax.vmap(lambda x0, u: jm.rollout_nonlinear(f, x0, u))(x0s, us)
    As, Bs = jax.vmap(lambda x, u: jm.linearize_trajectory(f, x, u))(xs, us)
    Q, R, QF = (np.eye(n, dtype=np.float32), 0.1 * np.eye(m, dtype=np.float32),
                10.0 * np.eye(n, dtype=np.float32))
    lxs, lus, lxT = 2.0 * xs[:, :T] @ Q.T, 2.0 * us @ R.T, 2.0 * xs[:, T] @ QF.T
    return dict(f=f, n=n, m=m, x0s=x0s, us=us, xs=xs, As=As, Bs=Bs, Q=Q, R=R, QF=QF,
                bwd=(As, Bs, lxs, lus, 2.0 * Q, 2.0 * R, lxT, 2.0 * QF))


def case_ilqr_backward_fused():
    p = _trajectory("cartpole_step", 4, 10, 0)
    j = _jax_kernel("ilqr_backward", "ilqr_backward_fused")(*p["bwd"], 1e-3, 128, True)
    args = tuple(_t(a) for a in p["bwd"])
    return (ilqr_backward.ilqr_backward_fused(*args, 1e-3, 128, True),
            ilqr_backward.ilqr_backward_fused(*args, reg=1e-3), j, ((1e-3, 1e-4),) * 2)


def case_ilqr_forward_pallas():
    p = _trajectory("unicycle_step", 4, 5, 1)
    n, m, T, n_traj = p["n"], p["m"], 5, 4
    ks, Ks = (a.numpy() for a in ilqr_backward.ilqr_backward_reference(
        *(_t(a) for a in p["bwd"])))
    alphas = np.array([1.0, 0.6, 0.3, 0.1, 0.03, 0.01], np.float32)
    cost = (p["Q"], p["R"], p["QF"], np.zeros(n, np.float32))
    lane = (np.asarray(p["xs"])[:, :T].transpose(1, 2, 0), np.asarray(p["us"]).transpose(1, 2, 0),
            ks.transpose(1, 2, 0), Ks.transpose(1, 2, 3, 0).reshape(T, m * n, n_traj))
    j = _jax_kernel("ilqr_forward", "ilqr_forward_pallas")(
        p["f"], *(jnp.asarray(c) for c in cost), jnp.asarray(alphas), p["x0s"],
        *(jnp.asarray(a) for a in lane), n_alphas=6, interpret=True)
    f_t = plant_from_jax(p["f"])
    alias = ilqr_forward.ilqr_forward_pallas(f_t, *(_t(c) for c in cost), _t(alphas),
                                             _t(p["x0s"]), *(_t(a) for a in lane), 6, 128, True)
    us, xs, costs = ilqr_forward.ilqr_forward_fused(
        f_t, *(_t(c) for c in cost), _t(alphas), _t(p["x0s"]), _t(p["xs"][:, :T]), _t(p["us"]),
        _t(ks), _t(Ks))
    port = (us.permute(0, 2, 3, 1), xs.permute(0, 2, 3, 1), costs)
    return alias, port, j, ((0.0, 1e-4), (0.0, 1e-4), (1e-5, 0.0))


@functools.lru_cache(maxsize=None)
def _gains():
    """Mean-pass operands of a random (n, p) = (3, 2) system, 7 trajectories
    over 20 steps (test_torch_estimation_kernels.py's gains)."""
    rng = np.random.default_rng(4)
    n, p, n_traj, T = 3, 2, 7, 20
    A = (np.eye(n) + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
    C = rng.standard_normal((p, n)).astype(np.float32)
    Q, R, P0 = (np.eye(n, dtype=np.float32) * 0.01, np.eye(p, dtype=np.float32) * 0.1,
                np.eye(n, dtype=np.float32) * 0.5)
    ys = rng.standard_normal((n_traj, T, p)).astype(np.float32)
    x0s = rng.standard_normal((n_traj, n)).astype(np.float32)
    us_t = (0.3 * rng.standard_normal((T, n_traj, n))).astype(np.float32)
    filt = tm.kalman_filter_batched(A, C, Q, R, _t(x0s), P0, _t(ys), method="xla")
    P_p, C_t = filt.pred_covs[0], torch.from_numpy(C)
    S = C_t @ P_p @ C_t.T + torch.from_numpy(R)
    L = torch.linalg.cholesky(0.5 * (S + S.transpose(1, 2)))
    Ws = torch.cholesky_solve(C_t @ P_p, L)
    invLs = torch.linalg.solve_triangular(L, torch.eye(p).expand(T, p, p), upper=False)
    logdets = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
    mean = (A, C, Ws.numpy(), invLs.numpy(), logdets.numpy(), x0s,
            ys.transpose(1, 0, 2).copy(), us_t)
    P_f = filt.covs[0]
    G_Ts = torch.linalg.solve(P_p[1:], torch.from_numpy(A) @ P_f[:-1])
    xs_f_t, xs_p_t = filt.means.transpose(0, 1), filt.pred_means.transpose(0, 1)
    es_t = xs_f_t[:-1] - torch.einsum("tnj,tjk->tnk", xs_p_t[1:], G_Ts)
    smooth = (G_Ts.numpy(), es_t.contiguous().numpy(), xs_f_t[-1].contiguous().numpy())
    return mean, smooth


def case_kalman_mean_pass_pallas():
    from numpower_tpu_torch.kernels.kalman_batched import kalman_mean_pass_pallas

    mean, _ = _gains()
    j = _jax_kernel("kalman_batched", "kalman_mean_pass_pallas")(
        *(jnp.asarray(a) for a in mean), tile_b=1024, interpret=True)
    args = tuple(_t(a) for a in mean)
    return (kalman_mean_pass_pallas(*args, 1024, True), kalman_mean.kalman_mean_pass(*args), j,
            ((0.0, 2e-5), (0.0, 2e-5), (2e-4, 2e-3)))


def case_rts_mean_pass_pallas():
    from numpower_tpu_torch.kernels.rts_batched import rts_mean_pass_pallas

    _, smooth = _gains()
    j = _jax_kernel("rts_batched", "rts_mean_pass_pallas")(*(jnp.asarray(a) for a in smooth),
                                                          tile_b=1024, interpret=True)
    args = tuple(_t(a) for a in smooth)
    return (rts_mean_pass_pallas(*args, tile_b=1024, interpret=True), rts_mean.rts_mean_pass(*args),
            j, ((0.0, 2e-5),))


def _filter_case(which):
    rng = np.random.default_rng(2)
    B, T, p = 7, 20, 1
    args = (np.eye(2, dtype=np.float32) * 1e-3, np.eye(1, dtype=np.float32) * 1e-2,
            (0.3 * rng.standard_normal((B, 2))).astype(np.float32),
            np.eye(2, dtype=np.float32) * 0.1,
            rng.standard_normal((B, T, p)).astype(np.float32),
            (0.1 * rng.standard_normal((B, T, 1))).astype(np.float32))
    j = _jax_kernel(which, f"{which}_pallas")(jm.pendulum_step, lambda x: x[:p],
                                              *(jnp.asarray(a) for a in args), interpret=True)
    h = functools.partial(tm.first_components, k=p)
    targs = (tm.pendulum_step, h, *(_t(a) for a in args))
    mod = ekf if which == "ekf" else ukf
    alias = getattr(mod, f"{which}_pallas")(*targs, tile_b=1024, interpret=True)
    port = getattr(mod, f"{which}_batched")(*targs)
    return alias, port, j, ((0.0, 1e-4), (0.0, 1e-5), (0.0, 1e-4), (0.0, 1e-5), (1e-3, 5e-3))


def case_ekf_pallas():
    return _filter_case("ekf")


def case_ukf_pallas():
    return _filter_case("ukf")


def case_mppi_pallas():
    T, K, n_s, iters, m = 12, 128, 6, 2, 1
    Qp, Rp, QFp = (np.diag([1.0, 0.1]).astype(np.float32), np.eye(1, dtype=np.float32) * 0.01,
                   np.diag([100.0, 10.0]).astype(np.float32))
    cj = jm.quadratic_mppi_cost(jnp.asarray(Qp), jnp.asarray(Rp), jnp.asarray(QFp), jnp.zeros(2))
    ct = tm.quadratic_mppi_cost(Qp, Rp, QFp, np.zeros(2, np.float32))
    x0s = np.random.default_rng(8).uniform(-np.pi, np.pi, (n_s, 2)).astype(np.float32)
    lay = np.asarray(_jax_kernel("mppi", "eps_kernel_layout")(
        jax.random.key(3), n_s, iters, T, m, K, jnp.asarray((1.0,), jnp.float32)))
    us0 = np.zeros(T * m, np.float32)
    kw = dict(T=T, iters=iters, m=m, lam=1.0, sigma=(1.0,), u_lo=-2.0, u_hi=2.0)
    j = _jax_kernel("mppi", "mppi_pallas")(jm.pendulum_step, cj.rows, jnp.asarray(x0s),
                                           jnp.asarray(lay), jnp.asarray(us0), **kw,
                                           interpret=True)
    targs = (tm.pendulum_step, ct.rows, _t(x0s), _t(lay), _t(us0))
    alias = mppi.mppi_pallas(*targs, **kw, sc=8, interpret=True)
    port = mppi.mppi_fused(tm.pendulum_step, ct, *targs[2:], **kw)
    return alias, port, j, ((0.0, 5e-4), (1e-3, 0.0))


def case_resample_onehot_pallas():
    rng = np.random.default_rng(7)
    B, n_p, n = 3, 16, 5
    parts = rng.standard_normal((B, n_p, n)).astype(np.float32)
    logw = rng.standard_normal((B, n_p)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), B)
    m = np.asarray(jax.vmap(lambda k, lw: jpart._resample_slots(k, lw, n_p))(keys,
                                                                          jnp.asarray(logw)))
    j = _jax_kernel("pf_resample", "resample_onehot_pallas")(jnp.asarray(parts), jnp.asarray(m),
                                                             blk=n_p, interpret=True)
    return (pf_resample.resample_onehot_pallas(_t(parts), _t(m), blk=n_p, interpret=True),
            pf_resample.resample_systematic(_t(parts), _t(m)), j, ((0.0, 0.0),))


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def _case(name):
    """The case's outputs, each a tuple (one result or several), and its
    tolerances."""
    *outs, tols = CASES[name]()
    return (*(tuple(x) if isinstance(x, (tuple, list)) else (x,) for x in outs), tols)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_kernel_name_matches_the_jax_kernel_and_the_port(name):
    alias, port, want, tols = _case(name)
    assert len(alias) == len(port) == len(want) == len(tols)
    for a, p, w, (rtol, atol) in zip(alias, port, want, tols):
        assert torch.equal(a, p), f"{name}: the JAX name differs from the port's wrapper"
        w = np.asarray(w)
        assert tuple(a.shape) == w.shape, f"{name}: shape {tuple(a.shape)} against {w.shape}"
        np.testing.assert_allclose(a.numpy(), w, rtol=rtol, atol=atol)


def test_the_package_exports_fista_boxqp_pallas_as_the_jax_package_does():
    import numpower_tpu.kernels as jk
    import numpower_tpu_torch.kernels as tk

    assert jk.fista_boxqp_pallas.__name__ == tk.fista_boxqp_pallas.__name__
    assert tk.fista_boxqp_pallas is boxqp_fista.fista_boxqp_pallas


def test_ilqr_forward_pallas_checks_n_alphas():
    p = _trajectory("unicycle_step", 4, 5, 1)
    lane = (torch.zeros(5, 3, 4), torch.zeros(5, 2, 4), torch.zeros(5, 2, 4), torch.zeros(5, 6, 4))
    with pytest.raises(ValueError, match="n_alphas"):
        ilqr_forward.ilqr_forward_pallas(plant_from_jax(p["f"]), *(_t(c) for c in (
            p["Q"], p["R"], p["QF"], np.zeros(3, np.float32))), torch.ones(3), _t(p["x0s"]),
            *lane, 2)


def test_mppi_pallas_takes_a_bare_rows_callable_on_the_cpu():
    """A rows callable without the kernel form runs the plain version on a
    CPU tensor, as the JAX kernel takes any rows function."""
    ct = tm.quadratic_mppi_cost(np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32),
                                np.eye(2, dtype=np.float32), np.zeros(2, np.float32))
    x0s = torch.zeros(2, 2)
    eps = torch.zeros(2 * 3, 2, 128)  # K % 128 == 0, as the JAX kernel needs
    kw = dict(T=3, iters=2, m=1, lam=1.0, sigma=1.0, u_lo=None, u_hi=None)
    got = mppi.mppi_pallas(tm.pendulum_step, lambda x, u, t: ct.rows(x, u, t), x0s, eps,
                           torch.zeros(3), **kw)
    want = mppi.mppi_fused(tm.pendulum_step, ct, x0s, eps, torch.zeros(3), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
