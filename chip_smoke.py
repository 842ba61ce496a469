#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (numpower_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives two paths of the port through their entry points and fails unless
every phase passes. The condensed box-QP MPC serving path of BASELINE config
#4 (the 12-state quadrotor linearised about hover, horizon 30, 4096
scenarios, controls boxed to +-1, so d = 120 controls per scenario):

0. device: a CUDA device is required; the kernels are built from
   numpower_tpu_torch/csrc with nvcc (timed);
1. each kernel against its plain PyTorch version on the card at N = 4096:
   cold and warm starts, all-fp32 (max |dU| <= 1e-5) and the default
   bf16 + fp32 schedules (<= 1e-4), residuals within 1e-5;
2. end to end: solve_mpc_boxqp (auto -> FISTA kernel) and
   solve_mpc_boxqp_admm (auto -> ADMM kernel) on 256 scenarios against
   the same algorithm run all-fp32 in float64 by the plain version (<= 1e-4);
3. serving: MPCController (FISTA, then ADMM) for 20 closed-loop ticks of
   4096 scenarios, one kernel launch per tick, finite residuals, u0 in the box;
4. times from CUDA events (median): each kernel and its plain version per
   4096-scenario solve, and one serving tick per solver.

The Riccati/LQR family (BASELINE configs #1, #2, #5 and the per-scenario
Riccati of bench.py:341-372):

5. each kernel against its plain PyTorch version on the card: the fused
   Riccati (K5) on the quadrotor recipe of bench.py:345-355 at N = 4096 and
   at a ragged N = 1003, T = 30 (rtol 1e-3, atol 1e-4 on Ks, 1e-3 on P0);
   the batched SPD solve (K6b) at the Riccati inner shape (4096, 4, 4) x
   (4096, 4, 12) and at (4096, 12, 12) x (4096, 12, 4) (rtol 2e-3, atol
   2e-4; residual |AX - B| <= 2e-3); the batched Cholesky (K6a) at
   (4096, 12, 12) against its plain version and torch.linalg.cholesky (1e-4)
   with a strictly upper triangle of exact zeros;
6. the path through its public entry points: riccati_scan_per_scenario at
   N = 4096, T = 30 by "auto" (one K5 launch) and by "psd" (one K6b launch
   per stage), both against the plain route run in float64 on the card; the
   batched Cholesky (the package's kernels API, as bench.py:1246 calls it)
   of the 4096 cost-to-go matrices; config #1 (lqr_solve) and config #2
   (lqr_solve_batched, 256 scenarios) against float64, driving the state to
   the origin; riccati_associative (pivoted and nopivot) against
   riccati_scan at T = 4096; tube_mpc_solve at N = 65,536, T = 30;
7. times from CUDA events (median): each kernel and its plain version, one
   config #1 solve, one config #2 batch, the T = 4096 sequential and
   associative Riccati, one tube sweep and lqr_infinite_gain's share of it.

The two-step box-QP kernels (reference tracking and single-x0 solves):

8. K3b fista_boxqp and K3a admm_boxqp against their plain versions at
   N = 4096, d = 120 on the flagship QP with g of an x_ref, cold and warm,
   all-fp32 (<= 1e-5) and the default schedules (<= 1e-4); then the path:
   solve_mpc_boxqp with x_ref and with one x0, solve_mpc_boxqp_admm with
   x_ref, each one K3 launch, against float64 (<= 1e-4), and 20 serving
   ticks of MPCController(x_ref=...), one K3b launch each.

The iLQR / AL-iLQR family (BASELINE config #3, its batched form #3b and the
AL-iLQR bench configuration, bench.py:408-451 and 524-544):

9. K7 ilqr_backward_fused and K8 ilqr_forward_fused against their plain
   versions at config #3b's shape (cartpole, N = 256, T = 50, six alphas)
   and at N = 4096 (K7 rtol 1e-3, atol 1e-4; K8 us/xs 1e-4, costs rtol
   1e-5), K8 also on the pendulum; then the path: config #3 (ilqr_solve,
   finite differences, h = 50, 10 iterations), config #3b
   (ilqr_solve_batched, 256 scenarios, backend="fused": 10 launches each of
   K7 and K8) against the plain backend, and the AL-iLQR configuration
   (pendulum, 256 scenarios, h = 40, 4 x 6 iterations, box +-2, fused: 24
   launches each);
10. times from CUDA events: K3a/K3b at N = 4096, K7 and K8 at N = 256 and
   4096, each beside its plain version, and the three solves.

The launch counters of each path are zeroed just before it is driven
(phases 2-3, 6, the path of 8 and the path of 9) and read just after. The
last lines are the total wall time, one JSON object listing every kernel,
the card's name and power limit from nvidia-smi, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T, N, N_E2E, N_TICKS = 30, 4096, 256, 20
LO, HI = -1.0, 1.0
N_RAGGED = 1003  # not a multiple of K5's 8-scenario or K6's 32-matrix blocks
N_CONFIG2, N_TUBE, T_LONG = 256, 65536, 4096
T_ILQR, N_ILQR, T_AL = 50, 256, 40  # configs #3/#3b and the AL-iLQR bench (bench.py:408-451, 524-544)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 7, inner: int = 10, warmup: int = 3) -> float:
    """Median over `reps` windows of the CUDA-event time per call, each
    window `inner` calls enqueued back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float) -> bool:
    """|a - b| <= atol + rtol |b| everywhere (torch.allclose, in float64)."""
    return torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol)


def ptxas_lines(build_log: str) -> list:
    """(kernel, line) for each register and spill line of the build log's
    ptxas output, the kernel's name demangled by c++filt where it is found
    and cut before its argument list."""
    pairs, entry = [], "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            pairs.append((entry, line.replace("ptxas info    :", "").strip()))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(e for e, _ in pairs),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [e for e, _ in pairs]
    if len(names) != len(pairs):
        names = [e for e, _ in pairs]
    return [(name.split("(")[0], line) for name, (_, line) in zip(names, pairs)]


def spd_batch(N: int, n: int, seed: int, dev) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal((N, n, n)).astype(np.float32)
    return torch.as_tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32),
                           device=dev)


def riccati_family(dev, smi: str) -> list:
    """Phases 5-7: the Riccati/LQR family and its three kernels. Returns the
    kernels' entries of the JSON line."""
    from numpower_tpu_torch.kernels import cholesky, riccati
    from numpower_tpu_torch.models import (
        condense, double_integrator, lqr_infinite_gain, lqr_solve, lqr_solve_batched,
        quadrotor12, riccati_associative, riccati_scan, riccati_scan_per_scenario,
        tube_mpc_solve,
    )
    from numpower_tpu_torch.utils.smallmat import cholesky_unrolled, psd_solve_unrolled

    A, B = quadrotor12(0.02)
    n, m = 12, 4
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    rng = np.random.default_rng(4)  # the recipe of bench.py:345-355
    As = torch.as_tensor(np.tile(A, (N, 1, 1))
                         + 0.01 * rng.standard_normal((N, n, n)).astype(np.float32), device=dev)
    Bs = torch.as_tensor(B, device=dev).expand(N, n, m)  # broadcast, as the bench passes it

    # -- phase 5: kernels against their plain versions -------------------------
    err = {"riccati": 0.0, "psd": 0.0, "chol": 0.0}
    for N_k in (N, N_RAGGED):
        Ks, P0 = riccati.riccati_batched_fused(As[:N_k], Bs[:N_k], Q, R, QF, T)
        Ks_p, P0_p = riccati.riccati_batched_reference(As[:N_k], Bs[:N_k], Q, R, QF, T)
        dk, dp = max_err(Ks, Ks_p), max_err(P0, P0_p)
        log(f"K5 riccati N={N_k} T={T}: max|dKs| {dk:.3e} max|dP0| {dp:.3e} "
            f"(|Ks| {Ks.abs().max().item():.3e}, |P0| {P0.abs().max().item():.3e})")
        require(close(Ks, Ks_p, 1e-3, 1e-4) and close(P0, P0_p, 1e-3, 1e-3),
                f"K5 at N={N_k} vs plain")
        err["riccati"] = max(err["riccati"], dk)
    for dim, r, seed in ((m, n, 1), (n, m, 2)):
        a = spd_batch(N, dim, seed, dev)
        b = torch.as_tensor(np.random.default_rng(seed + 10).standard_normal((N, dim, r)),
                            dtype=torch.float32, device=dev)
        X = cholesky.psd_solve_batched(a, b)
        dx, res = max_err(X, psd_solve_unrolled(a, b)), max_err(a @ X, b)
        log(f"K6b psd_solve ({N},{dim},{dim})x({N},{dim},{r}): max|dX| {dx:.3e} "
            f"residual {res:.3e}")
        require(close(X, psd_solve_unrolled(a, b), 2e-3, 2e-4) and res <= 2e-3,
                f"K6b at n={dim} r={r} vs plain")
        err["psd"] = max(err["psd"], dx)
    a = spd_batch(N, n, 3, dev)
    L = cholesky.cholesky_batched(a)
    d_plain, d_lib = max_err(L, cholesky_unrolled(a)), max_err(L, torch.linalg.cholesky(a))
    upper = torch.count_nonzero(torch.triu(L, 1)).item()
    log(f"K6a cholesky ({N},{n},{n}): max|dL| {d_plain:.3e} vs plain, {d_lib:.3e} vs "
        f"torch.linalg.cholesky; nonzeros above the diagonal {upper}")
    require(close(L, cholesky_unrolled(a), 1e-4, 1e-4)
            and close(L, torch.linalg.cholesky(a), 1e-4, 1e-4) and upper == 0,
            "K6a vs plain and torch.linalg.cholesky")
    err["chol"] = d_plain

    # -- phase 6: the Riccati/LQR path, counted --------------------------------
    counters = {"riccati": riccati.riccati_batched_fused, "psd": cholesky.psd_solve_batched,
                "chol": cholesky.cholesky_batched}
    for counter in counters.values():
        counter.launches = 0

    Ks_f, P0_f = riccati_scan_per_scenario(As, Bs, Q, R, QF, T)
    Ks_s, P0_s = riccati_scan_per_scenario(As, Bs, Q, R, QF, T, method="psd")
    Ks_64, P0_64 = riccati_scan_per_scenario(As.double(), Bs.double(), Q, R, QF, T,
                                             method="plain")
    for route, Ks, P0 in (("auto (K5)", Ks_f, P0_f), ("psd (K6b)", Ks_s, P0_s)):
        log(f"riccati_scan_per_scenario {route} N={N} T={T} vs float64: "
            f"max|dKs| {max_err(Ks, Ks_64):.3e} max|dP0| {max_err(P0, P0_64):.3e}")
        require(close(Ks, Ks_64, 1e-3, 1e-4) and close(P0, P0_64, 1e-3, 1e-3),
                f"riccati_scan_per_scenario {route} vs float64")
    L = cholesky.cholesky_batched(P0_f)
    d_rec = max_err(L @ L.transpose(1, 2), P0_f) / P0_f.abs().max().item()
    log(f"cholesky_batched of the {N} cost-to-go matrices: |LL' - P0| / |P0| {d_rec:.3e}")
    require(d_rec <= 1e-5 and torch.count_nonzero(torch.triu(L, 1)).item() == 0,
            "cholesky_batched of P0")

    Ad, Bd = double_integrator(0.1)
    Qd, Rd, QFd = (np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32) * 0.1,
                   np.eye(2, dtype=np.float32) * 100.0)  # bench.py:316-319
    di32 = [torch.as_tensor(x, device=dev) for x in (Ad, Bd, Qd, Rd, QFd)]
    di64 = [x.double() for x in di32]
    x0 = torch.tensor([1.0, 0.0], device=dev)
    us1, xs1 = lqr_solve(*di32, x0, T)
    us1_64, _ = lqr_solve(*di64, x0.double(), T)
    x0s = torch.as_tensor(np.random.default_rng(1).standard_normal((N_CONFIG2, 2)),
                          dtype=torch.float32, device=dev)  # bench.py:330
    us2, xs2 = lqr_solve_batched(*di32, x0s, T)
    us2_64, _ = lqr_solve_batched(*di64, x0s.double(), T)
    shrink = (xs2[:, -1].norm(dim=-1) / xs2[:, 0].norm(dim=-1)).max().item()
    log(f"config #1 lqr_solve T={T}: max|du| vs float64 {max_err(us1, us1_64):.3e}, "
        f"|x_T| {xs1[-1].norm().item():.3e}; config #2 lqr_solve_batched {N_CONFIG2} "
        f"scenarios: max|du| {max_err(us2, us2_64):.3e}, max |x_T|/|x_0| {shrink:.3e}")
    require(close(us1, us1_64, 1e-3, 1e-4) and xs1[-1].norm().item() < 5e-2,
            "config #1 vs float64, driven to the origin")
    require(close(us2, us2_64, 1e-3, 1e-4) and shrink < 5e-2,
            "config #2 vs float64, driven to the origin")

    quad = [torch.as_tensor(x, device=dev) for x in (A, B, Q, R, QF)]
    Ks_seq, Ps_seq = riccati_scan(*quad, T_LONG)
    for nopivot in (False, True):
        Ks_par, Ps_par = riccati_associative(*quad, T_LONG, nopivot=nopivot)
        log(f"riccati_associative T={T_LONG} nopivot={nopivot} vs riccati_scan: "
            f"max|dKs| {max_err(Ks_par, Ks_seq):.3e} max|dPs| {max_err(Ps_par, Ps_seq):.3e}")
        require(close(Ks_par, Ks_seq, 1e-3, 1e-4) and close(Ps_par, Ps_seq, 1e-3, 1e-3),
                f"riccati_associative nopivot={nopivot} vs riccati_scan")

    qp = condense(A, B, Q, R, QF, T, device=dev)
    trng = np.random.default_rng(2)
    w = torch.as_tensor(0.001 * trng.standard_normal((N_TUBE, T, n)), dtype=torch.float32,
                        device=dev)
    x0_nom = torch.as_tensor(0.2 * trng.standard_normal(n), dtype=torch.float32, device=dev)
    tube = tube_mpc_solve(qp, A, B, Q, R, x0_nom, w, LO, HI)
    finite = all(bool(torch.isfinite(f).all()) for f in tube)
    log(f"tube_mpc_solve N={N_TUBE} T={T}: radius[0] {tube.tube_radius[0].item():.3e}, "
        f"max radius {tube.tube_radius.max().item():.3e}, max violation "
        f"{tube.max_violation.item():.3e}, finite {finite}")
    require(tube.xs_scenarios.shape == (N_TUBE, T + 1, n) and finite
            and tube.tube_radius[0].item() == 0.0 and tube.max_violation.item() <= 1e-6,
            "tube sweep statistics")

    launches = {name: counter.launches for name, counter in counters.items()}
    log(f"Riccati-path launches: {launches}")
    require(launches == {"riccati": 1, "psd": T, "chol": 1},
            "the Riccati path went through K5 once, K6b once per stage, K6a once")

    # -- phase 7: times ----------------------------------------------------------
    a4 = spd_batch(N, m, 1, dev)
    b4 = torch.as_tensor(np.random.default_rng(11).standard_normal((N, m, n)),
                         dtype=torch.float32, device=dev)
    a12 = spd_batch(N, n, 3, dev)
    slow = {"reps": 3, "inner": 1, "warmup": 1}
    costs = quad[2:]  # Q, R, QF on the card: numpy ones would add three host copies per call
    ms = {
        "riccati": cuda_ms(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T)),
        "psd": cuda_ms(lambda: cholesky.psd_solve_batched(a4, b4)),
        "chol": cuda_ms(lambda: cholesky.cholesky_batched(a12)),
    }
    plain_ms = {
        "riccati": cuda_ms(lambda: riccati.riccati_batched_reference(As, Bs, *costs, T)),
        "psd": cuda_ms(lambda: psd_solve_unrolled(a4, b4)),
        "chol": cuda_ms(lambda: cholesky_unrolled(a12)),
    }
    lib_chol_ms = cuda_ms(lambda: torch.linalg.cholesky(a12))
    path_ms = {
        "config #1 lqr_solve (T=30)": cuda_ms(lambda: lqr_solve(*di32, x0, T)),
        f"config #2 lqr_solve_batched ({N_CONFIG2} scenarios, T=30)":
            cuda_ms(lambda: lqr_solve_batched(*di32, x0s, T)),
        f"riccati_scan T={T_LONG}": cuda_ms(lambda: riccati_scan(*quad, T_LONG), **slow),
        f"riccati_associative T={T_LONG}":
            cuda_ms(lambda: riccati_associative(*quad, T_LONG), **slow),
        f"riccati_associative T={T_LONG} nopivot":
            cuda_ms(lambda: riccati_associative(*quad, T_LONG, nopivot=True), **slow),
        f"tube_mpc_solve N={N_TUBE} T={T}":
            cuda_ms(lambda: tube_mpc_solve(qp, A, B, Q, R, x0_nom, w, LO, HI), reps=5, inner=2,
                    warmup=1),
        "lqr_infinite_gain (200 iterations)":
            cuda_ms(lambda: lqr_infinite_gain(*quad[:4]), reps=5, inner=2, warmup=1),
    }
    flop = N * T * (4 * n**3 + 4 * m * n * n + 4 * m * m * n + m**3)  # utils/flops.py:262-268
    log(f"time K5 riccati N={N} T={T}: kernel {ms['riccati']:.4f} ms "
        f"({flop / ms['riccati'] / 1e9:.3f} TFLOP/s of 67 fp32), plain {plain_ms['riccati']:.4f} ms "
        f"[{smi}]")
    log(f"time K6b psd_solve ({N},{m},{m})x({N},{m},{n}): kernel {ms['psd']:.4f} ms, plain "
        f"{plain_ms['psd']:.4f} ms [{smi}]")
    log(f"time K6a cholesky ({N},{n},{n}): kernel {ms['chol']:.4f} ms, plain "
        f"{plain_ms['chol']:.4f} ms, torch.linalg.cholesky {lib_chol_ms:.4f} ms [{smi}]")
    for what, t_ms in path_ms.items():
        log(f"time {what}: {t_ms:.4f} ms [{smi}]")

    source = "numpower_tpu_torch/csrc/"
    return [
        {"name": "riccati_batched_fused", "route": "cuda", "source": source + "riccati.cu",
         "replaces": "numpower_tpu/kernels/riccati.py:172", "launches": launches["riccati"],
         "max_abs_err": err["riccati"], "ms": ms["riccati"], "plain_ms": plain_ms["riccati"]},
        {"name": "cholesky_batched", "route": "cuda", "source": source + "cholesky.cu",
         "replaces": "numpower_tpu/kernels/cholesky.py:107", "launches": launches["chol"],
         "max_abs_err": err["chol"], "ms": ms["chol"], "plain_ms": plain_ms["chol"]},
        {"name": "psd_solve_batched", "route": "cuda", "source": source + "cholesky.cu",
         "replaces": "numpower_tpu/kernels/cholesky.py:135", "launches": launches["psd"],
         "max_abs_err": err["psd"], "ms": ms["psd"], "plain_ms": plain_ms["psd"]},
    ]


def boxqp_two_step(dev, smi: str, qp, x0s, rho) -> list:
    """Phase 8 and its times: K3b/K3a and the x_ref / single-x0 path.
    Returns the kernels' entries of the JSON line."""
    from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
    from numpower_tpu_torch.models import (
        MPCController, gradient_offset, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )
    from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters

    iters, n, m = 40, 12, 4
    fista_ci, admm_ci = default_coarse_iters(qp, iters), admm_coarse_iters(qp, iters)
    x_ref = torch.as_tensor(0.2 * np.random.default_rng(5).standard_normal(n),
                            dtype=torch.float32, device=dev)
    g = gradient_offset(qp, x0s, x_ref).contiguous()
    U0 = torch.cat([g[:, m:], g[:, -m:]], dim=1).clamp(LO, HI).contiguous()  # a warm start in the box

    # -- phase 8: kernels against their plain versions ---------------------------
    err = {"fista": 0.0, "admm": 0.0}
    f0, a0 = boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches
    for coarse_f, coarse_a, tol in ((0, 0, 1e-5), (fista_ci, admm_ci, 1e-4)):
        for start, u0 in (("cold", None), ("warm", U0)):
            Uk = boxqp_fista.fista_boxqp(qp.H, g, LO, HI, qp.lipschitz, iters, coarse_f, u0)
            Up = boxqp_fista.fista_boxqp_reference(qp.H, g, LO, HI, qp.lipschitz, iters,
                                                   coarse_f, u0)
            zk, yk = boxqp_admm.admm_boxqp(qp.H, g, LO, HI, rho, iters, coarse_a, U0=u0)
            zp, yp = boxqp_admm.admm_boxqp_reference(qp.H, g, LO, HI, rho, iters, coarse_a,
                                                     U0=u0)
            du, dz, dy = max_err(Uk, Up), max_err(zk, zp), max_err(yk, yp)
            log(f"K3b fista_boxqp {coarse_f}+{iters - coarse_f} {start}: max|dU| {du:.3e}; "
                f"K3a admm_boxqp {coarse_a}+{iters - coarse_a}: max|dz| {dz:.3e} "
                f"max|dy| {dy:.3e} (tol {tol:g})")
            require(du <= tol and dz <= tol and dy <= tol, f"K3 {start} {coarse_f} vs plain")
            err["fista"], err["admm"] = max(err["fista"], du), max(err["admm"], dz, dy)
    require(boxqp_fista.fista_boxqp.launches - f0 == 4 and boxqp_admm.admm_boxqp.launches - a0 == 4,
            "K3 launched once per call")

    # -- phase 8: the x_ref / single-x0 path, counted ---------------------------
    boxqp_fista.fista_boxqp.launches = 0
    boxqp_admm.admm_boxqp.launches = 0
    xs = x0s[:N_E2E]
    res_r = solve_mpc_boxqp(qp, xs, LO, HI, x_ref=x_ref, iters=iters)
    res_1 = solve_mpc_boxqp(qp, xs[0], LO, HI, iters=iters)
    res_a = solve_mpc_boxqp_admm(qp, xs, LO, HI, x_ref=x_ref, iters=iters)
    require(boxqp_fista.fista_boxqp.launches == 2 and boxqp_admm.admm_boxqp.launches == 1,
            "the x_ref and single-x0 solves went through K3b (twice) and K3a (once)")
    qp64 = type(qp)(H=qp.H.double(), Sx=qp.Sx.double(), Su=qp.Su.double(),
                    SuTQ=qp.SuTQ.double(), lipschitz=qp.lipschitz.double(), mu=qp.mu.double(),
                    T=qp.T, n=qp.n, m=qp.m, kappa=qp.kappa)
    g_r = gradient_offset(qp64, xs.double(), x_ref.double())
    g_1 = gradient_offset(qp64, xs[0].double())[None]
    U_r64 = boxqp_fista.fista_boxqp_reference(qp64.H, g_r, LO, HI, qp64.lipschitz, iters, 0)
    U_164 = boxqp_fista.fista_boxqp_reference(qp64.H, g_1, LO, HI, qp64.lipschitz, iters,
                                                  0)[0]
    rho64 = torch.sqrt(qp64.lipschitz * torch.clamp(qp64.mu, min=1e-12))
    z_r64, _ = boxqp_admm.admm_boxqp_reference(qp64.H, g_r, LO, HI, rho64, iters, 0)
    e_r, e_1, e_a = max_err(res_r.U, U_r64), max_err(res_1.U, U_164), max_err(res_a.U, z_r64)
    log(f"x_ref path vs float64: solve_mpc_boxqp(x_ref) {e_r:.3e} (resid "
        f"{res_r.residual.item():.3e}), one x0 {e_1:.3e} (shape {tuple(res_1.U.shape)}), "
        f"solve_mpc_boxqp_admm(x_ref) {e_a:.3e} (r_prim {res_a.primal_residual.item():.3e}, "
        f"r_dual {res_a.dual_residual.item():.3e}); tol 1e-4")
    require(e_r <= 1e-4 and e_1 <= 1e-4 and e_a <= 1e-4 and res_1.U.shape == (T * m,),
            "the x_ref and single-x0 solves against float64")
    A, B = quadrotor12(0.02)
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, x_ref=x_ref, device=dev)
    A_t, B_t = torch.as_tensor(A, device=dev), torch.as_tensor(B, device=dev)
    state, x = ctrl.init(N), x0s.clone()
    resids = []
    for _ in range(N_TICKS):
        before = boxqp_fista.fista_boxqp.launches
        u0, state, resid = ctrl.step_with_residual(state, x)
        require(boxqp_fista.fista_boxqp.launches == before + 1, "x_ref tick launched K3b once")
        resids.append(resid)
        require(bool(((u0 >= LO) & (u0 <= HI)).all()), "x_ref tick u0 within the box")
        x = x @ A_t.T + u0 @ B_t.T
    resids = torch.stack(resids).cpu()
    dist = (x - x_ref).norm(dim=-1).mean().item()
    log(f"serving fista x_ref: {N_TICKS} ticks x {N} scenarios, residual first "
        f"{resids[0].item():.3e} last {resids[-1].item():.3e}, mean |x - x_ref| "
        f"{(x0s - x_ref).norm(dim=-1).mean().item():.3e} -> {dist:.3e}")
    require(bool(torch.isfinite(resids).all()) and bool(torch.isfinite(x).all())
            and state.tick == N_TICKS, "x_ref serving finite")
    launches = {"fista": boxqp_fista.fista_boxqp.launches,
                "admm": boxqp_admm.admm_boxqp.launches}
    log(f"x_ref-path launches: {launches}")
    require(launches == {"fista": 2 + N_TICKS, "admm": 1}, "the x_ref path went through K3")

    # -- phase 10 (box-QP part): times --------------------------------------------
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_boxqp(qp.H, g, LO, HI, qp.lipschitz, iters,
                                                         fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_boxqp(qp.H, g, LO, HI, rho, iters, admm_ci,
                                                      Minv=Minv)),
    }
    plain_ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_boxqp_reference(qp.H, g, LO, HI, qp.lipschitz,
                                                                   iters, fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_boxqp_reference(qp.H, g, LO, HI, rho, iters,
                                                                admm_ci, Minv=Minv)),
    }
    holder = [ctrl.init(N)]

    def tick():
        _, holder[0] = ctrl.step(holder[0], x0s)

    tick_ms = cuda_ms(tick)
    for solver, name in (("fista", "K3b fista_boxqp"), ("admm", "K3a admm_boxqp (Minv given)")):
        log(f"time {name} {iters} iters, {N} scenarios: kernel {ms[solver]:.4f} ms, plain "
            f"{plain_ms[solver]:.4f} ms [{smi}]")
    log(f"time serving tick with x_ref (FISTA, 30 iters, {N} scenarios): {tick_ms:.4f} ms [{smi}]")
    source = "numpower_tpu_torch/csrc/"
    return [
        {"name": "fista_boxqp", "route": "cuda", "source": source + "boxqp_fista.cu",
         "replaces": "numpower_tpu/kernels/boxqp_fista.py:119", "launches": launches["fista"],
         "max_abs_err": err["fista"], "ms": ms["fista"], "plain_ms": plain_ms["fista"]},
        {"name": "admm_boxqp", "route": "cuda", "source": source + "boxqp_admm.cu",
         "replaces": "numpower_tpu/kernels/boxqp_admm.py:186", "launches": launches["admm"],
         "max_abs_err": err["admm"], "ms": ms["admm"], "plain_ms": plain_ms["admm"]},
    ]


def ilqr_family(dev, smi: str) -> list:
    """Phase 9 and its times: K7/K8 and configs #3, #3b and the AL-iLQR
    configuration. Returns the kernels' entries of the JSON line."""
    from numpower_tpu_torch.kernels import ilqr_backward, ilqr_forward
    from numpower_tpu_torch.models import (
        al_ilqr_solve_batched, cartpole_step, ilqr_solve, ilqr_solve_batched,
        linearize_trajectory, pendulum_step, rollout_nonlinear,
    )

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    # config #3 (bench.py:408-420)
    Q, R = t32(np.diag([1.0, 10.0, 0.1, 0.1])), t32(np.eye(1) * 0.01)
    QF, goal = t32(np.diag([10.0, 100.0, 1.0, 1.0])), t32(np.zeros(4))
    alphas = t32([1.0, 0.6, 0.3, 0.1, 0.03, 0.01])
    # the AL-iLQR configuration (bench.py:524-544)
    Qp, Rp, QFp = t32(np.diag([1.0, 0.1])), t32(np.eye(1) * 0.01), t32(np.diag([100.0, 10.0]))

    def problem(N, f, n, T_p, seed, draw):
        """The first line search of a solve: x0s from the bench's seed, the
        zero nominal controls, its rollout, FD linearization and affine
        terms, and the gains of one plain backward pass."""
        x0s = t32(draw(np.random.default_rng(seed), N))
        us = torch.zeros((N, T_p, 1), dtype=torch.float32, device=dev)
        xs = rollout_nonlinear(f, x0s, us)
        As, Bs = linearize_trajectory(f, xs, us, use_fd=True)
        Qn, QFn, g = (Q, QF, goal) if n == 4 else (Qp, QFp, goal[:2])
        lxs = 2.0 * (xs[:, :T_p] - g) @ Qn.T
        lus = 2.0 * us @ R.T
        lxT = 2.0 * (xs[:, T_p] - g) @ QFn.T
        bwd = (As, Bs, lxs, lus, 2.0 * Qn, 2.0 * R, lxT, 2.0 * QFn)
        ks, Ks = ilqr_backward.ilqr_backward_reference(*bwd, reg=1e-3)
        fwd = (f, Qn, R, QFn, g, alphas, x0s, xs.contiguous(), us, ks, Ks)
        return bwd, fwd, ks, Ks

    def cart_draw(rng, N):  # bench.py:431-433
        return rng.standard_normal((N, 4)) * 0.3

    def pend_draw(rng, N):  # bench.py:527-529
        return rng.uniform(-np.pi, np.pi, (N, 2))

    # -- phase 9: kernels against their plain versions ---------------------------
    # K8 is compared on the candidates whose plain rollout stays in |x| <= 10:
    # at alpha >= 0.3 the first line search of the cartpole leaves the region
    # of its linearization and diverges (|x| up to 1e18, or inf), in the
    # kernel and the plain version alike, and there fp32 rounding, not the
    # kernel, sets the difference. Bounds: xs 1e-4, costs rtol 1e-5 (the JAX
    # package's, tests/test_kernels.py:577-582); us 5e-4, because the gains
    # reach |K| ~ 100, so a state difference of 5e-6 moves u by 5e-4.
    err = {"bwd": 0.0, "fwd": 0.0}
    probs = {}
    for N_k, f, n, T_p, name, draw, seed in (
            (N_ILQR, cartpole_step, 4, T_ILQR, "cartpole", cart_draw, 3),
            (N, cartpole_step, 4, T_ILQR, "cartpole", cart_draw, 3),
            (N_ILQR, pendulum_step, 2, T_AL, "pendulum", pend_draw, 8)):
        bwd, fwd, ks, Ks = probs[(N_k, name)] = problem(N_k, f, n, T_p, seed, draw)
        ks_k, Ks_k = ilqr_backward.ilqr_backward_fused(*bwd, reg=1e-3)
        dk, dK = max_err(ks_k, ks), max_err(Ks_k, Ks)
        log(f"K7 ilqr_backward {name} N={N_k} T={T_p}: max|dks| {dk:.3e} max|dKs| {dK:.3e} "
            f"(|Ks| {Ks.abs().max().item():.3e})")
        require(close(ks_k, ks, 1e-3, 1e-4) and close(Ks_k, Ks, 1e-3, 1e-4),
                f"K7 {name} at N={N_k} vs plain")
        err["bwd"] = max(err["bwd"], dk, dK)
        u_k, x_k, c_k = ilqr_forward.ilqr_forward_fused(*fwd)
        u_p, x_p, c_p = ilqr_forward.ilqr_forward_reference(*fwd)
        ok = torch.isfinite(c_p) & (x_p.abs().amax(dim=(-2, -1)) <= 10.0)
        du, dx = max_err(u_k[ok], u_p[ok]), max_err(x_k[ok], x_p[ok])
        dc = ((c_k[ok].double() - c_p[ok].double()).abs() / c_p[ok].double().abs()).max().item()
        per_alpha = ok.sum(dim=1).tolist()
        log(f"K8 ilqr_forward {name} N={N_k} T={T_p} A={alphas.numel()}: bounded candidates "
            f"per alpha {per_alpha}; on them max|dus| {du:.3e} max|dxs| {dx:.3e} max rel dcost "
            f"{dc:.3e}")
        require(ok.double().mean().item() >= 0.4 and du <= 5e-4 and dx <= 1e-4 and dc <= 1e-5,
                f"K8 {name} at N={N_k} vs plain")
        err["fwd"] = max(err["fwd"], du, dx)

    # -- phase 9: configs #3, #3b and AL-iLQR, counted ---------------------------
    ilqr_backward.ilqr_backward_fused.launches = 0
    ilqr_forward.ilqr_forward_fused.launches = 0
    x0 = t32([0.0, 0.5, 0.0, 0.0])
    r3 = ilqr_solve(cartpole_step, x0, Q, R, QF, goal, horizon=T_ILQR, iters=10, use_fd=True)
    x0s = t32(cart_draw(np.random.default_rng(3), N_ILQR))
    kw = dict(horizon=T_ILQR, use_fd=True)
    r3b = ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal, backend="fused", iters=10, **kw)
    ilqr_launches = (ilqr_backward.ilqr_backward_fused.launches,
                     ilqr_forward.ilqr_forward_fused.launches)
    x0p = t32(pend_draw(np.random.default_rng(8), N_ILQR))
    al_kw = dict(al_iters=4, ilqr_iters=6)
    ral = al_ilqr_solve_batched(pendulum_step, x0p, Qp, Rp, QFp, goal[:2], T_AL, -2.0, 2.0,
                                backend="fused", **al_kw)
    launches = {"bwd": ilqr_backward.ilqr_backward_fused.launches,
                "fwd": ilqr_forward.ilqr_forward_fused.launches}
    log(f"iLQR-path launches: config #3b {ilqr_launches}, with AL-iLQR {launches}")
    require(ilqr_launches == (10, 10), "config #3b went through K7 and K8 once per iteration")
    require(launches == {"bwd": 34, "fwd": 34}, "AL-iLQR went through K7 and K8 24 times each")

    def consistent(res, f, x0, Qn, Rn, QFn, g, what):
        """The repo's own checks of a solve: finite; xs the plain rollout of
        us and cost the trajectory's cost, to 1e-3 of |xs| and of the cost:
        an open-loop replay on another arithmetic path (K8's rollout against
        the plain one) drifts on the chaotic cartpole (2.2e-3 on |x| ~ 30
        measured on the H100)."""
        from numpower_tpu_torch.models.ilqr import _total_cost

        xs_re = rollout_nonlinear(f, x0, res.us)
        c_re = _total_cost(xs_re, res.us, Qn, Rn, QFn, g)
        d_x, x_max = max_err(xs_re, res.xs), res.xs.abs().max().item()
        d_c = ((c_re.double() - res.cost.double()).abs() / res.cost.double().abs()).max().item()
        log(f"{what}: replay of us max|dxs| {d_x:.3e} (|xs| {x_max:.3e}), rel dcost {d_c:.3e}")
        return (bool(torch.isfinite(res.us).all() and torch.isfinite(res.cost).all())
                and d_x <= 1e-3 * max(1.0, x_max) and d_c <= 1e-3)

    def rel_cost(a, b):
        return ((a.cost.double() - b.cost.double()).abs() / b.cost.double().abs()).sort().values

    c0 = r3.costs
    log(f"config #3 ilqr_solve (fd, h={T_ILQR}, 10 iters): cost {c0[0].item():.6f} -> "
        f"{r3.cost.item():.6f}, |x_T| {r3.xs[-1].norm().item():.3e}")
    require(consistent(r3, cartpole_step, x0, Q, R, QF, goal, "config #3")
            and bool((c0[1:] <= c0[:-1]).all()), "config #3: finite, descending, consistent")
    require(consistent(r3b, cartpole_step, x0s, Q, R, QF, goal, "config #3b")
            and bool((r3b.costs[:, 1:] <= r3b.costs[:, :-1]).all()),
            "config #3b: finite, descending, consistent")
    # Against the plain backend. The per-scenario bound of the JAX package,
    # rtol 1e-2 and atol 1e-3 on the cost, was set on its test problem
    # (tests/test_kernels.py:166-176: Q = I, R = 0.01, QF = 10 I, h = 15, 6
    # iterations); it is held there at config #3b's batch of 256. At config
    # #3 itself (h = 50, theta weighted 10, QF 100) the candidates of large
    # alphas leave the linearization's region and diverge chaotically (phase 9
    # above), so marginal line-search choices part the two backends'
    # trajectories (the JAX package's own backends differ so: ROADMAP.md,
    # queue 3); there the batch's mean cost is held, to 5%.
    Qt, Rt, QFt = t32(np.eye(4)), t32(np.eye(1) * 0.01), t32(np.eye(4) * 10.0)
    x0t = t32(0.3 * np.random.default_rng(1).standard_normal((N_ILQR, 4)))
    pair = [ilqr_solve_batched(cartpole_step, x0t, Qt, Rt, QFt, goal, 15, backend=b, iters=6)
            for b in ("fused", "vmap")]
    d_t = (pair[0].cost - pair[1].cost).abs()
    rel_t = (d_t / pair[1].cost.abs()).max().item()
    out_t = int((d_t > 1e-3 + 1e-2 * pair[1].cost.abs()).sum().item())
    r3b_plain = ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal, backend="vmap", iters=10,
                                   **kw)
    rel10 = ((r3b.cost.double() - r3b_plain.cost.double()).abs()
             / r3b_plain.cost.double().abs()).sort().values
    mean_f, mean_p = r3b.cost.mean().item(), r3b_plain.cost.mean().item()
    log(f"fused vs vmap, the JAX test problem at {N_ILQR} scenarios: max rel dcost {rel_t:.3e} "
        f"({out_t} outside the bound); "
        f"config #3b: per-scenario rel dcost median {rel10[N_ILQR // 2].item():.3e}, 90th pct "
        f"{rel10[int(0.9 * N_ILQR)].item():.3e}, max {rel10[-1].item():.3e}, mean cost "
        f"{mean_f:.4f} vs {mean_p:.4f}")
    require(bool((d_t <= 1e-3 + 1e-2 * pair[1].cost.abs()).all()),
            "fused vs vmap per scenario on the JAX test problem")
    require(abs(mean_f - mean_p) <= 0.05 * mean_p, "config #3b fused vs vmap, mean cost")
    lo_hi_ok = bool(((ral.us >= -2.0) & (ral.us <= 2.0)).all())
    log(f"AL-iLQR pendulum {N_ILQR} scenarios h={T_AL} 4x6 fused: mean cost "
        f"{ral.cost.mean().item():.4f}, max_violation max {ral.max_violation.max().item():.3e} "
        f"median {ral.max_violation.median().item():.3e}, us in the box {lo_hi_ok}")
    require(consistent(ral, pendulum_step, x0p, Qp, Rp, QFp, goal[:2], "AL-iLQR") and lo_hi_ok
            and bool(torch.isfinite(ral.max_violation).all()), "AL-iLQR: finite, feasible")

    # -- phase 10 (iLQR part): times ----------------------------------------------
    ms, plain_ms = {}, {}
    slow = {"reps": 3, "inner": 1, "warmup": 1}
    for N_k in (N_ILQR, N):
        bwd, fwd, _, _ = probs[(N_k, "cartpole")]
        ms[("bwd", N_k)] = cuda_ms(lambda: ilqr_backward.ilqr_backward_fused(*bwd, reg=1e-3))
        ms[("fwd", N_k)] = cuda_ms(lambda: ilqr_forward.ilqr_forward_fused(*fwd))
        plain_ms[("bwd", N_k)] = cuda_ms(
            lambda: ilqr_backward.ilqr_backward_reference(*bwd, reg=1e-3), **slow)
        plain_ms[("fwd", N_k)] = cuda_ms(lambda: ilqr_forward.ilqr_forward_reference(*fwd), **slow)
        for k, name in (("bwd", "K7 ilqr_backward"), ("fwd", "K8 ilqr_forward")):
            log(f"time {name} cartpole N={N_k} T={T_ILQR}: kernel {ms[(k, N_k)]:.4f} ms, "
                f"plain {plain_ms[(k, N_k)]:.4f} ms [{smi}]")
    solve_ms = {
        f"config #3 ilqr_solve (fd, h={T_ILQR}, 10 iters)":
            cuda_ms(lambda: ilqr_solve(cartpole_step, x0, Q, R, QF, goal, horizon=T_ILQR,
                                       iters=10, use_fd=True), **slow),
        f"config #3b ilqr_solve_batched fused ({N_ILQR} scenarios)":
            cuda_ms(lambda: ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal,
                                               backend="fused", iters=10, **kw),
                    reps=5, inner=2, warmup=1),
        f"config #3b ilqr_solve_batched vmap ({N_ILQR} scenarios)":
            cuda_ms(lambda: ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal,
                                               backend="vmap", iters=10, **kw), **slow),
        f"AL-iLQR fused (pendulum, {N_ILQR} scenarios, h={T_AL}, 4x6)":
            cuda_ms(lambda: al_ilqr_solve_batched(pendulum_step, x0p, Qp, Rp, QFp, goal[:2],
                                                  T_AL, -2.0, 2.0, backend="fused", **al_kw),
                    reps=5, inner=1, warmup=1),
    }
    for what, t_ms in solve_ms.items():
        log(f"time {what}: {t_ms:.4f} ms [{smi}]")
    source = "numpower_tpu_torch/csrc/"
    return [
        {"name": "ilqr_backward_fused", "route": "cuda", "source": source + "ilqr_backward.cu",
         "replaces": "numpower_tpu/kernels/ilqr_backward.py:134", "launches": launches["bwd"],
         "max_abs_err": err["bwd"], "ms": ms[("bwd", N_ILQR)],
         "plain_ms": plain_ms[("bwd", N_ILQR)]},
        {"name": "ilqr_forward_fused", "route": "cuda", "source": source + "ilqr_forward.cu",
         "replaces": "numpower_tpu/kernels/ilqr_forward.py:92", "launches": launches["fwd"],
         "max_abs_err": err["fwd"], "ms": ms[("fwd", N_ILQR)],
         "plain_ms": plain_ms[("fwd", N_ILQR)]},
    ]


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this run needs a GPU",
              file=sys.stderr)
        return 1

    from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista
    from numpower_tpu_torch.models import (
        MPCController, condense, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )
    from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 0: build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build/load {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    build_log = _build.library_path().with_suffix(".so.log")
    if build_log.is_file():
        for entry, line in ptxas_lines(build_log.read_text()):
            log(f"ptxas {entry}: {line}")

    A, B = quadrotor12(0.02)
    n, m = 12, 4
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    qp = condense(A, B, Q, R, QF, T, device=dev)
    d = T * m
    x0s = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((N, n)),
                          dtype=torch.float32, device=dev)
    iters = 40
    fista_ci, admm_ci = default_coarse_iters(qp, iters), admm_coarse_iters(qp, iters)
    rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    log(f"flagship: N={N} n={n} d={d} kappa={qp.kappa:.4f} schedules "
        f"FISTA {fista_ci}+{iters - fista_ci}, ADMM {admm_ci}+{iters - admm_ci}")
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T)

    # -- phase 1: kernels against their plain versions ------------------------
    def shift(U):
        return torch.cat([U[:, m:], U[:, -m:]], dim=1).contiguous()

    err = {"fista": 0.0, "admm": 0.0}
    f0, a0 = boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches
    U_cold, _ = boxqp_fista.fista_mpc_res_reference(*fold, x0s, LO, HI, qp.lipschitz,
                                                    iters, fista_ci)
    z_cold, _, _ = boxqp_admm.admm_mpc_res_reference(*fold, x0s, LO, HI, rho, iters,
                                                     admm_ci)
    warm = {"fista": shift(U_cold), "admm": shift(z_cold)}
    for coarse_f, coarse_a, tol in ((0, 0, 1e-5), (fista_ci, admm_ci, 1e-4)):
        for start in ("cold", "warm"):
            U0 = None if start == "cold" else warm["fista"]
            Uk, rk = boxqp_fista.fista_mpc_res(*fold, x0s, LO, HI, qp.lipschitz, iters,
                                               coarse_f, U0)
            Up, rpl = boxqp_fista.fista_mpc_res_reference(*fold, x0s, LO, HI, qp.lipschitz,
                                                          iters, coarse_f, U0)
            du, dr = (Uk - Up).abs().max().item(), abs(rk.item() - rpl.item())
            log(f"K2 fista {coarse_f}+{iters - coarse_f} {start}: max|dU| {du:.3e} "
                f"(tol {tol:g}) resid {rk.item():.3e} vs {rpl.item():.3e}")
            require(du <= tol and dr <= 1e-5, f"K2 fista {coarse_f} {start} vs plain")
            err["fista"] = max(err["fista"], du)

            U0 = None if start == "cold" else warm["admm"]
            zk, rpk, rdk = boxqp_admm.admm_mpc_res(*fold, x0s, LO, HI, rho, iters, coarse_a,
                                                   U0=U0)
            zp, rpp, rdp = boxqp_admm.admm_mpc_res_reference(*fold, x0s, LO, HI, rho, iters,
                                                             coarse_a, U0=U0)
            dz = (zk - zp).abs().max().item()
            drp, drd = abs(rpk.item() - rpp.item()), abs(rdk.item() - rdp.item())
            log(f"K1 admm {coarse_a}+{iters - coarse_a} {start}: max|dz| {dz:.3e} "
                f"(tol {tol:g}) r_prim {rpk.item():.3e} vs {rpp.item():.3e} "
                f"r_dual {rdk.item():.3e} vs {rdp.item():.3e}")
            require(dz <= tol and drp <= 1e-5 and drd <= 1e-5,
                    f"K1 admm {coarse_a} {start} vs plain")
            err["admm"] = max(err["admm"], dz)
    require(boxqp_fista.fista_mpc_res.launches - f0 == 4, "K2 launched once per call")
    require(boxqp_admm.admm_mpc_res.launches - a0 == 4, "K1 launched once per call")

    # -- phases 2-3: the main path, counted -----------------------------------
    boxqp_fista.fista_mpc_res.launches = 0
    boxqp_admm.admm_mpc_res.launches = 0

    xs = x0s[:N_E2E]
    res_f = solve_mpc_boxqp(qp, xs, LO, HI, iters=iters)
    res_a = solve_mpc_boxqp_admm(qp, xs, LO, HI, iters=iters)
    require(boxqp_fista.fista_mpc_res.launches == 1, "solve_mpc_boxqp went through K2")
    require(boxqp_admm.admm_mpc_res.launches == 1, "solve_mpc_boxqp_admm went through K1")
    f64 = [t.double() for t in fold]
    U64, _ = boxqp_fista.fista_mpc_res_reference(*f64, xs.double(), LO, HI,
                                                 qp.lipschitz.double(), iters, 0)
    rho64 = torch.sqrt(qp.lipschitz.double() * torch.clamp(qp.mu.double(), min=1e-12))
    z64, _, _ = boxqp_admm.admm_mpc_res_reference(*f64, xs.double(), LO, HI, rho64, iters, 0)
    e2e_f = (res_f.U.double() - U64).abs().max().item()
    e2e_a = (res_a.U.double() - z64).abs().max().item()
    log(f"e2e {N_E2E} scenarios vs float64: FISTA {e2e_f:.3e}, ADMM {e2e_a:.3e} (tol 1e-4)")
    require(e2e_f <= 1e-4 and e2e_a <= 1e-4, "end-to-end deviation from float64")

    A_t = torch.as_tensor(A, device=dev)
    B_t = torch.as_tensor(B, device=dev)
    ctrls = {}
    for solver, counter in (("fista", boxqp_fista.fista_mpc_res),
                            ("admm", boxqp_admm.admm_mpc_res)):
        ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, solver=solver, device=dev)
        ctrls[solver] = ctrl
        state, x = ctrl.init(N), x0s.clone()
        resids, in_box = [], []
        for _ in range(N_TICKS):
            before = counter.launches
            u0, state, resid = ctrl.step_with_residual(state, x)
            require(counter.launches == before + 1, f"{solver} tick launched its kernel once")
            resids.append(resid)
            in_box.append(((u0 >= LO) & (u0 <= HI)).all())
            x = x @ A_t.T + u0 @ B_t.T
        resids = torch.stack(resids).cpu()
        require(bool(torch.isfinite(resids).all()), f"{solver} serving residuals finite")
        require(bool(torch.stack(in_box).all()), f"{solver} serving u0 within the box")
        require(state.tick == N_TICKS and bool(torch.isfinite(x).all()),
                f"{solver} closed loop finite")
        log(f"serving {solver}: {N_TICKS} ticks x {N} scenarios, iters 30 "
            f"({ctrl.coarse_iters} bf16), residual first {resids[0].item():.3e} "
            f"last {resids[-1].item():.3e}, |x| {x.abs().max().item():.3e}")
    launches = {"fista": boxqp_fista.fista_mpc_res.launches,
                "admm": boxqp_admm.admm_mpc_res.launches}
    log(f"main-path launches: {launches}")
    require(launches == {"fista": 1 + N_TICKS, "admm": 1 + N_TICKS},
            "every main-path solve and tick went through the kernels")

    # -- phase 4: times ------------------------------------------------------
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_mpc_res(
            *fold, x0s, LO, HI, qp.lipschitz, iters, fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_mpc_res(
            *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv)),
    }
    plain_ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_mpc_res_reference(
            *fold, x0s, LO, HI, qp.lipschitz, iters, fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_mpc_res_reference(
            *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv)),
    }
    tick_ms = {}
    for solver, ctrl in ctrls.items():
        holder = [ctrl.init(N)]

        def tick(ctrl=ctrl, holder=holder):
            _, holder[0] = ctrl.step(holder[0], x0s)

        tick_ms[solver] = cuda_ms(tick)
    for solver in ("fista", "admm"):
        log(f"time {solver} ({iters} iters) per {N}-scenario solve: kernel {ms[solver]:.4f} ms, "
            f"plain {plain_ms[solver]:.4f} ms; serving tick (30 iters) {tick_ms[solver]:.4f} ms "
            f"[{smi}]")

    kernels = [
        {"name": "fista_mpc_res", "route": "cuda",
         "source": "numpower_tpu_torch/csrc/boxqp_fista.cu",
         "replaces": "numpower_tpu/kernels/boxqp_fista.py:299",
         "launches": launches["fista"], "max_abs_err": err["fista"],
         "ms": ms["fista"], "plain_ms": plain_ms["fista"]},
        {"name": "admm_mpc_res", "route": "cuda",
         "source": "numpower_tpu_torch/csrc/boxqp_admm.cu",
         "replaces": "numpower_tpu/kernels/boxqp_admm.py:353",
         "launches": launches["admm"], "max_abs_err": err["admm"],
         "ms": ms["admm"], "plain_ms": plain_ms["admm"]},
    ]
    kernels += riccati_family(dev, smi)
    kernels += boxqp_two_step(dev, smi, qp, x0s, rho)
    kernels += ilqr_family(dev, smi)
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
