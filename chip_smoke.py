#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (numpower_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the condensed box-QP MPC serving path of BASELINE config #4 (the
12-state quadrotor linearised about hover, horizon 30, 4096 scenarios,
controls boxed to +-1, so d = 120 controls per scenario) through the port's
entry points, and fails unless every phase passes:

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

The launch counters are zeroed just before phases 2-3 (the main path) and
read just after them. The last lines are one JSON object per kernel, the
card's name and power limit from nvidia-smi, and {"ok": true, "device": ...}.
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


def main() -> int:
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
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas " + line.strip())

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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
