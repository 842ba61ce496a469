#!/usr/bin/env python3
"""Where the fused MPPI (K13) and the fused per-scenario Riccati (K5) spend
their time on the card, and what each kernel's own duration is.

    python probes/mppi_riccati.py [before] [current] [--sass DIR]

(from the repository root). With --sass, the SASS of the repository's
mppi_kernel<1, 1> (the pendulum, a sample a thread) and riccati_kernel<12, 4>
is written to DIR, one file each, for reading the step loops.

First, for the repository's own library (built by
numpower_tpu_torch.kernels._build, no stamps): each kernel's mean duration
from torch.profiler (CUDA activity) beside its wrapper's CUDA-event time, a
direct library call's CUDA-event time and the wrapper's host enqueue, for
K13 at the MPPI bench's shape (pendulum, N = K = 256, T = 40, 8 rounds) and
at N = 4096 (eps drawn in the kernel's layout, 1.3 GB), and for K5 at
N = 4096, T = 30 (the quadrotor, n = 12, m = 4); riccati_scan_per_scenario
by "auto" at N = 4096, T = 30 and mppi_solve_batched at the bench's shape;
the ptxas lines (registers, spills) of every mppi:: and riccati:: instance,
and the LDS, STS, FFMA and FMUL/FADD counts of each instance's SASS
(cuobjdump -sass).

Then, for each variant named, a library with cycle stamps built by nvcc
into build/probes/: ``before`` from probes/mppi_riccati_before.cu (the
kernels before their redesign) and ``current`` from probes/mppi_riccati.cu
(today's csrc/mppi.cu and riccati.cu, whose stamp macros probes/stamps.cuh
fills in). Each stamped kernel adds the clock64() cycles of its parts to a
register per part and writes them out per thread; the probe prints the mean
over the threads and the slowest thread, the CUDA-event time of the stamped
kernel, its result against the plain version, and the same SASS counts of
the variant's instances. All results go to stdout, with the card's name,
power limit and SM clock from nvidia-smi.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    cuda_ms, enqueue_ms, fmt_us, profiled_us, ptxas_lines, sass_by_kernel, sass_opcode_counts,
)
from numpower_tpu_torch.kernels import _build  # noqa: E402

SOURCES = {"before": ROOT / "probes" / "mppi_riccati_before.cu",
           "current": ROOT / "probes" / "mppi_riccati.cu"}
K13_PARTS = ["staging", "rollout", "min", "sum", "ess", "update", "write-back"]
PARTS = {"before": {"K13": K13_PARTS,
                    "K5": ["staging", "PA/PB", "S+factor", "K", "P'", "warp syncs",
                           "write-back"]},
         "current": {"K13": K13_PARTS,
                     "K5": ["staging", "y=PM", "z=M'y", "S gather+factor", "K", "P'",
                            "warp syncs+write-back"]}}
SIGNATURES = ("npt_mppi", "npt_riccati_fused")
# npt_mppi as the kernel before its redesign took it: the constants in a
# device tensor, no plan (plant, 8 parameters, consts, x0s, eps, us0, us,
# ess, N, K, T, iters, lam, inv_lam, clip, lo, hi, stream)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BEFORE_SIGNATURES = {"npt_mppi": (_I,) + (_F,) * 8 + (_P,) * 6 + (_I,) * 4
                     + (_F, _F, _I, _F, _F, _P)}
OPCODES = ("LDS", "STS", "LDG", "LDL", "STL", "FFMA", "FMUL", "FADD", "SHFL", "BAR",
           "CALL")
STAMP_THREADS = 1 << 20


def say(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def build(variant: str) -> tuple:
    src = SOURCES[variant]
    csrc = sorted((ROOT / "numpower_tpu_torch" / "csrc").glob("*.cu*"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *csrc,
                                                               ROOT / "probes" / "stamps.cuh"]))
    out = ROOT / "build" / "probes" / f"lib{variant}_mr_{digest.hexdigest()[:12]}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        for entry, line in ptxas_lines(log):
            say(f"{variant} ptxas {entry}: {line}")
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for name in SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = (BEFORE_SIGNATURES if variant == "before" else {}).get(
            name, _build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.probe_set_stamps.argtypes = (ctypes.c_void_p,)
    lib.probe_set_stamps.restype = ctypes.c_int
    return lib, out


def split(lib, stamps: torch.Tensor, call, parts: list) -> dict:
    """Run `call` four times with the stamps on, each launch overwriting the
    last one's: cycles of each part in the fourth (warm) launch, mean over
    the threads that ran and the slowest thread's."""
    stamps.zero_()
    assert lib.probe_set_stamps(stamps.data_ptr()) == 0
    for _ in range(4):
        code = call()
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code} "
                               f"({_build.library().npt_error_string(code).decode()})")
    torch.cuda.synchronize()
    st = stamps.view(-1, 8).cpu().double()
    st = st[st[:, 7] > 0]
    worst = st[st[:, 7].argmax()]
    return {"threads": int(st.shape[0]),
            "mean_cycles": {p: round(st[:, i].mean().item(), 1) for i, p in enumerate(parts)},
            "slowest_thread_cycles": {p: worst[i].item() for i, p in enumerate(parts)},
            "total_cycles": {"mean": round(st[:, 7].mean().item(), 1), "max": worst[7].item()}}


def log_sass(what: str, library) -> None:
    counts = sass_opcode_counts(library, OPCODES)
    for name, row in sorted(counts.items()):
        if "mppi::" in name or "riccati::" in name:
            say(f"{what} SASS {name}: {json.dumps(row)}")


def old_mppi_args(mppi, plant_floats, cost, x0s, eps, us0, kw):
    """npt_mppi's arguments as the kernel before its redesign takes them
    (the constants packed in one device tensor), with its outputs."""
    from numpower_tpu_torch.models.plants import kernel_plant

    plant = kernel_plant(kw["f"])
    Q, R, QF, goal = (np.asarray(a, np.float32) for a in cost.kernel)
    inv_sig2 = np.array([1.0 / (s * s) for s in mppi.sigma_tuple(kw["sigma"], kw["m"])],
                        np.float32)
    consts = torch.from_numpy(np.concatenate([Q.ravel(), R.ravel(), QF.ravel(), goal,
                                              inv_sig2])).to(x0s.device)
    N, K = eps.shape[1:]
    us = torch.empty((N, kw["T"], kw["m"]), device=x0s.device)
    ess = torch.empty((N, kw["iters"]), device=x0s.device)
    keep = (consts, x0s, eps, us0, us, ess)
    args = (plant.plant_id, *plant_floats(plant), *(t.data_ptr() for t in keep), N, K, kw["T"],
            kw["iters"], 1.0, 1.0, 0, -float("inf"), float("inf"))
    return args, keep, (us, ess)


def package_mppi_args(mppi, plant_floats, cost, x0s, eps, us0, kw):
    """npt_mppi's arguments as the package's wrapper hands them to its own
    library, with its outputs."""
    opts = dict(T=kw["T"], iters=kw["iters"], m=kw["m"], sigma=kw["sigma"])
    if hasattr(mppi, "kernel_args"):  # the redesigned wrapper's helper
        args, tensors = mppi.kernel_args(kw["f"], cost, x0s, eps, us0, lam=1.0, **opts)
        return args, tensors, tensors[-2:]
    plant, floats, ins, outs = mppi.kernel_operands(kw["f"], cost, x0s, eps, us0, **opts)
    keep = (*ins, *outs)
    N, K = eps.shape[1:]
    args = (plant.plant_id, *floats, *(t.data_ptr() for t in keep), N, K, kw["T"], kw["iters"],
            1.0, 1.0, 0, -float("inf"), float("inf"))
    return args, keep, outs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import mppi, riccati
    from numpower_tpu_torch.kernels.ekf import plant_floats
    from numpower_tpu_torch.models import (
        mppi_solve_batched, pendulum_step, quadratic_mppi_cost, quadrotor12,
        riccati_scan_per_scenario,
    )

    args = sys.argv[1:]
    sass_dir = None
    if "--sass" in args:
        i = args.index("--sass")
        sass_dir = Path(args[i + 1])
        del args[i:i + 2]
    variants = args
    dev = torch.device("cuda", 0)
    smi_q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"]
    say(f"device {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    lib = _build.library()
    build_log = _build.library_path().with_suffix(".so.log")
    for entry, line in ptxas_lines(build_log.read_text() if build_log.is_file() else ""):
        if "mppi::" in entry or "riccati::" in entry:
            say(f"repository ptxas {entry}: {line}")
    log_sass("repository", _build.library_path())
    if sass_dir is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        for name, body in sass_by_kernel(_build.library_path()).items():
            for want, fname in (("mppi::mppi_kernel<1, 1>", "mppi_kernel_1_1.sass"),
                                ("riccati::riccati_kernel<12, 4>", "riccati_kernel_12_4.sass")):
                if want in name:
                    (sass_dir / fname).write_text("\n".join(body))
    stream = torch.cuda.current_stream(dev).cuda_stream
    t32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)  # noqa: E731

    # K13 at the MPPI bench's shape (chip_smoke.py phase 14) and at N = 4096
    N_M, K_M, T_M, IT_M, N_BIG = 256, 256, 40, 8, 4096
    cost = quadratic_mppi_cost(np.diag([1.0, 0.1]), np.eye(1) * 0.01, np.diag([100.0, 10.0]),
                               np.zeros(2))
    x0s = t32(np.random.default_rng(8).uniform(-np.pi, np.pi, (N_M, 2)))
    eps = mppi.eps_kernel_layout(gen(0), N_M, IT_M, T_M, 1, K_M, 1.0)
    us0 = torch.zeros(T_M, device=dev)
    kw = dict(f=pendulum_step, T=T_M, iters=IT_M, m=1, sigma=1.0)
    fused = dict(T=T_M, iters=IT_M, m=1, lam=1.0, sigma=1.0)
    x0_big = x0s.repeat(N_BIG // N_M, 1).contiguous()
    eps_big = mppi.eps_direct_layout(gen(1), N_BIG, IT_M, T_M, 1, K_M, 1.0)
    margs, mkeep, _ = package_mppi_args(mppi, plant_floats, cost, x0s, eps, us0, kw)
    bargs, bkeep, _ = package_mppi_args(mppi, plant_floats, cost, x0_big, eps_big, us0, kw)

    # K5 at N = 4096, T = 30 (chip_smoke.py phase 7)
    N, T, n, m = 4096, 30, 12, 4
    A, B = quadrotor12(0.02)
    rng = np.random.default_rng(4)
    As = t32(np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, n, n)))
    Bs = t32(B).expand(N, n, m)
    costs = (t32(np.eye(n)), t32(np.eye(m) * 0.1), t32(np.eye(n) * 5.0))
    Bc = Bs.contiguous()
    Ks_o = torch.empty((N, T, m, n), device=dev)
    P0_o = torch.empty((N, n, n), device=dev)
    r_ptrs = [t.data_ptr() for t in (As, Bc, *costs, Ks_o, P0_o)]

    res = {
        f"K13 N={N_M} K={K_M} T={T_M} iters={IT_M}": {
            "profiler": fmt_us(profiled_us(
                lambda: mppi.mppi_fused(pendulum_step, cost, x0s, eps, us0, **fused),
                ["mppi_kernel"])["mppi_kernel"]),
            "wrapper_ms": cuda_ms(lambda: mppi.mppi_fused(pendulum_step, cost, x0s, eps, us0,
                                                          **fused)),
            "direct_ms": cuda_ms(lambda: lib.npt_mppi(*margs, stream)),
            "enqueue_ms": enqueue_ms(lambda: mppi.mppi_fused(pendulum_step, cost, x0s, eps, us0,
                                                             **fused))},
        f"K13 N={N_BIG} K={K_M} T={T_M} iters={IT_M} (direct call)": {
            "profiler": fmt_us(profiled_us(lambda: lib.npt_mppi(*bargs, stream), ["mppi_kernel"],
                                           10)["mppi_kernel"]),
            "direct_ms": cuda_ms(lambda: lib.npt_mppi(*bargs, stream), reps=3, inner=3,
                                 warmup=1)},
        f"K5 N={N} T={T}": {
            "profiler": fmt_us(profiled_us(
                lambda: riccati.riccati_batched_fused(As, Bs, *costs, T),
                ["riccati_kernel"])["riccati_kernel"]),
            "wrapper_ms": cuda_ms(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T)),
            "direct_ms": cuda_ms(lambda: lib.npt_riccati_fused(*r_ptrs, N, n, m, T, stream)),
            "enqueue_ms": enqueue_ms(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T))},
    }
    res[f"riccati_scan_per_scenario auto N={N} T={T} ms"] = cuda_ms(
        lambda: riccati_scan_per_scenario(As, Bs, *costs, T))
    res[f"mppi_solve_batched N={N_M} K={K_M} T={T_M} iters={IT_M} ms"] = cuda_ms(
        lambda: mppi_solve_batched(pendulum_step, x0s, cost, T_M, gen(0), samples=K_M,
                                   iters=IT_M, m=1), reps=5, inner=2, warmup=1)
    for what, row in res.items():
        say(f"repository {what}: {json.dumps(row)}")
    us_pkg, ess_pkg = mppi.mppi_fused(pendulum_step, cost, x0s, eps, us0, **fused)
    Ks_ref, P0_ref = riccati.riccati_batched_reference(As, Bs, *costs, T)
    del eps_big, bargs, bkeep

    stamps = torch.zeros(8 * STAMP_THREADS, dtype=torch.int64, device=dev)
    for variant in variants:
        plib, lib_path = build(variant)
        make = old_mppi_args if variant == "before" else package_mppi_args
        vargs, vkeep, (us_v, ess_v) = make(mppi, plant_floats, cost, x0s, eps, us0, kw)

        def call(plib=plib, vargs=vargs):
            return plib.npt_mppi(*vargs, stream)

        row = split(plib, stamps, call, PARTS[variant]["K13"])
        row["stamped_ms"] = cuda_ms(call)
        row["max_abs_dus_vs_package_kernel"] = (us_v - us_pkg).abs().max().item()
        row["max_rel_dess_vs_package_kernel"] = ((ess_v / ess_pkg) - 1).abs().max().item()
        say(f"{variant} K13 N={N_M} K={K_M} T={T_M} iters={IT_M}: {json.dumps(row)}")

        def rcall(plib=plib):
            return plib.npt_riccati_fused(*r_ptrs, N, n, m, T, stream)

        row = split(plib, stamps, rcall, PARTS[variant]["K5"])
        row["stamped_ms"] = cuda_ms(rcall)
        row["max_abs_dKs_vs_plain"] = (Ks_o - Ks_ref).abs().max().item()
        row["max_abs_dP0_vs_plain"] = (P0_o - P0_ref).abs().max().item()
        say(f"{variant} K5 N={N} T={T} n={n} m={m}: {json.dumps(row)}")
        log_sass(variant, lib_path)
        del vkeep
    say(f"clocks after: {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
