#!/usr/bin/env python3
"""Where the batched Cholesky (K6a) and the fused batched UKF (K12) spend
their time on the card, and what each kernel's own duration is.

    python probes/chol_ukf.py [before] [current]     (from the repository root)

First, for the repository's own library (built by
numpower_tpu_torch.kernels._build, no stamps): each kernel's mean duration
from torch.profiler (CUDA activity, 50 launches) beside its wrapper's
CUDA-event time, a direct library call's CUDA-event time and the wrapper's
host enqueue, for K6a at chip_smoke.py's timed shape (4096, 12, 12) beside
torch.linalg.cholesky, and for K12 at the estimation bench's shape (N =
1024, T = 50) on the pendulum (p = 1), the unicycle (p = 2) and the planar
quadrotor (p = 3); ukf_filter_batched on the pendulum; and the ptxas lines
(registers, spills) of every smallmat::, ukf:: and ekf:: instance.

Then, for each variant named, a library with cycle stamps built by nvcc
into build/probes/: ``before`` from probes/chol_ukf_before.cu (the kernels
before their redesign) and ``current`` from probes/chol_ukf.cu (today's
csrc/cholesky.cu and ukf.cu, whose stamp macros probes/stamps.cuh fills
in). Each stamped kernel adds the clock64() cycles of its parts to a
register per part and writes them out per thread; the probe prints the mean
over the threads and the slowest thread, the CUDA-event time of the stamped
kernel and its result against the plain version. All results go to stdout,
with the card's name, power limit and SM clock from nvidia-smi.
"""

from __future__ import annotations

import ctypes
import functools
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
    cuda_ms, enqueue_ms, fmt_us, profiled_us, ptxas_lines, spd_batch,
)
from numpower_tpu_torch.kernels import _build  # noqa: E402

SOURCES = {"before": ROOT / "probes" / "chol_ukf_before.cu",
           "current": ROOT / "probes" / "chol_ukf.cu"}
PARTS = {"before": {"K6a": ["staging", "factor", "write-back"],
                    "K12": ["spread+sigma+f", "predicted moments", "update points+h+moments",
                            "factor+solve+ll", "stores", "set-up"]},
         "current": {"K6a": ["staging", "factor", "write-back"],
                     "K12": ["spread+sigma+f", "predicted moments", "update points+h+moments",
                             "factor+solve+ll", "stores", "set-up", "input staging"]}}
SIGNATURES = ("npt_cholesky_batched", "npt_ukf")
STAMP_THREADS = 1 << 20
N_CHOL, DIM, N_UKF, T_UKF = 4096, 12, 1024, 50


def say(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def build(variant: str) -> tuple:
    src = SOURCES[variant]
    csrc = sorted((ROOT / "numpower_tpu_torch" / "csrc").glob("*.cu*"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *csrc,
                                                               ROOT / "probes" / "stamps.cuh"]))
    out = ROOT / "build" / "probes" / f"lib{variant}_cu_{digest.hexdigest()[:12]}.so"
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
        fn.argtypes = _build._SIGNATURES[name]
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


def ukf_problems(dev) -> dict:
    """chip_smoke.py phase 11's filters: {plant: (f, h, (Q, R, x0s, P0, yss,
    uss))} at N = 1024, T = 50, h the first p components."""
    from numpower_tpu_torch.models import (
        first_components, pendulum_step, planar_quadrotor_step, unicycle_step,
    )

    t32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    out = {}
    for f, n, m, p in ((pendulum_step, 2, 1, 1), (unicycle_step, 3, 2, 2),
                       (planar_quadrotor_step, 6, 2, 3)):
        r = np.random.default_rng(11)
        u_nom = 0.5 * 9.81 if f is planar_quadrotor_step else 0.0
        out[f.__name__] = (f, functools.partial(first_components, k=p), (
            t32(np.eye(n) * 1e-3), t32(np.eye(p) * 1e-2), t32(0.3 * r.standard_normal((N_UKF, n))),
            t32(np.eye(n) * 0.1), t32(r.standard_normal((N_UKF, T_UKF, p))),
            t32(0.1 * r.standard_normal((N_UKF, T_UKF, m)) + u_nom)))
    return out


def ukf_direct_args(f, h, args):
    """npt_ukf's arguments as the wrapper hands them to the library (without
    the stream), and the outputs (xs_f, Ps_f, xs_p, Ps_p, ll) they fill."""
    from numpower_tpu_torch.kernels import ekf, ukf

    pl, me, ins, outs = ekf.kernel_operands(f, h, *args, what="UKF")
    n = args[2].shape[1]
    weights = [ctypes.c_float(w) for w in ukf.sigma_weights(n, 1.0, 2.0, 0.0) + (ukf.JITTER,)]
    ptrs = [t.data_ptr() for t in ins] + [outs[k].data_ptr() for k in (0, 2, 1, 3, 4)]
    B, T = args[4].shape[:2]
    return (pl.plant_id, *ekf.plant_floats(pl), me.measure_id, me.p, *weights, *ptrs, B, T), \
        (ins, outs)


def ukf_errors(outs, want) -> dict:
    dx = max((a - b).abs().max().item() for a, b in zip(outs[0::2][:2], want[0::2][:2]))
    dP = max((a - b).abs().max().item() for a, b in zip(outs[1::2][:2], want[1::2][:2]))
    return {"max_abs_dx": dx, "max_abs_dP": dP,
            "max_abs_dll": (outs[4] - want[4]).abs().max().item()}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import cholesky, ukf
    from numpower_tpu_torch.models import ukf_filter_batched

    variants = sys.argv[1:]
    dev = torch.device("cuda", 0)
    smi_q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"]
    say(f"device {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    lib = _build.library()
    build_log = _build.library_path().with_suffix(".so.log")
    for entry, line in ptxas_lines(build_log.read_text() if build_log.is_file() else ""):
        if any(ns in entry for ns in ("smallmat::", "ukf::", "ekf::")):
            say(f"repository ptxas {entry}: {line}")
    stream = torch.cuda.current_stream(dev).cuda_stream

    a12 = spd_batch(N_CHOL, DIM, 2, dev)
    L_out = torch.empty_like(a12)
    res = {f"K6a ({N_CHOL},{DIM},{DIM})": {
        "profiler": fmt_us(profiled_us(lambda: cholesky.cholesky_batched(a12),
                                       ["cholesky_kernel"])["cholesky_kernel"]),
        "wrapper_ms": cuda_ms(lambda: cholesky.cholesky_batched(a12)),
        "direct_ms": cuda_ms(lambda: lib.npt_cholesky_batched(a12.data_ptr(), L_out.data_ptr(),
                                                              N_CHOL, DIM, stream)),
        "enqueue_ms": enqueue_ms(lambda: cholesky.cholesky_batched(a12)),
        "torch.linalg.cholesky_ms": cuda_ms(lambda: torch.linalg.cholesky(a12))}}
    problems = ukf_problems(dev)
    direct = {}
    for name, (f, h, args) in problems.items():
        dargs, keep = ukf_direct_args(f, h, args)
        direct[name] = (dargs, keep)
        res[f"K12 {name} N={N_UKF} T={T_UKF}"] = {
            "profiler": fmt_us(profiled_us(lambda f=f, h=h, args=args: ukf.ukf_batched(f, h, *args),
                                           ["ukf_kernel"])["ukf_kernel"]),
            "wrapper_ms": cuda_ms(lambda f=f, h=h, args=args: ukf.ukf_batched(f, h, *args)),
            "direct_ms": cuda_ms(lambda dargs=dargs: lib.npt_ukf(*dargs, stream)),
            "enqueue_ms": enqueue_ms(lambda f=f, h=h, args=args: ukf.ukf_batched(f, h, *args))}
    f, h, args = problems["pendulum_step"]
    res[f"ukf_filter_batched pendulum N={N_UKF} T={T_UKF} ms"] = cuda_ms(
        lambda: ukf_filter_batched(f, h, *args))
    for what, row in res.items():
        say(f"repository {what}: {json.dumps(row)}")
    L_ref = cholesky.cholesky_batched_reference(a12)
    ukf_ref = {name: ukf.ukf_reference(f, h, *args) for name, (f, h, args) in problems.items()}

    stamps = torch.zeros(8 * STAMP_THREADS, dtype=torch.int64, device=dev)
    for variant in variants:
        plib, _ = build(variant)
        L_v = torch.empty_like(a12)

        def ccall(plib=plib, L_v=L_v):
            return plib.npt_cholesky_batched(a12.data_ptr(), L_v.data_ptr(), N_CHOL, DIM, stream)

        row = split(plib, stamps, ccall, PARTS[variant]["K6a"])
        row["stamped_ms"] = cuda_ms(ccall)
        row["max_abs_err_vs_plain"] = (L_v - L_ref).abs().max().item()
        row["nonzeros_above_diagonal"] = int(torch.triu(L_v, 1).count_nonzero())
        say(f"{variant} K6a ({N_CHOL},{DIM},{DIM}): {json.dumps(row)}")
        for name, (dargs, (ins, outs)) in direct.items():
            def ucall(plib=plib, dargs=dargs):
                return plib.npt_ukf(*dargs, stream)

            row = split(plib, stamps, ucall, PARTS[variant]["K12"])
            row["stamped_ms"] = cuda_ms(ucall)
            row.update(ukf_errors(outs, ukf_ref[name]))
            say(f"{variant} K12 {name} N={N_UKF} T={T_UKF}: {json.dumps(row)}")
    say(f"clocks after: {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
