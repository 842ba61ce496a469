#!/usr/bin/env python3
"""Where the fused batched EKF (K11) and the batched Kalman mean pass (K9)
spend their time on the card, and what each kernel's own duration is.

    python probes/ekf_kalman.py [before] [current]     (from the repository root)

First, for the repository's own library (built by
numpower_tpu_torch.kernels._build, no stamps): each kernel's mean duration
from torch.profiler (CUDA activity, 50 launches) beside its wrapper's
CUDA-event time, a direct library call's CUDA-event time and the wrapper's
host enqueue: K11 at the estimation bench's shape (B = 1024, T = 50; the
inputs of chip_smoke.py phase 11) on the pendulum (p = 1), the unicycle
(p = 2) and the planar quadrotor (p = 3); K9 at N = 4096, T = 50, n = 2,
p = 1 (chip_smoke.py phase 13's operands), without and with inputs, and at
N = 1003; ekf_filter_batched on the pendulum and kalman_filter_batched at
N = 4096; the ptxas lines (registers, spills) of every ekf:: and
kalman_mean:: instance; and, from cuobjdump -sass, the accurate sin/cos
range reductions in the step loop of each K11 instance (probes/
chain_floor.py's loop: the one with the most FFMA, along its likely path),
counted by the product by 2/pi that opens each and by the F2I that rounds
its quadrant, beside the whole instance's products by 2/pi.

Then, for each variant named, a library with cycle stamps built by nvcc
into build/probes/: ``before`` from probes/ekf_kalman_before.cu (the
kernels before their redesign) and ``current`` from probes/ekf_kalman.cu
(today's csrc/ekf.cu and kalman_mean.cu, whose stamp macros
probes/stamps.cuh fills in). Each stamped kernel adds the clock64() cycles
of its parts to a register per part and writes them out per thread; the
probe prints the mean over the threads and the slowest thread, the
CUDA-event time of the stamped kernel and its result against the plain
version, and the range reductions of its step loops. All results go to
stdout, with the card's name, power limit and SM clock from nvidia-smi.
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
sys.path.insert(0, str(ROOT / "probes"))

from chain_floor import fast_path, loops, opcode, sass_functions  # noqa: E402
from chip_smoke import cuda_ms, enqueue_ms, fmt_us, profiled_us, ptxas_lines  # noqa: E402
from chol_ukf import split, ukf_errors, ukf_problems  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402

SOURCES = {"before": ROOT / "probes" / "ekf_kalman_before.cu",
           "current": ROOT / "probes" / "ekf_kalman.cu"}
PARTS = {"before": {"K11": ["plant passes", "A P A' + Q", "h passes", "S + factor",
                            "substitutions+update+ll", "stores", "set-up+input loads"],
                    "K9": ["A, C, x0", "gains staging", "y/u staging + wait", "chain",
                           "stores"]},
         "current": {"K11": ["plant (n tangents)", "A P A' + Q", "h (n tangents)",
                             "S + factor", "substitutions+update+ll", "stores",
                             "set-up+input staging"],
                     "K9": ["A, C, x0", "staging copies", "staging wait",
                            "steps (chain + stores)"]}}
SIGNATURES = ("npt_ekf", "npt_kalman_mean")
TWO_OVER_PI = "0.63661974"  # the FFMA that opens each sinf/cosf range reduction
N_KF, N_RAGGED, T_KF = 4096, 1003, 50


def say(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def build(variant: str) -> tuple:
    src = SOURCES[variant]
    csrc = sorted((ROOT / "numpower_tpu_torch" / "csrc").glob("*.cu*"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *csrc,
                                                               ROOT / "probes" / "stamps.cuh"]))
    out = ROOT / "build" / "probes" / f"lib{variant}_ek_{digest.hexdigest()[:12]}.so"
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


def range_reductions(library: Path) -> dict:
    """{K11 instance: its accurate sinf/cosf range reductions}: the products
    by 2/pi (each reduction opens with one) and the F2I conversions (each
    reduction rounds its quadrant to an integer by one; the filter has no
    other) in its step loop's likely path, and the products by 2/pi in the
    whole instance."""
    out = {}
    for name, body in sass_functions(library).items():
        if "ekf_kernel" not in name:
            continue
        ranges = loops(body)
        ffma = lambda r: sum(opcode(body[i][1]).startswith("FFMA")  # noqa: E731
                             for i in range(r[0], r[1] + 1))
        path = []
        if ranges:
            path = fast_path(body, *max(ranges, key=lambda r: (ffma(r), r[0] - r[1])))
        out[name] = {"step loop 2/pi": sum(TWO_OVER_PI in t for t in path),
                     "step loop F2I": sum(opcode(t).startswith("F2I") for t in path),
                     "instance 2/pi": sum(TWO_OVER_PI in t for _, t in body)}
    return out


def ekf_direct_args(f, h, args):
    """npt_ekf's arguments as the wrapper hands them to the library (without
    the stream), and the operands and outputs (xs_f, Ps_f, xs_p, Ps_p, ll)."""
    from numpower_tpu_torch.kernels import ekf

    pl, me, ins, outs = ekf.kernel_operands(f, h, *args, what="EKF")
    ptrs = [t.data_ptr() for t in ins] + [outs[k].data_ptr() for k in (0, 2, 1, 3, 4)]
    B, T = args[4].shape[:2]
    return (pl.plant_id, *ekf.plant_floats(pl), me.measure_id, me.p, *ptrs, B, T), (ins, outs)


def kf_problems(dev) -> dict:
    """chip_smoke.py phase 13's K9 operands (the estimation bench's double
    integrator, N = 4096, T = 50, n = 2, p = 1) without and with inputs
    (B u), and without at N = 1003: {name: (wrapper args, npt_kalman_mean
    args without the stream, outputs (xs_f, xs_p, ll), the operands its
    pointers name)}."""
    from numpower_tpu_torch.kernels import kalman_mean
    from numpower_tpu_torch.models import double_integrator
    from numpower_tpu_torch.models.estimation import shared_gains

    t32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    A = t32(double_integrator(0.1).A)
    C, Q, R, P0 = t32([[1.0, 0.0]]), t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2), \
        t32(np.eye(2) * 0.1)
    rng = np.random.default_rng(11)
    yss = t32(rng.standard_normal((N_KF, T_KF, 1)))
    x0s = t32(rng.standard_normal((N_KF, 2)))
    Bu, uss = t32([[0.005], [0.1]]), t32(rng.standard_normal((N_KF, T_KF, 1)))
    Ws, _, _, invLs, logdets = shared_gains(A, C, Q, R, P0, T_KF)
    cst = kalman_mean._step_constants(logdets, 1).contiguous()
    out = {}
    for name, N, with_u in ((f"N={N_KF}", N_KF, False), (f"N={N_KF} inputs", N_KF, True),
                            (f"N={N_RAGGED}", N_RAGGED, False)):
        ys_t = yss[:N].transpose(0, 1).contiguous()
        us_t = (uss[:N] @ Bu.T).transpose(0, 1).contiguous() if with_u else None
        xs = [torch.empty((T_KF, N, 2), device=dev) for _ in range(2)]
        ll = torch.empty((N,), device=dev)
        x0 = x0s[:N].contiguous()
        direct = (A.data_ptr(), C.data_ptr(), Ws.data_ptr(), invLs.data_ptr(), cst.data_ptr(),
                  x0.data_ptr(), ys_t.data_ptr(), None if us_t is None else us_t.data_ptr(),
                  xs[0].data_ptr(), xs[1].data_ptr(), ll.data_ptr(), N, T_KF, 2, 1)
        out[name] = ((A, C, Ws, invLs, logdets, x0, ys_t, us_t), direct, (xs[0], xs[1], ll),
                     (cst, x0, ys_t, us_t))  # the last: what the direct call's pointers name
    return out


def kf_errors(outs, want) -> dict:
    return {"max_abs_dx": max((a - b).abs().max().item() for a, b in zip(outs[:2], want[:2])),
            "max_abs_dll": (outs[2] - want[2]).abs().max().item()}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import ekf, kalman_mean
    from numpower_tpu_torch.models import ekf_filter_batched, kalman_filter_batched

    variants = sys.argv[1:]
    dev = torch.device("cuda", 0)
    smi_q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"]
    say(f"device {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    lib = _build.library()
    build_log = _build.library_path().with_suffix(".so.log")
    for entry, line in ptxas_lines(build_log.read_text() if build_log.is_file() else ""):
        if any(ns in entry for ns in ("ekf::", "kalman_mean::")):
            say(f"repository ptxas {entry}: {line}")
    for name, row in range_reductions(_build.library_path()).items():
        say(f"repository sin/cos range reductions {name}: {json.dumps(row)}")
    stream = torch.cuda.current_stream(dev).cuda_stream

    res = {}
    problems = ukf_problems(dev)
    direct = {}
    for name, (f, h, args) in problems.items():
        dargs, keep = ekf_direct_args(f, h, args)
        direct[name] = (dargs, keep)
        res[f"K11 {name} N=1024 T=50"] = {
            "profiler": fmt_us(profiled_us(lambda f=f, h=h, args=args: ekf.ekf_batched(f, h, *args),
                                           ["ekf_kernel"])["ekf_kernel"]),
            "wrapper_ms": cuda_ms(lambda f=f, h=h, args=args: ekf.ekf_batched(f, h, *args)),
            "direct_ms": cuda_ms(lambda dargs=dargs: lib.npt_ekf(*dargs, stream)),
            "enqueue_ms": enqueue_ms(lambda f=f, h=h, args=args: ekf.ekf_batched(f, h, *args))}
    kf = kf_problems(dev)
    for name, (wargs, dargs, _, _) in kf.items():
        res[f"K9 {name} T={T_KF} n=2 p=1"] = {
            "profiler": fmt_us(profiled_us(lambda w=wargs: kalman_mean.kalman_mean_pass(*w),
                                           ["kalman_mean_kernel"])["kalman_mean_kernel"]),
            "wrapper_ms": cuda_ms(lambda w=wargs: kalman_mean.kalman_mean_pass(*w)),
            "direct_ms": cuda_ms(lambda d=dargs: lib.npt_kalman_mean(*d, stream)),
            "enqueue_ms": enqueue_ms(lambda w=wargs: kalman_mean.kalman_mean_pass(*w))}
    f, h, args = problems["pendulum_step"]
    res["ekf_filter_batched pendulum N=1024 T=50 ms"] = cuda_ms(
        lambda: ekf_filter_batched(f, h, *args))
    res["ekf_filter_batched enqueue ms"] = enqueue_ms(lambda: ekf_filter_batched(f, h, *args))
    A, C, _, _, _, x0, ys_t, _ = kf[f"N={N_KF}"][0]
    kf_mats = (A, C, torch.eye(2, device=dev) * 1e-3, torch.eye(1, device=dev) * 1e-2)
    yss = ys_t.transpose(0, 1)
    P0 = torch.eye(2, device=dev) * 0.1
    res[f"kalman_filter_batched N={N_KF} T={T_KF} ms"] = cuda_ms(
        lambda: kalman_filter_batched(*kf_mats, x0, P0, yss), reps=3, inner=1, warmup=1)
    for what, row in res.items():
        say(f"repository {what}: {json.dumps(row)}")
    ekf_ref = {name: ekf.ekf_reference(f, h, *args) for name, (f, h, args) in problems.items()}
    kf_ref = {name: kalman_mean.kalman_mean_pass_reference(*w) for name, (w, _, _, _) in kf.items()}

    stamps = torch.zeros(8 * (1 << 20), dtype=torch.int64, device=dev)
    for variant in variants:
        plib, path = build(variant)
        for name, row in range_reductions(path).items():
            say(f"{variant} sin/cos range reductions {name}: {json.dumps(row)}")
        for name, (dargs, (ins, outs)) in direct.items():
            def ecall(plib=plib, dargs=dargs):
                return plib.npt_ekf(*dargs, stream)

            row = split(plib, stamps, ecall, PARTS[variant]["K11"])
            row["stamped_ms"] = cuda_ms(ecall)
            row.update(ukf_errors(outs, ekf_ref[name]))
            say(f"{variant} K11 {name} N=1024 T=50: {json.dumps(row)}")
        for name, (_, dargs, outs, _) in kf.items():
            def kcall(plib=plib, dargs=dargs):
                return plib.npt_kalman_mean(*dargs, stream)

            row = split(plib, stamps, kcall, PARTS[variant]["K9"])
            row["stamped_ms"] = cuda_ms(kcall)
            row.update(kf_errors(outs, kf_ref[name]))
            say(f"{variant} K9 {name} T={T_KF}: {json.dumps(row)}")
    say(f"clocks after: {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
