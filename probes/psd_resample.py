#!/usr/bin/env python3
"""Where the batched SPD solve (K6b) and the systematic resample (K14) spend
their time on the card, and what each kernel's own duration is.

    python probes/psd_resample.py [before] [current]     (PYTHONPATH = the repository root)

First, for the repository's own library (built by
numpower_tpu_torch.kernels._build, no stamps): each kernel's mean duration
from torch.profiler (CUDA activity, 50 launches) beside its wrapper's
CUDA-event time, a direct library call's CUDA-event time and the wrapper's
host enqueue, for K5, K6a, K6b and K14 at chip_smoke.py's timed shapes (K5
N = 4096, T = 30; K6a (4096, 12, 12); K6b (4096, 4, 4) x (4096, 4, 12) and
(4096, 12, 12) x (4096, 12, 4); K14 B = 256, N = 1024, n = 2); the psd route
of riccati_scan_per_scenario at N = 4096, T = 30 and particle_filter_batched
at B = 256, N = 1024, T = 50; and the ptxas lines (registers, spills) of
every smallmat:: and pf_resample:: instance.

Then, for each variant named, a library with cycle stamps built by nvcc
into build/probes/: ``before`` from probes/psd_resample_before.cu (the
kernels before their redesign) and ``current`` from probes/psd_resample.cu
(today's csrc/cholesky.cu and pf_resample.cu, whose stamp macros
probes/stamps.cuh fills in). Each stamped kernel adds the clock64() cycles
of its parts (K6b: staging, factor, solve, write-back; K14: staging,
search, gather, store) to a register per part and writes them out per
thread; the probe prints the mean over the threads and the slowest thread,
and the CUDA-event time of the stamped kernel beside the unstamped one. All
results go to stdout, with the card's name, power limit and SM clock from
nvidia-smi.
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

SOURCES = {"before": ROOT / "probes" / "psd_resample_before.cu",
           "current": ROOT / "probes" / "psd_resample.cu"}
PARTS = {"K6b": ["staging", "factor", "solve", "write-back"],
         "K14": ["staging", "search", "gather", "store"]}
SIGNATURES = ("npt_psd_solve_batched", "npt_resample_systematic")


def say(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def build(variant: str) -> ctypes.CDLL:
    src = SOURCES[variant]
    csrc = sorted((ROOT / "numpower_tpu_torch" / "csrc").glob("*.cu*"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *csrc,
                                                               ROOT / "probes" / "stamps.cuh"]))
    out = ROOT / "build" / "probes" / f"lib{variant}_{digest.hexdigest()[:12]}.so"
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
    return lib


def split(lib, stamps: torch.Tensor, call, parts: list) -> dict:
    """Run `call` four times with the stamps on, each launch overwriting the
    last one's: cycles of each part in the fourth (warm) launch, mean over
    the threads that ran and the slowest thread's."""
    stamps.zero_()
    assert lib.probe_set_stamps(stamps.data_ptr()) == 0
    for _ in range(4):
        assert call() == 0, "launch failed"
    torch.cuda.synchronize()
    st = stamps.view(-1, 8).cpu().double()
    st = st[st[:, 7] > 0]
    worst = st[st[:, 7].argmax()]
    return {"threads": int(st.shape[0]),
            "mean_cycles": {p: st[:, i].mean().item() for i, p in enumerate(parts)},
            "slowest_thread_cycles": {p: worst[i].item() for i, p in enumerate(parts)},
            "total_cycles": {"mean": st[:, 7].mean().item(), "max": worst[7].item()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import cholesky, pf_resample, riccati
    from numpower_tpu_torch.models import (
        first_components, particle_filter_batched, pendulum_step, quadrotor12,
        riccati_scan_per_scenario,
    )
    from numpower_tpu_torch.models.particle import _resample_slots

    variants = sys.argv[1:]
    dev = torch.device("cuda", 0)
    smi_q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"]
    say(f"device {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    lib = _build.library()
    build_log = _build.library_path().with_suffix(".so.log")
    for entry, line in ptxas_lines(build_log.read_text() if build_log.is_file() else ""):
        if "smallmat::" in entry or "pf_resample::" in entry:
            say(f"repository ptxas {entry}: {line}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    t32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731

    # the timed shapes of chip_smoke.py phases 7 and 16
    N, T, n, m = 4096, 30, 12, 4
    A, B = quadrotor12(0.02)
    rng = np.random.default_rng(4)
    As = t32(np.tile(A, (N, 1, 1)) + 0.01 * rng.standard_normal((N, n, n)))
    Bs = t32(B).expand(N, n, m)
    costs = (t32(np.eye(n)), t32(np.eye(m) * 0.1), t32(np.eye(n) * 5.0))
    solves = {"K6b (4096,4,4)x(4096,4,12)": (spd_batch(N, m, 1, dev),
                                             t32(np.random.default_rng(11).standard_normal(
                                                 (N, m, n)))),
              "K6b (4096,12,12)x(4096,12,4)": (spd_batch(N, n, 3, dev),
                                               t32(np.random.default_rng(12).standard_normal(
                                                   (N, n, m))))}
    a12 = spd_batch(N, n, 3, dev)
    B_PF, N_PF = 256, 1024
    r = np.random.default_rng(15)
    parts = t32(r.standard_normal((B_PF, N_PF, 2)))
    m_t = _resample_slots(t32(np.random.default_rng(16).uniform(size=B_PF)),
                          t32(2.0 * r.standard_normal((B_PF, N_PF))), N_PF)
    res = {}
    for what, (a, b) in solves.items():
        x = torch.empty_like(b)
        dims = (a.shape[0], a.shape[1], b.shape[2])
        res[what] = {
            "profiler": fmt_us(profiled_us(lambda a=a, b=b: cholesky.psd_solve_batched(a, b),
                                           ["psd_solve_kernel"])["psd_solve_kernel"]),
            "wrapper_ms": cuda_ms(lambda a=a, b=b: cholesky.psd_solve_batched(a, b)),
            "direct_ms": cuda_ms(lambda a=a, b=b, x=x, dims=dims: lib.npt_psd_solve_batched(
                a.data_ptr(), b.data_ptr(), x.data_ptr(), *dims, stream)),
            "enqueue_ms": enqueue_ms(lambda a=a, b=b: cholesky.psd_solve_batched(a, b))}
    L = torch.empty_like(a12)
    res["K6a (4096,12,12)"] = {
        "profiler": fmt_us(profiled_us(lambda: cholesky.cholesky_batched(a12),
                                       ["cholesky_kernel"])["cholesky_kernel"]),
        "wrapper_ms": cuda_ms(lambda: cholesky.cholesky_batched(a12)),
        "direct_ms": cuda_ms(lambda: lib.npt_cholesky_batched(a12.data_ptr(), L.data_ptr(), N, n,
                                                              stream)),
        "enqueue_ms": enqueue_ms(lambda: cholesky.cholesky_batched(a12))}
    res["K5 N=4096 T=30"] = {
        "profiler": fmt_us(profiled_us(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T),
                                       ["riccati_kernel"])["riccati_kernel"]),
        "wrapper_ms": cuda_ms(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T)),
        "enqueue_ms": enqueue_ms(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T))}
    out = torch.empty_like(parts)
    res["K14 B=256 N=1024 n=2"] = {
        "profiler": fmt_us(profiled_us(lambda: pf_resample.resample_systematic(parts, m_t),
                                       ["resample_kernel"])["resample_kernel"]),
        "wrapper_ms": cuda_ms(lambda: pf_resample.resample_systematic(parts, m_t)),
        "direct_ms": cuda_ms(lambda: lib.npt_resample_systematic(
            parts.data_ptr(), m_t.data_ptr(), out.data_ptr(), B_PF, N_PF, 2, stream)),
        "enqueue_ms": enqueue_ms(lambda: pf_resample.resample_systematic(parts, m_t))}
    slow = {"reps": 5, "inner": 1, "warmup": 1}
    res["riccati_scan_per_scenario psd N=4096 T=30 ms"] = cuda_ms(
        lambda: riccati_scan_per_scenario(As, Bs, *costs, T, method="psd"), **slow)
    pr = np.random.default_rng(12)
    pf_args = (pendulum_step, functools.partial(first_components, k=1), t32(np.eye(2) * 1e-4),
               t32(np.eye(1) * 2.5e-3), t32(0.3 * pr.standard_normal((B_PF, 2))), t32(np.eye(2)),
               t32(pr.standard_normal((B_PF, 50, 1))), torch.zeros((B_PF, 50, 1), device=dev))
    res["particle_filter_batched B=256 N=1024 T=50 ms"] = cuda_ms(
        lambda: particle_filter_batched(*pf_args, torch.Generator(device=dev).manual_seed(0),
                                        n_particles=N_PF), **slow)
    # the host's time for each piece of K6b's wrapper (enqueue_ms: mean host
    # time a call, no wait for the card)
    from numpower_tpu_torch.kernels.boxqp_fista import _check_operand

    a4, b4 = solves["K6b (4096,4,4)x(4096,4,12)"]
    x4 = torch.empty_like(b4)
    res["K6b wrapper host parts ms"] = {
        "checks": enqueue_ms(lambda: (cholesky._batch_shape(a4), a4.contiguous(),
                                      b4.contiguous(), _check_operand("a", a4, a4.device,
                                                                      (N, m, m)),
                                      _check_operand("b", b4, a4.device, (N, m, n)))),
        "empty_like": enqueue_ms(lambda: torch.empty_like(b4)),
        "current_device": enqueue_ms(lambda: torch.cuda.current_device()),
        "current_stream": enqueue_ms(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": enqueue_ms(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "data_ptrs": enqueue_ms(lambda: (a4.data_ptr(), b4.data_ptr(), x4.data_ptr())),
        "direct_call": enqueue_ms(lambda: lib.npt_psd_solve_batched(
            a4.data_ptr(), b4.data_ptr(), x4.data_ptr(), N, m, n, stream)),
        "wrapper": enqueue_ms(lambda: cholesky.psd_solve_batched(a4, b4))}
    if hasattr(_build, "launch"):  # the package's launch helper, where it has one
        res["K6b wrapper host parts ms"]["launch_helper"] = enqueue_ms(lambda: _build.launch(
            "npt_psd_solve_batched", dev, a4.data_ptr(), b4.data_ptr(), x4.data_ptr(), N, m, n))
    for what, row in res.items():
        say(f"repository {what}: {json.dumps(row)}")

    stamps = torch.zeros(8 * 65536, dtype=torch.int64, device=dev)
    for variant in variants:
        plib = build(variant)
        for what, (a, b) in solves.items():
            x = torch.empty_like(b)
            dims = (a.shape[0], a.shape[1], b.shape[2])

            def call(plib=plib, a=a, b=b, x=x, dims=dims):
                return plib.npt_psd_solve_batched(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                                  *dims, stream)

            row = split(plib, stamps, call, PARTS["K6b"])
            row["stamped_ms"] = cuda_ms(call)
            row["max_abs_err_vs_plain"] = (x - cholesky.psd_solve_batched_reference(
                a.cpu(), b.cpu()).to(dev)).abs().max().item()
            say(f"{variant} {what}: {json.dumps(row)}")

        def call(plib=plib):
            return plib.npt_resample_systematic(parts.data_ptr(), m_t.data_ptr(), out.data_ptr(),
                                                B_PF, N_PF, 2, stream)

        row = split(plib, stamps, call, PARTS["K14"])
        row["stamped_ms"] = cuda_ms(call)
        row["equal_to_plain"] = torch.equal(
            out, pf_resample.resample_systematic_reference(parts, m_t))
        say(f"{variant} K14 B=256 N=1024 n=2: {json.dumps(row)}")
    say(f"clocks after: {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
