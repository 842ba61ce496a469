#!/usr/bin/env python3
"""Where the batched RTS mean pass (K10) spends its time on the card, and
what its own duration is.

    python probes/rts_mean.py [before] [current] [ablate]     (from the repository root)

First, for the repository's own library (built by
numpower_tpu_torch.kernels._build, no stamps): the kernel's mean duration
from torch.profiler (CUDA activity, 50 launches) beside its wrapper's
CUDA-event time, a direct library call's CUDA-event time and the wrapper's
host enqueue, at the estimation bench's shape (N = 4096, T = 50, n = 2: the
operands of chip_smoke.py phase 13, the bench's double integrator filtered
by kalman_filter_batched), at N = 1003 (the same operands' first 1003
trajectories) and at N = 4096, T = 50, n = 4, 8 and 16 (random gains of
spectral radius about 0.5, random e_t and x_last, seed 3);
kalman_smoother_batched at the bench's shape; and the ptxas lines
(registers, spills) of every rts_mean:: instance.

Then, for each variant named, a library with cycle stamps built by nvcc
into build/probes/: ``before`` from probes/rts_mean_before.cu (the kernel
before its redesign) and ``current`` from probes/rts_mean.cu (today's
csrc/rts_mean.cu, whose stamp macros probes/stamps.cuh fills in). Each
stamped kernel adds the clock64() cycles of its parts to a register per
part and writes them out per thread; the probe prints the mean over the
threads and the slowest thread, the CUDA-event time of the stamped kernel
and its result against the plain version.

``ablate`` builds csrc/rts_mean.cu again with one part changed at a time
(ABLATIONS: text substitutions into a copy, one nvcc each, side by side,
into build/probes/rts_mean_ablation/) and times each variant's own duration
(torch.profiler, mean of 30 launches of a direct library call) beside the
unchanged kernel, in two turns, at every case above, with its max|dx|
against the plain version: ``rolled`` every chunk's steps by the rolled
loop; ``whole_chunks`` a whole chunk unrolled at every bucket;
``no_restage`` chunks past the second not staged, ``no_gain_copies`` and
``no_row_copies`` (the 8-byte ones) without those copies (their results
stale or wrong, for the staging's time only); ``no_pairs`` n = 2 by 4-byte
row copies and stores; ``ldg_rows`` each lane's e_t rows read by __ldg a
chunk ahead into registers, no shared memory for them; ``gains_unrolled``
the gains' copies fully unrolled; ``chunk8``, ``chunk32`` chunks of at most
8 or 32 steps. All results go to stdout, with the card's name, power limit
and SM clock from nvidia-smi.
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

from chip_smoke import cuda_ms, enqueue_ms, fmt_us, profiled_us, ptxas_lines  # noqa: E402
from chol_ukf import split  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402

SOURCES = {"before": ROOT / "probes" / "rts_mean_before.cu",
           "current": ROOT / "probes" / "rts_mean.cu"}
PARTS = {"before": ["x_last + first store", "gains staging", "e_t staging + wait", "chain",
                    "stores"],
         "current": ["chunks 0-1 copies + x_last + store", "staging copies", "staging wait",
                     "steps (chain + stores)"]}
N_KF, N_RAGGED, T_KF = 4096, 1003, 50
CSRC = ROOT / "numpower_tpu_torch" / "csrc"
# csrc/rts_mean.cu with one part changed: (old text, new text), each old text
# in the source once
LDG_LOADS = """  store(T - 1, x);
  // ldg_rows: each lane's e_t rows read from global memory into registers a
  // chunk ahead, no shared memory for them
  auto load_rows = [&](int top, float (&e)[kC * NB]) {
#pragma unroll
    for (int tt = 0; tt < kC; ++tt) {
      const size_t row = static_cast<size_t>(max(top - tt, 0)) * N + s;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        e[tt * NB + j] = j < n ? __ldg(es + row * n + min(j, n - 1)) : 0.0f;
    }
  };
  float ecur[kC * NB];
  load_rows(T - 2, ecur);
"""
ABLATIONS = {
    "kernel": [],
    "rolled": [("    if (Lo::kWholeChunks && steps == kC) {", "    if (false) {")],
    "whole_chunks": [("static constexpr bool kWholeChunks = NB <= 2;",
                      "static constexpr bool kWholeChunks = true;")],
    "no_restage": [("    stage_chunk(c + 2);\n", "    __pipeline_commit();\n")],
    "no_gain_copies": [("        copy_or_zero(buf + z, src, valid);\n", "")],
    "no_row_copies": [("          __pipeline_memcpy_async(rows + tt * kWarp * NB, es + row * 2, "
                       "2 * sizeof(float));\n", "")],
    "no_pairs": [("  if (n == 2 && aligned8(es) && aligned8(x_last) && aligned8(xs))\n",
                  "  if (false)\n")],
    "ldg_rows": [("      for (int tt = 0; tt < kC; ++tt) {\n        const size_t row",
                  "      for (int tt = 0; tt < 0; ++tt) {\n        const size_t row"),
                 ("  store(T - 1, x);\n", LDG_LOADS),
                 ("    NPT_STAMP(2);\n", "    NPT_STAMP(2);\n    float enx[kC * NB];\n"
                  "    load_rows(hi - kC, enx);\n"),
                 ("      const float* const ev = buf + Lo::oE + (tt * kWarp + lane) * NB;\n",
                  "      const float* const ev = ecur + tt * NB;\n"),
                 ("    NPT_STAMP(3);\n", "    NPT_STAMP(3);\n#pragma unroll\n"
                  "    for (int q = 0; q < kC * NB; ++q) ecur[q] = enx[q];\n")],
    "gains_unrolled": [("#pragma unroll (Lo::kCopyUnroll)\n      for (int q = 0;",
                        "#pragma unroll\n      for (int q = 0;")],
    "chunk8": [("    int C = 16;\n", "    int C = 8;\n")],
    "chunk32": [("    int C = 16;\n", "    int C = 32;\n")],
}


def say(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def library(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.npt_rts_mean.argtypes = _build._SIGNATURES["npt_rts_mean"]
    lib.npt_rts_mean.restype = ctypes.c_int
    return lib


def build(variant: str) -> tuple:
    src = SOURCES[variant]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, CSRC / "rts_mean.cu",
                                                               ROOT / "probes" / "stamps.cuh"]))
    out = ROOT / "build" / "probes" / f"lib{variant}_rts_{digest.hexdigest()[:12]}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        for entry, line in ptxas_lines(log):
            say(f"{variant} ptxas {entry}: {line}")
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    lib = library(out)
    lib.probe_set_stamps.argtypes = (ctypes.c_void_p,)
    lib.probe_set_stamps.restype = ctypes.c_int
    return lib


def build_ablations() -> dict:
    """{variant: its library}, each built from a copy of csrc/rts_mean.cu with
    the variant's substitutions, all nvcc's side by side."""
    out = ROOT / "build" / "probes" / "rts_mean_ablation"
    procs = {}
    for name, subs in ABLATIONS.items():
        text = (CSRC / "rts_mean.cu").read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: the text to replace is not in the source "
                                   "once")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "rts_mean.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "rts_mean.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        for entry, line in ptxas_lines(log):
            say(f"ablation {name} ptxas {entry}: {line}")
        libs[name] = library(d / "lib.so")
    return libs


def bench_operands(dev):
    """chip_smoke.py phase 13's K10 operands: the estimation bench's double
    integrator (N = 4096, T = 50, C = [1 0], seed 11) filtered by
    kalman_filter_batched, its gains G_t' and affine terms e_t formed as
    kalman_smoother_batched forms them."""
    from numpower_tpu_torch.models import double_integrator, kalman_filter_batched
    from numpower_tpu_torch.models.estimation import _chol, _chosolve, shared_gains

    t32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    A = t32(double_integrator(0.1).A)
    C, Q, R, P0 = t32([[1.0, 0.0]]), t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2), \
        t32(np.eye(2) * 0.1)
    rng = np.random.default_rng(11)
    yss = t32(rng.standard_normal((N_KF, T_KF, 1)))
    x0s = t32(rng.standard_normal((N_KF, 2)))
    filt = kalman_filter_batched(A, C, Q, R, x0s, P0, yss)
    _, _, P_fs, _, _ = shared_gains(A, C, Q, R, P0, T_KF)
    P_ps = filt.pred_covs[0]
    G_Ts = _chosolve(_chol(P_ps[1:]), A @ P_fs[:-1]).contiguous()
    xs_f_t, xs_p_t = filt.means.transpose(0, 1), filt.pred_means.transpose(0, 1)
    es_t = (xs_f_t[:-1] - torch.einsum("tnj,tjk->tnk", xs_p_t[1:], G_Ts)).contiguous()
    return (A, C, Q, R, P0, filt), (G_Ts, es_t, xs_f_t[-1].contiguous())


def cases(dev) -> dict:
    """{name: (G_Ts, es_t, x_last)}."""
    _, (G, e, x) = bench_operands(dev)
    out = {f"N={N_KF} T={T_KF} n=2": (G, e, x),
           f"N={N_RAGGED} T={T_KF} n=2": (G, e[:, :N_RAGGED].contiguous(),
                                          x[:N_RAGGED].contiguous())}
    gen = torch.Generator(device=dev).manual_seed(3)
    for n in (4, 8, 16):
        G = 0.5 * torch.randn((T_KF - 1, n, n), generator=gen, device=dev) / n ** 0.5
        out[f"N={N_KF} T={T_KF} n={n}"] = (
            G, torch.randn((T_KF - 1, N_KF, n), generator=gen, device=dev),
            torch.randn((N_KF, n), generator=gen, device=dev))
    return out


def direct_call(lib, stream, G, e, x, xs):
    Tm1, N, n = e.shape
    return lambda: lib.npt_rts_mean(G.data_ptr(), e.data_ptr(), x.data_ptr(), xs.data_ptr(), N,
                                    Tm1 + 1, n, stream)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import rts_mean
    from numpower_tpu_torch.models import kalman_smoother_batched

    variants = sys.argv[1:]
    dev = torch.device("cuda", 0)
    smi_q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"]
    say(f"device {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    lib = _build.library()
    build_log = _build.library_path().with_suffix(".so.log")
    for entry, line in ptxas_lines(build_log.read_text() if build_log.is_file() else ""):
        if "rts_mean::" in entry:
            say(f"repository ptxas {entry}: {line}")
    stream = torch.cuda.current_stream(dev).cuda_stream

    problems = cases(dev)
    outs = {name: torch.empty((e.shape[0] + 1, *e.shape[1:]), device=dev)
            for name, (_, e, _) in problems.items()}
    want = {name: rts_mean.rts_mean_pass_reference(*args) for name, args in problems.items()}
    for name, args in problems.items():
        call = direct_call(lib, stream, *args, outs[name])
        row = {"profiler": fmt_us(profiled_us(lambda a=args: rts_mean.rts_mean_pass(*a),
                                              ["rts_mean_kernel"])["rts_mean_kernel"]),
               "wrapper_ms": cuda_ms(lambda a=args: rts_mean.rts_mean_pass(*a)),
               "direct_ms": cuda_ms(call),
               "enqueue_ms": enqueue_ms(lambda a=args: rts_mean.rts_mean_pass(*a)),
               "max_abs_dx": (rts_mean.rts_mean_pass(*args) - want[name]).abs().max().item()}
        say(f"repository K10 {name}: {json.dumps(row)}")
    (A, *_, filt), _ = bench_operands(dev)
    say(f"repository kalman_smoother_batched N={N_KF} T={T_KF} ms: "
        f"{cuda_ms(lambda: kalman_smoother_batched(A, filt), reps=5, inner=1, warmup=1)}")

    stamps = torch.zeros(8 * (1 << 20), dtype=torch.int64, device=dev)
    for variant in (v for v in variants if v in SOURCES):
        plib = build(variant)
        for name, args in problems.items():
            call = direct_call(plib, stream, *args, outs[name])
            row = split(plib, stamps, call, PARTS[variant])
            row["stamped_ms"] = cuda_ms(call)
            row["max_abs_dx"] = (outs[name] - want[name]).abs().max().item()
            say(f"{variant} K10 {name}: {json.dumps(row)}")
    if "ablate" in variants:
        libs = build_ablations()
        for turn in range(2):
            for name, args in problems.items():
                for variant, alib in libs.items():
                    outs[name].zero_()
                    call = direct_call(alib, stream, *args, outs[name])
                    own = profiled_us(call, ["rts_mean_kernel"], 30)["rts_mean_kernel"]
                    torch.cuda.synchronize()
                    say(json.dumps({"case": name, "turn": turn, "variant": variant,
                                    "own_us": own[0], "launches": own[1],
                                    "max_abs_dx_vs_plain":
                                        (outs[name] - want[name]).abs().max().item()}))
    say(f"clocks after: {subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
