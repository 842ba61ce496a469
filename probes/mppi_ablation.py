#!/usr/bin/env python3
"""What each part of the fused MPPI kernel (K13) costs on the card, by
ablation: csrc/mppi.cu is built again with one part taken out at a time and
timed beside the unchanged kernel.

    python probes/mppi_ablation.py        (from the repository root, on the GPU machine)

Variants, each a text substitution into a copy of csrc/mppi.cu built by nvcc
into build/probes/ablation/<name>/ (one nvcc each, side by side):
- ``kernel``: the source as it is;
- ``no_update``: the nominal update's sums skipped (the loop runs no entry);
- ``no_stage_wait``: the rollout's wait for its staged chunk dropped (it may
  read a chunk before it lands);
- ``no_sinf``: sinf(x) replaced by x in the plants (the pendulum's step).
Each is a direct library call at the MPPI bench's shape (pendulum, N = K =
256, T = 40, 8 rounds) and at N = 4096, CUDA events, median of 5 windows of
5 calls; also the unchanged kernel with two and four samples a thread at
K = 256 (128 and 64 threads a block). The ablated variants compute wrong
results: only their times are read; max|dus| against the unchanged kernel
is printed to show which ones changed the arithmetic. Results go to stdout
with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, ptxas_lines  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "numpower_tpu_torch" / "csrc"
UPDATE = "      for (int eb = e_lo + warp; eb < e_hi; eb += kE * nw) {"
WAIT = "      __pipeline_wait_prior(2);\n      __syncwarp();  // this warp's runs"
PLANTS = '#include "plants.cuh"'
VARIANTS = {
    "kernel": [],
    "no_update": [(UPDATE, UPDATE.replace("int eb = e_lo + warp", "int eb = e_hi"))],
    "no_stage_wait": [(WAIT, "      __syncwarp();  // this warp's runs")],
    "no_sinf": [(PLANTS, "#define sinf(x) (x)\n" + PLANTS)],
}


def say(msg: str) -> None:
    print(f"[ablation] {msg}", flush=True)


def build_all() -> dict:
    src = (CSRC / "mppi.cu").read_text()
    out = ROOT / "build" / "probes" / "ablation"
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in csrc/mppi.cu once")
            text = text.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "mppi.cu").write_text(text)
        shutil.copy(CSRC / "plants.cuh", d / "plants.cuh")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "mppi.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for entry, line in ptxas_lines(log):
            if "mppi_kernel<1, 1>" in entry:
                say(f"{name} ptxas {entry}: {line}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.npt_mppi.argtypes = _build._SIGNATURES["npt_mppi"]
        lib.npt_mppi.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablation: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import mppi
    from numpower_tpu_torch.models import pendulum_step, quadratic_mppi_cost

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    libs = build_all()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cost = quadratic_mppi_cost(np.diag([1.0, 0.1]), np.eye(1) * 0.01, np.diag([100.0, 10.0]),
                               np.zeros(2))
    x0s = torch.as_tensor(np.random.default_rng(8).uniform(-np.pi, np.pi, (256, 2)),
                          dtype=torch.float32, device=dev)
    us0 = torch.zeros(40, device=dev)
    for N in (256, 4096):
        x = x0s.repeat(N // 256, 1).contiguous()
        eps = mppi.eps_direct_layout(torch.Generator(device=dev).manual_seed(1), N, 8, 40, 1, 256,
                                     1.0)
        args, held = mppi.kernel_args(pendulum_step, cost, x, eps, us0, T=40, iters=8, m=1,
                                      sigma=1.0, lam=1.0)
        plans = {name: [(256, 1)] for name in libs}
        plans["kernel"] += [(128, 2), (64, 4)]
        ref = None
        for name, lib in libs.items():
            for threads, spt in plans[name]:
                call_args = list(args[:-4]) + [threads, spt] + list(args[-2:])
                code = lib.npt_mppi(*call_args, stream)
                if code != 0:
                    raise RuntimeError(f"{name} ({threads}, {spt}): CUDA error {code}")
                torch.cuda.synchronize()
                us = held[-2].clone()
                ref = us if ref is None else ref
                ms = cuda_ms(lambda: lib.npt_mppi(*call_args, stream), reps=5, inner=5, warmup=2)
                say(json.dumps({"N": N, "variant": name, "threads": threads, "samples_a_thread": spt,
                                "ms": ms, "max_abs_dus_vs_kernel": (us - ref).abs().max().item()}))
        del eps, held
    return 0


if __name__ == "__main__":
    sys.exit(main())
