#!/usr/bin/env python3
"""What the parts of the fused batched UKF kernel (K12) cost on the card, by
ablation: csrc/ukf.cu is built again with one part changed at a time and
timed beside the unchanged kernel.

    python probes/ukf_ablation.py        (from the repository root, on the GPU machine)

Variants, each a text substitution into a copy of csrc/ukf.cu or of a
header it includes, built by nvcc into build/probes/ukf_ablation/<name>/
(one nvcc each, side by side):
- ``kernel``: the source as it is;
- ``no_stores``: the step's four output stores taken out (xs_f, xs_p, Ps_f
  and Ps_p are left unwritten);
- ``branch_stores``: each spread store under a branch (``if (s + k < N)``),
  the lanes past the end storing nothing, instead of storing entry N - 1
  again;
- ``fast_sincos``: sinf and cosf of the plants replaced by __sinf and
  __cosf (the fast approximations), for the share of the accurate ones in
  the step's chain.
Each is timed by its own duration on the card (torch.profiler, mean of 30
launches of a direct library call) on the pendulum, the unicycle and the
planar quadrotor at the estimation bench's shape (B = 1024, T = 50; the
inputs of chip_smoke.py phase 11), twice in turns. The ablated variants
compute other results; max|dx| of each against the plain version is printed
to show which ones changed the arithmetic. Results go to stdout with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))

from chip_smoke import profiled_us, ptxas_lines  # noqa: E402
from chol_ukf import ukf_direct_args, ukf_errors, ukf_problems  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "numpower_tpu_torch" / "csrc"
STORES = ("      async_copy::store_spread<G>(a.xf + row * n, x, k);\n"
          "      async_copy::store_spread<G>(a.xp + row * n, xpv, k);\n"
          "      async_copy::store_spread<G>(a.Pf + row * n * n, pf, k);\n"
          "      async_copy::store_spread<G>(a.Pp + row * n * n, pp, k);\n")
UNIFORM_STORE = "    dst[min(s + k, N - 1)] = c[0];"
PLANTS = '#include "plants.cuh"'
VARIANTS = {
    "kernel": [],
    "no_stores": [(STORES, "")],
    "branch_stores": [(UNIFORM_STORE, "    if (s + k < N) dst[s + k] = c[0];")],
    "fast_sincos": [(PLANTS, "#define sinf(x) __sinf(x)\n#define cosf(x) __cosf(x)\n" + PLANTS)],
}


def say(msg: str) -> None:
    print(f"[ukf_ablation] {msg}", flush=True)


def build_all() -> dict:
    out = ROOT / "build" / "probes" / "ukf_ablation"
    procs = {}
    for name, subs in VARIANTS.items():
        texts = {f: (CSRC / f).read_text() for f in ("ukf.cu", "plants.cuh", "async_copy.cuh")}
        for old, new in subs:
            holders = [f for f, text in texts.items() if text.count(old) == 1]
            if len(holders) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in one source once")
            texts[holders[0]] = texts[holders[0]].replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "ukf.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for entry, line in ptxas_lines(log):
            if "ukf_kernel<1, 0, 1>" in entry or "ukf_kernel<3, 0, 3>" in entry:
                say(f"{name} ptxas {entry}: {line}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.npt_ukf.argtypes = _build._SIGNATURES["npt_ukf"]
        lib.npt_ukf.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ukf_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import ukf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    libs = build_all()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for plant, (f, h, args) in ukf_problems(dev).items():
        want = ukf.ukf_reference(f, h, *args)
        dargs, (_, outs) = ukf_direct_args(f, h, args)
        for turn in range(2):
            for name, lib in libs.items():
                own = profiled_us(lambda lib=lib: lib.npt_ukf(*dargs, stream), ["ukf_kernel"],
                                  30)["ukf_kernel"]
                torch.cuda.synchronize()
                say(json.dumps({"plant": plant, "turn": turn, "variant": name, "own_us": own[0],
                                "launches": own[1],
                                "max_abs_dx_vs_plain": ukf_errors(outs, want)["max_abs_dx"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
