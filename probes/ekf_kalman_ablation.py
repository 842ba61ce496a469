#!/usr/bin/env python3
"""What the parts of the fused batched EKF (K11) and the batched Kalman mean
pass (K9) cost on the card, by ablation: csrc/ekf.cu and csrc/kalman_mean.cu
are built again with one part changed at a time and timed beside the
unchanged kernel.

    python probes/ekf_kalman_ablation.py [ekf] [kalman_mean]     (from the repository root)

(both kernels' variants when none is named).

Variants, each a text substitution into a copy of the kernel's source or of
a header it includes, built by nvcc into build/probes/ekf_kalman_ablation/
<name>/ (one nvcc each, side by side):
- K11 ``kernel``: csrc/ekf.cu as it is; ``no_stores``: the step's four
  output stores taken out; ``unroll2``: the step loop unrolled by two, so
  that one step's tail (stores, log-density) may overlap the next step's
  plant; ``fast_sincos``: sinf and cosf of the plants replaced by __sinf and
  __cosf, for the share of the accurate ones in the step;
- K9 ``kernel``: csrc/kalman_mean.cu as it is; ``rolled``: a whole chunk's
  steps run by the rolled loop, not unrolled; ``no_stores``: the step's
  stores taken out; ``no_sync_end``: the warp barrier at a chunk's end taken
  out (a race on the buffer, for its time only); ``no_restage``: chunks
  past the second not staged (their inputs stale, for the staging's time);
  ``no_record_copies``, ``no_row_copies``: the copies of the gains'
  records, or of the y rows, taken out of every chunk's staging;
  ``no_stores_no_restage``: two of those ablations at once; ``chunk8``,
  ``chunk32``: chunks of at most 8 or 32 steps instead of 16.
Each is timed by its own duration on the card (torch.profiler, mean of 30
launches of a direct library call): K11 on the pendulum, the unicycle and
the planar quadrotor at the estimation bench's shape (B = 1024, T = 50; the
inputs of chip_smoke.py phase 11), K9 at N = 4096, T = 50, n = 2, p = 1
without and with inputs (phase 13's operands), twice in turns. The ablated
variants that leave outputs unwritten or wrong show it in their max|dx|
against the plain version. Results go to stdout with the card's name and
power limit.
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
from chol_ukf import ukf_errors, ukf_problems  # noqa: E402
from ekf_kalman import ekf_direct_args, kf_errors, kf_problems  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402

CSRC = ROOT / "numpower_tpu_torch" / "csrc"
HEADERS = ("plants.cuh", "async_copy.cuh")
EKF_STORES = ("      async_copy::store_spread<G>(a.xf + row * n, x, k);\n"
              "      async_copy::store_spread<G>(a.xp + row * n, xpv, k);\n"
              "      async_copy::store_spread<G>(a.Pf + row * n * n, pf, k);\n"
              "      async_copy::store_spread<G>(a.Pp + row * n * n, pp, k);\n")
EKF_LOOP = "    for (int tc = 0; tc < steps; ++tc) {"
PLANTS = '#include "plants.cuh"'
KF_STORES = ("          xf[row + min(j, n - 1)] = x[j];\n"
             "          xp[row + min(j, n - 1)] = xpv[j];\n")
KF_SYNC_END = "      __syncwarp();  // the chunk's buffer read by every lane\n"
KF_RESTAGE = ("    stage_chunk(c + 2);\n", "    if (c < 0) stage_chunk(c + 2);\n")
KF_RECORD_COPIES = "        copy_or_zero(buf + z, valid ? src : cst, valid);\n"
KF_ROW_COPIES = ("#pragma unroll\n"
                 "        for (int r = 0; r < PB; ++r)\n"
                 "          copy_or_zero(buf + Lo::oY + (tt * kWarp + lane) * PB + r, "
                 "ys + row * p + min(r, p - 1),\n"
                 "                       r < p);\n")
VARIANTS = {
    "ekf.cu": {
        "kernel": [],
        "no_stores": [(EKF_STORES, "")],
        "unroll2": [(EKF_LOOP, "#pragma unroll 2\n" + EKF_LOOP)],
        "fast_sincos": [(PLANTS,
                         "#define sinf(x) __sinf(x)\n#define cosf(x) __cosf(x)\n" + PLANTS)],
    },
    "kalman_mean.cu": {
        "kernel": [],
        "rolled": [("      if (steps == kC) {", "      if (false) {")],
        "no_stores": [(KF_STORES, "")],
        "no_sync_end": [(KF_SYNC_END, "")],
        "no_restage": [KF_RESTAGE],
        "no_record_copies": [(KF_RECORD_COPIES, "")],
        "no_row_copies": [(KF_ROW_COPIES, "")],
        "no_stores_no_restage": [(KF_STORES, ""), KF_RESTAGE],
        "chunk8": [("    int C = 16;\n", "    int C = 8;\n")],
        "chunk32": [("    int C = 16;\n", "    int C = 32;\n")],
    },
}
KERNEL = {"ekf.cu": ("npt_ekf", "ekf_kernel"),
          "kalman_mean.cu": ("npt_kalman_mean", "kalman_mean_kernel")}


def say(msg: str) -> None:
    print(f"[ekf_kalman_ablation] {msg}", flush=True)


def build_all(sources) -> dict:
    out = ROOT / "build" / "probes" / "ekf_kalman_ablation"
    procs = {}
    for source in sources:
        variants = VARIANTS[source]
        for name, subs in variants.items():
            texts = {f: (CSRC / f).read_text() for f in (source, *HEADERS)}
            for old, new in subs:
                holders = [f for f, text in texts.items() if text.count(old) == 1]
                if len(holders) != 1:
                    raise RuntimeError(f"{source} {name}: the text to replace is not in one "
                                       "source once")
                texts[holders[0]] = texts[holders[0]].replace(old, new)
            d = out / f"{Path(source).stem}_{name}"
            d.mkdir(parents=True, exist_ok=True)
            for f, text in texts.items():
                (d / f).write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                   str(d / source)]
            procs[(source, name)] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (source, name), (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        for entry, line in ptxas_lines(log):
            if any(k in entry for k in ("ekf_kernel<1, 0, 1>", "ekf_kernel<3, 0, 3>",
                                        "kalman_mean_kernel<2, 1>")):
                say(f"{source} {name} ptxas {entry}: {line}")
        fn_name = KERNEL[source][0]
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = getattr(lib, fn_name)
        fn.argtypes = _build._SIGNATURES[fn_name]
        fn.restype = ctypes.c_int
        libs[(source, name)] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ekf_kalman_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.kernels import ekf, kalman_mean

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    sources = [f"{name}.cu" for name in sys.argv[1:]] or list(VARIANTS)
    fns = build_all(sources)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # (source, case, direct args, outputs, the plain version's, the operands the
    # direct call's pointers name)
    cases = []
    for plant, (f, h, args) in ukf_problems(dev).items():
        dargs, keep = ekf_direct_args(f, h, args)
        cases.append(("ekf.cu", plant, dargs, keep[1], ekf.ekf_reference(f, h, *args), keep))
    for name, (wargs, dargs, outs, keep) in kf_problems(dev).items():
        if name.startswith("N=4096"):
            cases.append(("kalman_mean.cu", name, dargs, outs,
                          kalman_mean.kalman_mean_pass_reference(*wargs), keep))
    for source, case, dargs, outs, want, _ in cases:
        if source not in sources:
            continue
        errors = ukf_errors if source == "ekf.cu" else kf_errors
        for turn in range(2):
            for (src, name), fn in fns.items():
                if src != source:
                    continue
                for out in outs:
                    out.zero_()
                own = profiled_us(lambda fn=fn, dargs=dargs: fn(*dargs, stream),
                                  [KERNEL[source][1]], 30)[KERNEL[source][1]]
                torch.cuda.synchronize()
                say(json.dumps({"kernel": source, "case": case, "turn": turn, "variant": name,
                                "own_us": own[0], "launches": own[1],
                                "max_abs_dx_vs_plain": errors(outs, want)["max_abs_dx"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
