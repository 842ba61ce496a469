#!/usr/bin/env python3
"""The narrow K5, K6b and K6a (csrc/riccati.cu, cholesky.cu) of a checkout,
timed on the card at chip_smoke.py phase 7's shapes, so that two checkouts
can be run in turns in one call (parent, change, change, parent).

    python probes/riccati_narrow_turns.py ROOT     (ROOT: a checkout's root)

Imports numpower_tpu_torch and chip_smoke from ROOT, builds ROOT's kernel
library (into ROOT/build/numpower_tpu_torch/), and prints each kernel's own
duration from torch.profiler (50 launches, chip_smoke.profiled_us): K5 on
config #4's per-scenario recipe (bench.py:345-355; N = 4096, T = 30), K6b at
(4096, 4, 4) x (4096, 4, 12), K6a at (4096, 12, 12); then a checksum of K5's
Ks and P0 (their float64 sums), which two checkouts whose K5 computes the
same bits print alike. Each line carries ROOT, the card's name and its power
limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import _build, cholesky, riccati  # noqa: E402
from numpower_tpu_torch.models import quadrotor12  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("riccati_narrow_turns: needs a CUDA device", file=sys.stderr)
        return 1
    assert Path(cs.__file__).resolve().parent == ROOT, cs.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.library()
    dev = torch.device("cuda", 0)
    A, B = quadrotor12(0.02)
    n, m, N, T = 12, 4, 4096, 30
    rng = np.random.default_rng(4)
    As = torch.as_tensor(np.tile(A, (N, 1, 1))
                         + 0.01 * rng.standard_normal((N, n, n)).astype(np.float32), device=dev)
    Bs = torch.as_tensor(B, device=dev).expand(N, n, m)
    costs = [torch.as_tensor(x, device=dev) for x in (
        np.eye(n, dtype=np.float32), 0.1 * np.eye(m, dtype=np.float32),
        5.0 * np.eye(n, dtype=np.float32))]
    a4 = cs.spd_batch(N, m, 1, dev)
    b4 = torch.as_tensor(np.random.default_rng(11).standard_normal((N, m, n)),
                         dtype=torch.float32, device=dev)
    a12 = cs.spd_batch(N, n, 3, dev)
    for what, fn, kernel in (
            ("K5", lambda: riccati.riccati_batched_fused(As, Bs, *costs, T), "riccati_kernel"),
            ("K6b", lambda: cholesky.psd_solve_batched(a4, b4), "psd_solve_kernel"),
            ("K6a", lambda: cholesky.cholesky_batched(a12), "cholesky_kernel")):
        own = cs.profiled_us(fn, [kernel], 50)[kernel]
        print(f"{ROOT.name} {what} own {cs.fmt_us(own)} [{smi}]", flush=True)
    Ks, P0 = riccati.riccati_batched_fused(As, Bs, *costs, T)
    print(f"{ROOT.name} K5 checksum Ks {Ks.double().sum().item():.10e} "
          f"P0 {P0.double().sum().item():.10e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
