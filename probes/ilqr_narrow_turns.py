#!/usr/bin/env python3
"""The narrow K7 (csrc/ilqr_backward.cu's thread and lane-row forms) of a
checkout, timed on the card and its results hashed, so that two checkouts
can be run in turns in one call (parent, change, change, parent).

    python probes/ilqr_narrow_turns.py ROOT     (ROOT: a checkout's root)

Imports numpower_tpu_torch and chip_smoke from ROOT, builds ROOT's kernel
library (into ROOT/build/numpower_tpu_torch/), and prints, for each shape,
K7's own duration from torch.profiler (50 launches, chip_smoke.profiled_us)
and a SHA-256 of its ks and Ks bytes, which two checkouts whose K7 computes
the same bits print alike. Shapes: chip_smoke.py phase 9's first backward
pass of BASELINE config #3b (the cartpole, x0 = 0.3 N(0, 1) of seed 3,
T = 50, zero nominal controls, FD linearization) at N = 256 and 4096, and
the lane-row buckets (12, 4) and (16, 8) on a random LTV problem
(random_ltv, chip_smoke.random_ltv's, N = 4096, T = 30), with and without luu_diags.
Each line carries ROOT's name, the card's name and its power limit.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import _build, ilqr_backward  # noqa: E402
from numpower_tpu_torch.models import (  # noqa: E402
    cartpole_step, linearize_trajectory, rollout_nonlinear,
)


def config_3b(N: int, dev):
    """K7's operands at config #3b's first backward pass (bench.py:408-433)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    Q, R = f32(np.diag([1.0, 10.0, 0.1, 0.1])), f32(np.eye(1) * 0.01)
    QF = f32(np.diag([10.0, 100.0, 1.0, 1.0]))
    x0s = f32(np.random.default_rng(3).standard_normal((N, 4)) * 0.3)
    us = torch.zeros((N, cs.T_ILQR, 1), device=dev)
    xs = rollout_nonlinear(cartpole_step, x0s, us)
    As, Bs = linearize_trajectory(cartpole_step, xs, us, use_fd=True)
    return (As, Bs, 2.0 * xs[:, :cs.T_ILQR] @ Q.T, 2.0 * us @ R.T, 2.0 * Q, 2.0 * R,
            2.0 * xs[:, cs.T_ILQR] @ QF.T, 2.0 * QF)


def digest(*ts: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    if not torch.cuda.is_available():
        print("ilqr_narrow_turns: needs a CUDA device", file=sys.stderr)
        return 1
    assert Path(cs.__file__).resolve().parent == ROOT, cs.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.library()
    dev = torch.device("cuda", 0)
    cases = {f"config #3b N={N}": (config_3b(N, dev), None) for N in (cs.N_ILQR, cs.N)}
    for n, m in ((12, 4), (16, 8)):
        ops, diags = random_ltv(cs.N, cs.T, n, m, dev, seed=n + m)
        cases[f"({n}, {m}) N={cs.N} T={cs.T}"] = (ops, None)
        cases[f"({n}, {m}) N={cs.N} T={cs.T} luu_diags"] = (ops, diags)
    for what, (ops, diags) in cases.items():
        def call(ops=ops, diags=diags):
            return ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3, luu_diags=diags)

        own = cs.profiled_us(call, ["backward_"], 50)["backward_"]
        ks, Ks = call()
        print(f"{ROOT.name} K7 {what}: own {cs.fmt_us(own)}, ks/Ks sha256 {digest(ks, Ks)} "
              f"[{smi}]", flush=True)
    return 0


def random_ltv(N: int, T: int, n: int, m: int, dev, seed: int):
    """chip_smoke.random_ltv's problem, here so that a checkout whose
    chip_smoke.py predates it runs the same inputs."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    return ((f32(np.eye(n) + 0.05 * rng.standard_normal((N, T, n, n))),
             f32(0.3 * rng.standard_normal((N, T, n, m))), f32(rng.standard_normal((N, T, n))),
             f32(rng.standard_normal((N, T, m))), f32(2.0 * np.eye(n)), f32(0.2 * np.eye(m)),
             f32(rng.standard_normal((N, n))), f32(10.0 * np.eye(n))),
            f32(rng.uniform(0.0, 2.0, (N, T, m))))


if __name__ == "__main__":
    sys.exit(main())
