#!/usr/bin/env python3
"""The box-QP kernels' own durations on the card: config #4's (the narrow
tile) and the wide tile's parts.

    python probes/boxqp_wide.py narrow     (from the repository root)
    python probes/boxqp_wide.py wide

``narrow``: BASELINE config #4 (quadrotor12(0.02), T = 30, d = 120,
N = 4096, box +-1, x0 = 0.3 N(0, 1) of seed 0, x_ref 0.2 N(0, 1) of seed 5):
the own durations (torch.profiler's CUDA activity, chip_smoke.profiled_us,
50 calls) of K2 fista_mpc_res and K1 admm_mpc_res (40 iterations, the
default schedules) and K3b fista_boxqp (on the x_ref's g), and of K2, K1
and K3b in the replayed ticks of MPCController (30 iterations), the runs
chip_smoke.py phase 25 reads. It imports only what the parent tree of the
wide tile has too, so that a copy of this file run from the parent's
checkout times the parent's kernels in the same call (in turns: parent,
change, change, parent).

``wide``: K2 at d = 132, 400 and 1024 (the quadrotor at T = 33, 100, 256),
N = 4096, cold: its own duration at 0 iterations and at 40 all-coarse (one
bf16 pass a product, the hi part of H read), all-tail "bf16x3" (3 passes, 2
parts read) and "highest" (6 passes, 3 parts read), whence the fixed cost
and the time per iteration of each: an iteration bound by the bytes of H it
streams from L2 scales 1 : 2 : 3 over the three, one bound by the tensor
cores' passes 1 : 3 : 6. Also the L2 bytes an iteration streams (every
cluster reads its blocks' panels of H's parts once an iteration) over its
time. All results go to stdout with the card's name and power limit from
nvidia-smi.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import profiled_us  # noqa: E402
from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista  # noqa: E402
from numpower_tpu_torch.models import (  # noqa: E402
    MPCController, condense, gradient_offset, quadrotor12,
)
from numpower_tpu_torch.models.condensed import (  # noqa: E402
    admm_coarse_iters, default_coarse_iters,
)

N, LO, HI, ITERS = 4096, -1.0, 1.0, 40


def _setup(T, dev):
    A, B = quadrotor12(0.02)
    costs = (np.eye(12, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
             np.eye(12, dtype=np.float32) * 5.0)
    qp = condense(A, B, *costs, T, device=dev)
    x0s = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((N, 12)),
                          dtype=torch.float32, device=dev)
    x_ref = torch.as_tensor(0.2 * np.random.default_rng(5).standard_normal(12),
                            dtype=torch.float32, device=dev)
    return A, B, costs, qp, x0s, x_ref


def _own(fn, kernel, calls=50):
    us, n = profiled_us(fn, [kernel], calls)[kernel]
    return "not measured" if us is None else f"{us:.2f} us ({n} launches)"


def narrow(dev):
    A, B, costs, qp, x0s, x_ref = _setup(30, dev)
    fold, lip = (qp.H, qp.Sx.T, qp.SuTQ.T), qp.lipschitz
    rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    ci_f, ci_a = default_coarse_iters(qp, ITERS), admm_coarse_iters(qp, ITERS)
    g = gradient_offset(qp, x0s, x_ref).contiguous()
    print(f"narrow d = 120, N = {N}, 40 iterations: K2 own "
          + _own(lambda: boxqp_fista.fista_mpc_res(*fold, x0s, LO, HI, lip, ITERS, ci_f),
                 "fista_kernel")
          + "; K1 own "
          + _own(lambda: boxqp_admm.admm_mpc_res(*fold, x0s, LO, HI, rho, ITERS, ci_a,
                                                 Minv=Minv), "admm_kernel")
          + "; K3b own "
          + _own(lambda: boxqp_fista.fista_boxqp(qp.H, g, LO, HI, lip, ITERS, ci_f),
                 "fista_kernel"), flush=True)
    for case, kw, kernel in (("K2 fista", {"solver": "fista"}, "fista_kernel"),
                             ("K1 admm", {"solver": "admm"}, "admm_kernel"),
                             ("K3b x_ref", {"x_ref": x_ref}, "fista_kernel")):
        ctrl = MPCController(A, B, *costs, 30, LO, HI, iters=30, device=dev, **kw)
        state = [ctrl.init(N)]
        _, state[0] = ctrl.step(state[0], x0s)  # the eager tick and the capture

        def tick(ctrl=ctrl, state=state):
            _, state[0] = ctrl.step(state[0], x0s)

        print(f"narrow replayed tick {case} (30 iterations): own {_own(tick, kernel)}",
              flush=True)


def wide(dev):
    for T in (33, 100, 256):
        _, _, _, qp, x0s, _ = _setup(T, dev)
        d = qp.H.shape[0]
        fold, lip = (qp.H, qp.Sx.T, qp.SuTQ.T), qp.lipschitz
        folds = boxqp_fista._fista_folds(*fold)  # the split operand formed once

        def k2(iters, coarse, tail):
            us, _ = profiled_us(lambda: boxqp_fista._fista_mpc_res(
                *fold, x0s, LO, HI, lip, iters, coarse, None, tail, "highest", folds),
                ["fista_kernel"], 20)["fista_kernel"]
            return us

        fixed = k2(0, 0, "highest")
        rows = {"coarse (1 pass, 1 part)": (k2(ITERS, ITERS, "highest"), 1),
                "bf16x3 (3 passes, 2 parts)": (k2(ITERS, 0, "bf16x3"), 2),
                "highest (6 passes, 3 parts)": (k2(ITERS, 0, "highest"), 3)}
        b = -(-d // 128)
        clusters = -(-N // 32)
        slabs = -(-d // 64)
        line = []
        for what, (us, parts) in rows.items():
            per_it = (us - fixed) / ITERS
            # each cluster streams its b blocks' panels: b x slabs x 16 KB a part
            l2_bytes = clusters * b * slabs * parts * 16384
            line.append(f"{what} {us:.1f} us, {per_it:.2f} us an iteration, "
                        f"{l2_bytes / (per_it * 1e-6) / 1e12:.2f} TB/s of H's parts from L2")
        print(f"wide K2 d = {d} (T = {T}, {b} blocks a cluster, {slabs} slabs, N = {N}, "
              f"cold): 0 iterations {fixed:.1f} us; " + "; ".join(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{ROOT.name}: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    for mode in sys.argv[1:] or ["narrow"]:
        {"narrow": narrow, "wide": wide}[mode](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
