#!/usr/bin/env python3
"""The box-QP kernels that form g (or c) from x0 (K2, K1, K2', K1') of a
checkout, their results hashed and their own times taken on the card, so
that two checkouts can be run in turns in one call (parent, change, change,
parent).

    python probes/boxqp_fold_turns.py ROOT     (ROOT: a checkout's root)

Imports numpower_tpu_torch and chip_smoke from ROOT (to run a parent, unpack
it with git archive into an ignored directory and copy this checkout's
chip_smoke.py over its own), builds ROOT's kernel library (into
ROOT/build/numpower_tpu_torch/), and prints, for each case of
chip_smoke.fold_checksums (n = 12 at d = 120 and 400, N = 4096, the default
schedules), the SHA-256 prefix of its outputs, which two checkouts whose
kernels compute the same bits print alike, and the kernel's own duration
from torch.profiler (20 launches, chip_smoke.profiled_us). Then each kernel
at the four-quadrotor formation (chip_smoke.formation_mpc, n = 48, T = 20
and 30): its own duration, or the error it raises. Each line carries ROOT's
name and the card's name and power limit.
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
from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista  # noqa: E402
from numpower_tpu_torch.models import condense  # noqa: E402
from numpower_tpu_torch.models.condensed import (  # noqa: E402
    admm_coarse_iters, default_coarse_iters,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("boxqp_fold_turns: needs a CUDA device", file=sys.stderr)
        return 1
    assert Path(cs.__file__).resolve().parent == ROOT, cs.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.library()
    dev = torch.device("cuda", 0)
    for case, (digest, call) in cs.fold_checksums(dev).items():
        kernel = "fista_kernel" if case.startswith("K2") else "admm_kernel"
        own = cs.profiled_us(call, [kernel], 20)[kernel]
        print(f"{ROOT.name} {case}: sha256 {digest}, own {cs.fmt_us(own)} [{smi}]", flush=True)
    A, B, Q, R, QF = cs.formation_mpc(cs.N_FORMATION)
    x0s = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((cs.N, A.shape[0])),
                          dtype=torch.float32, device=dev)
    for T in cs.T_FORM_MPC:
        qp = condense(A, B, Q, R, QF, T, device=dev)
        rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
        fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, cs.LO, cs.HI)
        ci_f, ci_a = default_coarse_iters(qp, 40), admm_coarse_iters(qp, 40)
        calls = {"K2": lambda: boxqp_fista.fista_mpc_res(*fold, qp.lipschitz, 40, ci_f),
                 "K1": lambda: boxqp_admm.admm_mpc_res(*fold, rho, 40, ci_a),
                 "K2'": lambda: boxqp_fista.fista_mpc(*fold, qp.lipschitz, 40, ci_f),
                 "K1'": lambda: boxqp_admm.admm_mpc(*fold, rho, 40, ci_a)}
        for name, call in calls.items():
            kernel = "fista_kernel" if name.startswith("K2") else "admm_kernel"
            try:
                own = cs.fmt_us(cs.profiled_us(call, [kernel], 10)[kernel])
            except (ValueError, RuntimeError) as e:
                own = f"raises {type(e).__name__}: {e}"
            print(f"{ROOT.name} {name} formation n = {A.shape[0]} d = {qp.H.shape[0]} "
                  f"N = {cs.N}: own {own} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
