"""Reproducibility of systematic resampling's cumulative sum on the card.

    python probes/pf_determinism.py      (needs a CUDA device)

Prints, for a single row of N float32 weights, how many distinct results
torch.cumsum gives over 200 calls on the same input (torch scans a one-row
tensor with CUB's single-pass scan) and how many the port's
models/particle._cumsum_rows gives; then how many distinct slot boundary
vectors models/particle._resample_slots gives over 50 calls, and whether
particle_filter repeats itself from one seed (65,536 particles, the PF
bench's model, T = 50). The card's name and power limit come first.
"""

import functools
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("pf_determinism: needs a CUDA device", file=sys.stderr)
        return 1
    from numpower_tpu_torch.models import first_components, particle_filter, pendulum_step
    from numpower_tpu_torch.models.particle import _cumsum_rows, _resample_slots

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    for N in (1024, 4096, 65536, 1 << 20):
        g = torch.Generator(device=dev).manual_seed(N)
        w = torch.rand(N, generator=g, device=dev)
        raw = {torch.cumsum(w, dim=-1).cpu().numpy().tobytes() for _ in range(200)}
        rows = {_cumsum_rows(w).cpu().numpy().tobytes() for _ in range(200)}
        logw = torch.log(w) * 30.0
        u0 = torch.rand((), generator=g, device=dev)
        slots = {_resample_slots(u0, logw, N).cpu().numpy().tobytes() for _ in range(50)}
        print(f"N={N}: distinct torch.cumsum results {len(raw)} of 200, _cumsum_rows "
              f"{len(rows)} of 200, _resample_slots {len(slots)} of 50")
    r = np.random.default_rng(12)
    args = (pendulum_step, functools.partial(first_components, k=1),
            torch.eye(2, device=dev) * 1e-4, torch.eye(1, device=dev) * 2.5e-3,
            torch.as_tensor(0.3 * r.standard_normal(2), dtype=torch.float32, device=dev),
            torch.eye(2, device=dev),
            torch.as_tensor(r.standard_normal((50, 1)), dtype=torch.float32, device=dev),
            torch.zeros((50, 1), device=dev))
    lls = {particle_filter(*args, torch.Generator(device=dev).manual_seed(0),
                           n_particles=65536).log_likelihood.item() for _ in range(5)}
    print(f"particle_filter N=65536 T=50, 5 runs from seed 0: distinct log-likelihoods "
          f"{sorted(lls)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
