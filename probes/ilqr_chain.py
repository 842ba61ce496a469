#!/usr/bin/env python3
"""Where one step of the iLQR kernels K7 (backward pass) and K8 (forward line
search) spends its cycles, on the card.

    python probes/ilqr_chain.py [before] [current]     (PYTHONPATH = the repository root)

Builds two libraries with nvcc into build/probes/: ``before`` from
probes/ilqr_chain_before.cu (the kernels before their redesign, with cycle
stamps)
and ``current`` from probes/ilqr_chain.cu (today's csrc/ilqr_backward.cu and
ilqr_forward.cu, whose stamp macros probes/ilqr_stamps.cuh fills in). Each
stamped kernel adds the clock64() cycles of every part of its step to a
register per part and writes them out per thread at its end (parts in
ilqr_chain_before.cu's and the sources' notes).

The inputs are chip_smoke.py phase 9's: the first line search of BASELINE
config #3b (the cartpole, x0 = 0.3 N(0, 1) with seed 3, T = 50, the zero
nominal controls, FD linearization, one plain backward pass), at N = 256 and
4096; K8 with the six alphas of the solve and with the three small ones
(0.1, 0.03, 0.01), which stay bounded. Prints, per kernel and run, the
cycles per step of each part (mean over the threads, and the thread with the
most cycles), the CUDA-event time of the stamped kernel and of the
repository's own library (built by numpower_tpu_torch.kernels._build, no
stamps) on the same inputs, and the SM clock from nvidia-smi, on stdout.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from numpower_tpu_torch.kernels import _build  # noqa: E402

SOURCES = {"before": ROOT / "probes" / "ilqr_chain_before.cu",
           "current": ROOT / "probes" / "ilqr_chain.cu"}
# the alpha of a K8 thread from its place in the grid: the kernel before ran
# blocks of 32 scenarios x A warps, one warp per alpha; today's runs a grid (N / 32,
# groups) of blocks of W warps, W = ceil(A / groups), groups = ceil(A / 4)


def _alpha_current(A: int, N: int):
    groups = -(-A // 4)
    W = -(-A // groups)
    per_row = -(-N // 32) * 32 * W  # threads in one row of the grid
    return lambda g: (g // per_row) * W + (g % (32 * W)) // 32


ALPHA_OF = {"before": lambda A, N: (lambda g: (g % (32 * A)) // 32), "current": _alpha_current}
PARTS = {
    "bwd": ["stage wait/issue", "W, W2", "Qu, Quu, Cholesky, k", "Qux, K", "Vx', Vxx'", "prologue",
            "-"],
    "fwd": ["chunk staging", "feedback", "stage cost", "plant", "outputs", "prologue, terminal",
            "chunk write-back"],
}


def build(variant: str) -> ctypes.CDLL:
    src = SOURCES[variant]
    csrc = sorted((ROOT / "numpower_tpu_torch" / "csrc").glob("*.cu*"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in [src, *csrc,
                                                               ROOT / "probes" / "ilqr_stamps.cuh"]))
    out = ROOT / "build" / "probes" / f"lib{variant}_{digest.hexdigest()[:12]}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[probe {variant}] ptxas {line.strip()}", flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for name in ("npt_ilqr_backward", "npt_ilqr_forward"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.probe_set_stamps.argtypes = (ctypes.c_void_p,)
    lib.probe_set_stamps.restype = ctypes.c_int
    return lib


def problem(N: int, dev):
    """Phase 9's first line search of config #3b at N scenarios."""
    from numpower_tpu_torch.kernels import ilqr_backward
    from numpower_tpu_torch.models import cartpole_step, linearize_trajectory, rollout_nonlinear

    T = 50
    t32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    Q, R = t32(np.diag([1.0, 10.0, 0.1, 0.1])), t32(np.eye(1) * 0.01)
    QF, goal = t32(np.diag([10.0, 100.0, 1.0, 1.0])), t32(np.zeros(4))
    x0s = t32(np.random.default_rng(3).standard_normal((N, 4)) * 0.3)
    us = torch.zeros((N, T, 1), dtype=torch.float32, device=dev)
    xs = rollout_nonlinear(cartpole_step, x0s, us)
    As, Bs = linearize_trajectory(cartpole_step, xs, us, use_fd=True)
    lxs = (2.0 * (xs[:, :T] - goal) @ Q.T).contiguous()
    lus = (2.0 * us @ R.T).contiguous()
    lxT = (2.0 * (xs[:, T] - goal) @ QF.T).contiguous()
    lxx, luu, lxxT = 2.0 * Q, (2.0 * R + 1e-3 * torch.eye(1, device=dev)), 2.0 * QF
    ks, Ks = ilqr_backward.ilqr_backward_reference(As, Bs, lxs, lus, 2.0 * Q, 2.0 * R, lxT,
                                                   2.0 * QF, reg=1e-3)
    bwd = [As.contiguous(), Bs.contiguous(), lxs, lus, None, lxx.contiguous(), luu.contiguous(),
           lxT, lxxT.contiguous()]
    fwd = dict(Q=Q, R=R, QF=QF, goal=goal, x0s=x0s, xs=xs.contiguous(), us=us, ks=ks, Ks=Ks)
    return T, bwd, fwd


def event_ms(fn, reps: int = 7, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def split(lib, stamps: torch.Tensor, call, T: int, kind: str, alpha_of=None) -> dict:
    """Run `call` once with the stamps on; cycles per step of each part.
    alpha_of maps a thread's place in the grid to its alpha (K8), for the
    mean plant cycles per step of each alpha."""
    stamps.zero_()
    code = lib.probe_set_stamps(stamps.data_ptr())
    assert code == 0, code
    code = call()
    assert code == 0, f"launch failed: {code}"
    torch.cuda.synchronize()
    st = stamps.view(-1, 8).cpu().double()
    idx = torch.nonzero(st[:, 7] > 0)[:, 0]
    st = st[idx]
    worst = st[st[:, 7].argmax()]
    names = PARTS[kind]
    row = {"threads": int(st.shape[0]),
           "mean_cycles_per_step": {names[p]: st[:, p].mean().item() / T for p in range(7)},
           "slowest_thread_cycles_per_step": {names[p]: worst[p].item() / T for p in range(7)},
           "total_cycles": {"mean": st[:, 7].mean().item(), "max": worst[7].item()}}
    if alpha_of is not None:
        a = alpha_of(idx)
        row["plant_cycles_per_step_by_alpha"] = [
            st[a == k, 3].mean().item() / T for k in range(int(a.max().item()) + 1)]
        row["max_total_cycles_by_alpha"] = [
            st[a == k, 7].max().item() for k in range(int(a.max().item()) + 1)]
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 1
    variants = sys.argv[1:] or ["before", "current"]
    dev = torch.device("cuda", 0)
    smi_q = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"]
    main_lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    results = {"device": subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()}
    print(f"[probe] {results['device']}", flush=True)
    probs = {N: problem(N, dev) for N in (256, 4096)}
    alpha_sets = {"six": [1.0, 0.6, 0.3, 0.1, 0.03, 0.01], "three small": [0.1, 0.03, 0.01]}
    for variant in variants:
        lib = build(variant)
        for N, (T, bwd, fwd) in probs.items():
            n, m = 4, 1
            ks = torch.empty((N, T, m), device=dev)
            Ks = torch.empty((N, T, m, n), device=dev)
            ptrs = [0 if t is None else t.data_ptr() for t in bwd]
            stamps = torch.zeros(8 * 64 * N, dtype=torch.int64, device=dev)

            def bwd_call(lib_=lib):
                return lib_.npt_ilqr_backward(*ptrs, ks.data_ptr(), Ks.data_ptr(), N, n, m, T,
                                              stream)

            row = split(lib, stamps, bwd_call, T, "bwd")
            row["stamped_ms"] = event_ms(bwd_call)
            row["repo_library_ms"] = event_ms(lambda: main_lib.npt_ilqr_backward(
                *ptrs, ks.data_ptr(), Ks.data_ptr(), N, n, m, T, stream))
            results[f"{variant} K7 N={N}"] = row
            print(f"[probe] {variant} K7 N={N}: {json.dumps(row)}", flush=True)

            for set_name, alist in alpha_sets.items():
                if N != 256 and set_name != "six":
                    continue
                alphas = torch.tensor(alist, device=dev)
                A = len(alist)
                us = torch.empty((A, N, T, m), device=dev)
                xs = torch.empty((A, N, T + 1, n), device=dev)
                costs = torch.empty((A, N), device=dev)
                from numpower_tpu_torch.models.plants import kernel_plant
                from numpower_tpu_torch.models import cartpole_step
                plant = kernel_plant(cartpole_step)
                params = list(plant.params) + [0.0] * (8 - len(plant.params))
                fptrs = [fwd[k].data_ptr() for k in ("Q", "R", "QF", "goal")] + [
                    alphas.data_ptr()] + [fwd[k].data_ptr() for k in ("x0s", "xs", "us", "ks",
                                                                      "Ks")]
                args = (plant.plant_id, *(ctypes.c_float(p) for p in params), *fptrs,
                        us.data_ptr(), xs.data_ptr(), costs.data_ptr(), N, T, A, T + 1, stream)

                def fwd_call(lib_=lib, args=args):
                    return lib_.npt_ilqr_forward(*args)

                row = split(lib, stamps, fwd_call, T, "fwd", ALPHA_OF[variant](A, N))
                row["stamped_ms"] = event_ms(fwd_call)
                row["repo_library_ms"] = event_ms(lambda: main_lib.npt_ilqr_forward(*args))
                bounded = (xs.abs().amax(dim=(-2, -1)) <= 10.0).sum(dim=1).tolist()
                row["bounded_per_alpha"] = bounded
                results[f"{variant} K8 N={N} alphas={set_name}"] = row
                print(f"[probe] {variant} K8 N={N} alphas {set_name}: {json.dumps(row)}",
                      flush=True)
    # the lane-row buckets of K7 (no stamps there): device time of the kernel
    # before and today's on a random LTV problem (A near I), N = 4096, T = 30
    libs = {v: build(v) for v in variants}
    libs["repository"] = main_lib
    for n, m in ((12, 4), (16, 8)):
        N, T = 4096, 30
        rng = np.random.default_rng(n)
        f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
        ops = [f32(np.eye(n) + 0.05 * rng.standard_normal((N, T, n, n))),
               f32(0.3 * rng.standard_normal((N, T, n, m))), f32(rng.standard_normal((N, T, n))),
               f32(rng.standard_normal((N, T, m))), None, f32(2.0 * np.eye(n)),
               f32(0.2 * np.eye(m) + 1e-3 * np.eye(m)), f32(rng.standard_normal((N, n))),
               f32(10.0 * np.eye(n))]
        ptrs = [0 if t is None else t.data_ptr() for t in ops]
        ks = torch.empty((N, T, m), device=dev)
        Ks = torch.empty((N, T, m, n), device=dev)
        for name, lib in libs.items():
            if name == "current":
                continue  # the same kernel as the repository's library, stamps aside
            key = f"K7 bucket n={n} m={m} N={N} T={T} {name} ms"
            results[key] = event_ms(lambda lib=lib: lib.npt_ilqr_backward(
                *ptrs, ks.data_ptr(), Ks.data_ptr(), N, n, m, T, stream))
            print(f"[probe] {key}: {results[key]:.4f}", flush=True)
    results["clocks_after"] = subprocess.run(smi_q, capture_output=True, text=True).stdout.strip()
    print(f"[probe] clocks after: {results['clocks_after']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
