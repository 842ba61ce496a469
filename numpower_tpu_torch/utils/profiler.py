"""Profiling and timing hooks (port of numpower_tpu/utils/profiler.py).

 - trace(dir):     context manager around torch.profiler with the CPU and
                   CUDA activities; writes a Chrome/TensorBoard trace (JSON)
                   into dir
 - annotate(name): torch.profiler.record_function, a labelled region of the
                   trace
 - Timer:          wall-clock phase timer with summary statistics
 - time_compiled:  steady-state seconds per call by the slope method, which
                   cancels the constant cost of waiting for the result
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.utils._pytree as pytree


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, its trace written into ``log_dir`` as
    ``trace-<pid>-<ns>.json`` (chrome://tracing, TensorBoard's trace viewer).
    The CUDA activity is recorded where a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Label a region so that it shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class Timer:
    """Accumulating phase timer: with timer.phase("backward"): ..."""

    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self._times.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": len(ts),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(
                f"{name}: n={s['count']} mean={s['mean_ms']:.3f}ms "
                f"p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}ms"
            )
        return "\n".join(lines)


def _readback(out) -> None:
    """Wait for ``out``: a synchronize of its first tensor's card, or, on the
    CPU, a read of one element."""
    leaf = next(x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor))
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    else:
        float(leaf.reshape(-1)[0])


def time_compiled(fn: Callable, *args, reps: int = 5, inner=(5, 55),
                  return_stats: bool = False):
    """Steady-state seconds per call of fn(*args) by the slope method: the
    difference between windows of inner[1] and inner[0] calls enqueued back
    to back, each ended by one readback, divided by the difference of the
    counts, which cancels the readback's constant.

    Returns the MEDIAN over ``reps`` (at least 3) windows; with
    return_stats=True also their interquartile range."""
    _readback(fn(*args))
    n1, n2 = inner
    samples = []
    for _ in range(max(int(reps), 3)):
        t = time.perf_counter()
        out = None
        for _ in range(n1):
            out = fn(*args)
        _readback(out)
        t1 = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(n2):
            out = fn(*args)
        _readback(out)
        t2 = time.perf_counter() - t
        samples.append(max((t2 - t1) / (n2 - n1), 1e-12))
    med = float(np.median(samples))
    if return_stats:
        q25, q75 = np.percentile(samples, [25, 75])
        return med, float(q75 - q25)
    return med
