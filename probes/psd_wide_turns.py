#!/usr/bin/env python3
"""The wide K6b before and after its redesign at NB = 16, in turns on one
card, bit for bit.

    python probes/psd_wide_turns.py [name ...]   (from the repository root)

Builds, one nvcc each, all at once, into build/probes/psd_wide_turns/<name>/:
  - before: probes/cholesky_wide_before.cu, the form before the redesign (a
    block of 64 threads a matrix, staged by cp.async, factored by warp 0,
    each column substituted by a thread in a rolled loop over shared
    memory);
  - current: csrc/cholesky_wide.cu as it is (at NB = 16 four matrices a
    block, two factored by each of two warps, the columns in registers);
  - the named variants of current (VARIANTS, text substitutions), all of
    them where none is named.

Then: every build's X against before's, bit for bit (torch.equal), at every
bucket (chip_smoke.K6B_DIGEST_SHAPES, and N = 1 and 5); the CUDA-event time
of each build's direct library call at the "psd" Riccati route's shape
(4096, 16, 16) x (4096, 16, 48) and at (4096, 48, 48) x (4096, 48, 48)
(chip_smoke phase 28's operands), in turns (before, current, the others,
current, before) over ROUNDS rounds; the own durations (torch.profiler, 20
launches) of before and current, in turns; the bound (the bytes: a and b
read, X written once). All lines go to stdout and, as one JSON object, to
build/probes/psd_wide_turns/results.json, with the card's name and power
limit and each build's ptxas lines.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "probes" / "psd_wide_turns"
ROUNDS = 5
# text substitutions of csrc/cholesky_wide.cu: mats2 and mats8 put two or
# eight matrices in a block of the NB = 16 form in place of four
VARIANTS = {"mats2": [("constexpr int kSolve16Mats = 4;", "constexpr int kSolve16Mats = 2;")],
            "mats8": [("constexpr int kSolve16Mats = 4;", "constexpr int kSolve16Mats = 8;")]}


def sources(names) -> dict:
    src = (_build.CSRC / "cholesky_wide.cu").read_text()
    out = {"before": (ROOT / "probes" / "cholesky_wide_before.cu").read_text(), "current": src}
    for name, subs in VARIANTS.items():
        if names and name not in names:
            continue
        text = src
        for old, new in subs:
            assert old in text, f"the current source no longer has {old!r}"
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict) -> dict:
    """{name: (library path or None, build log)}, built side by side."""
    nvcc, procs = _build._nvcc(), {}
    for name, text in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wide.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
               str(d / "lib.so"), str(d / "wide.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    return {name: (OUT / name / "lib.so" if proc.returncode == 0 else None, log)
            for name, proc in procs.items() for log in [proc.communicate()[0]]}


def direct(fn, a, b):
    x = torch.empty_like(b)
    N, n, r = b.shape

    def call():
        code = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), N, n, r,
                  torch.cuda.current_stream().cuda_stream)
        assert code == 0, f"launch refused: {code}"
        return x

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("psd_wide_turns: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    built = build(sources(sys.argv[1:]))
    record = {"card": smi, "ptxas": {}, "bits": {}, "times_ms": {}}

    def say(line: str) -> None:
        print(f"[psd_wide_turns] {line}", flush=True)

    fns = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (path, log) in built.items():
        record["ptxas"][name] = [f"{e.split('::')[-1]} {t}" for e, t in cs.ptxas_lines(log)]
        if path is None:
            say(f"{name}: build failed\n{log[-4000:]}")
            continue
        fn = ctypes.CDLL(str(path)).npt_psd_solve_batched_wide
        fn.argtypes = (P, P, P, I, I, I, P)
        fn.restype = I
        fns[name] = fn
        say(f"{name}: built; {[x for x in record['ptxas'][name] if 'psd' in x]}")
    if "before" not in fns or "current" not in fns:
        return 1

    shapes = list(cs.K6B_DIGEST_SHAPES) + [(16, 48, 1), (16, 48, 5), (48, 48, 5), (3, 20, 1003)]
    for n_, r_, N_ in shapes:
        a = cs.spd_batch(N_, n_, n_ + r_, dev)
        b = torch.as_tensor(np.random.default_rng(n_ * 64 + r_).standard_normal((N_, n_, r_)),
                            dtype=torch.float32, device=dev)
        want = direct(fns["before"], a, b)().clone()
        for name, fn in fns.items():
            same = bool(torch.equal(direct(fn, a, b)(), want))
            record["bits"][f"{name} ({n_}, {n_}) x {r_} N = {N_}"] = same
        case = f"({n_}, {n_}) x {r_} N = {N_}"
        say(f"{case}: the before's bits in "
            f"{[k.split()[0] for k, v in record['bits'].items() if v and k.endswith(case)]}")

    n, m = 48, 16  # phase 28's formation
    ops = {"(16, 16) x 48": (cs.spd_batch(cs.N, m, 21, dev), torch.as_tensor(
               np.random.default_rng(31).standard_normal((cs.N, m, n)), dtype=torch.float32,
               device=dev)),
           "(48, 48) x 48": (cs.spd_batch(cs.N, n, 22, dev), torch.as_tensor(
               np.random.default_rng(32).standard_normal((cs.N, n, n)), dtype=torch.float32,
               device=dev))}
    order = ["before", "current", *[k for k in fns if k not in ("before", "current")],
             "current", "before"]
    record["own_us"], record["bound_ms"] = {}, {}
    for what, (a, b) in ops.items():
        calls = {name: direct(fn, a, b) for name, fn in fns.items()}
        times = {name: [] for name in fns}
        for _ in range(ROUNDS):
            for name in order:
                times[name].append(cs.cuda_ms(calls[name], reps=3, inner=10, warmup=2))
        for name, ts in times.items():
            record["times_ms"][f"{name} {what}"] = ts
            say(f"time {name} {what} N={cs.N}: median {statistics.median(ts):.4f} ms of "
                f"{[round(t, 5) for t in ts]} [{smi}]")
        own = {}
        for name in ("before", "current", "current", "before"):
            us = cs.profiled_us(calls[name], ["psd_solve_wide"], 20)["psd_solve_wide"]
            own.setdefault(name, []).append(us[0])
        record["own_us"][what] = own
        N_, n_, r_ = b.shape
        record["bound_ms"][what] = 4 * (N_ * n_ * n_ + 2 * N_ * n_ * r_) / cs.HBM_BYTES_PER_S * 1e3
        say(f"own {what} (torch.profiler, 20 launches, in turns): {own}; bound (bytes) "
            f"{record['bound_ms'][what]:.4f} ms [{smi}]")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "results.json").write_text(json.dumps(record, indent=1))
    return 0 if all(record["bits"].values()) else 2


if __name__ == "__main__":
    sys.exit(main())
