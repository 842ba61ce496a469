#!/usr/bin/env python3
"""The wide K13 before and after its redesign (eps read once a round), in
turns on one card, with the parts of each form timed by ablation.

    python probes/mppi_wide_turns.py [name ...]   (from the repository root)

Builds, one nvcc each, all at once, into build/probes/mppi_wide_turns/<name>/:
  - before: probes/mppi_wide_before.cu, the form before the redesign (each
    round a rollout of every tile into a row of S, three block reductions,
    then the update reading eps from device memory again);
  - current: csrc/mppi_wide.cu as it is;
  - the named variants of current (VARIANTS: text substitutions, or another
    launch plan) and ablations of before (BEFORE_ABLATIONS), all of them
    where none is named. An ablation takes one part out, so its results
    are wrong: its time only is read.

Then, at the MPPI bench's swing-up at 4096 samples (the pendulum, N = 256,
K = 4096, T = 40, lam = 1; chip_smoke phase 32's path): each build's us
and ess at two rounds against the plain version on the same eps (us atol
2e-3, ess rtol 1e-3); the CUDA-event time of each build's direct library
call at eight rounds, in turns (before, current, the others, current,
before) over ROUNDS rounds; the own durations (torch.profiler, 10 launches)
of before and current, in turns; the bound (chip_smoke.mppi_work: eps read
once) and the rollout's instruction floor (chip_smoke.mppi_issue_floor_ms).
All lines go to stdout and, as one JSON object, to
build/probes/mppi_wide_turns/results.json, with the card's name and power
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
from numpower_tpu_torch.kernels import _build, mppi  # noqa: E402
from numpower_tpu_torch.kernels.ekf import plant_floats  # noqa: E402
from numpower_tpu_torch.models.plants import kernel_plant  # noqa: E402

OUT = ROOT / "build" / "probes" / "mppi_wide_turns"
ROUNDS = 3
# text substitutions of csrc/mppi_wide.cu ((old, new) pairs), or a launch
# plan (threads, samples a thread) in place of the package's wide_plan:
# no_update takes the tiles' update terms out: each entry's loop over the
# tile's samples (its eps reads and terms), so that the numerator is 0 and
# the nominal stays where it starts, as in before_no_update and
# before_no_terms (ablations: their results wrong). Taking the whole entry
# loop out instead leaves the numerator unwritten: the nominal then comes
# from uninitialised memory and the rollout runs slower on it (3.07 ms in
# two earlier readings, not a time of the kernel). tile512 and tile256 walk
# the samples in tiles of 256 x 2 and 256 x 1 (a smaller slice of eps in L2
# between a tile's rollout and its update)
VARIANTS = {"no_update": [("for (int k = lane; k < len; k += 32) {",
                           "for (int k = lane; k < 0; k += 32) {")]}
PLANS = {"tile512": (256, 2), "tile256": (256, 1)}
# text substitutions of probes/mppi_wide_before.cu, each taking one part out
BEFORE_ABLATIONS = {
    "before_no_update": [("for (int eb = warp; eb < TM; eb += kE * nw) {",
                          "for (int eb = warp; eb < 0; eb += kE * nw) {")],
    "before_no_terms": [("for (int k = lane; k < a.K; k += 32) {",
                         "for (int k = lane; k < 0; k += 32) {")],
    "before_no_rollout": [("for (int t = 0; t < a.T; ++t) {\n        // the next step's",
                           "for (int t = 0; t < 0; ++t) {\n        // the next step's")],
}
ABLATIONS = (*BEFORE_ABLATIONS, "no_update")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# before: plant, 8 parameters, consts, x0s, eps, us0, us, ess, scratch, N, K, T,
# iters, lam, inv_lam, clip, lo, hi, threads, spt, row_smem, stream
BEFORE_ARGTYPES = (_I,) + (_F,) * 8 + (_P,) * 7 + (_I,) * 4 + (_F, _F, _I, _F, _F) + (_I,) * 3 \
    + (_P,)


def sources(names) -> dict:
    src = (_build.CSRC / "mppi_wide.cu").read_text()
    before = (ROOT / "probes" / "mppi_wide_before.cu").read_text()
    out = {"before": before, "current": src}
    for base, text0, table in (("current", src, VARIANTS), ("before", before, BEFORE_ABLATIONS)):
        for name, subs in table.items():
            if names and name not in names:
                continue
            text = text0
            for old, new in subs:
                assert old in text, f"the {base} source no longer has {old!r}"
                text = text.replace(old, new)
            out[name] = text
    for name in PLANS:
        if not names or name in names:
            out[name] = src
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


def main() -> int:
    if not torch.cuda.is_available():
        print("mppi_wide_turns: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    built = build(sources(sys.argv[1:]))
    record = {"card": smi, "ptxas": {}, "checks": {}, "times_ms": {}}

    def say(line: str) -> None:
        print(f"[mppi_wide_turns] {line}", flush=True)

    fns = {}
    for name, (path, log) in built.items():
        record["ptxas"][name] = [f"{e.split('::')[-1]} {t}" for e, t in cs.ptxas_lines(log)
                                 if "<0, " in e]
        if path is None:
            say(f"{name}: build failed\n{log[-4000:]}")
            continue
        fn = ctypes.CDLL(str(path)).npt_mppi_wide
        fn.argtypes = BEFORE_ARGTYPES if name.startswith("before") else \
            _build._SIGNATURES["npt_mppi_wide"]  # the package's entry
        fn.restype = ctypes.c_int
        fns[name] = fn
        say(f"{name}: built; pendulum instances {record['ptxas'][name]}")
    if "before" not in fns or "current" not in fns:
        return 1

    f, n, m, cost = cs.mppi_plants()["pendulum"]
    plant = kernel_plant(f)
    N, K, T = cs.N_MPPI, cs.K_WIDE, cs.T_MPPI
    x0s = torch.as_tensor(np.random.default_rng(8).uniform(-np.pi, np.pi, (N, n)),
                          dtype=torch.float32, device=dev)
    us0 = torch.zeros(T * m, device=dev)
    consts = mppi.packed_constants(cost, 1.0, n, m)
    head = (plant.plant_id, *plant_floats(plant), ctypes.addressof(consts))

    def direct(name, eps, iters):
        """A direct library call of build `name` on eps (its outputs allocated once)."""
        us = torch.empty((N, T, m), device=dev)
        ess = torch.empty((N, iters), device=dev)
        ptrs = (x0s.data_ptr(), eps.data_ptr(), us0.data_ptr(), us.data_ptr(), ess.data_ptr())
        tail = (N, K, T, iters, 1.0, 1.0, 0, -float("inf"), float("inf"))
        if len(fns[name].argtypes) == len(BEFORE_ARGTYPES):
            # the before form's entry: the parent's plan, 256 threads x 4, the row in smem
            args = (*head, *ptrs, None, *tail, 256, 4, 1)
        else:
            threads, spt = PLANS.get(name, mppi.wide_plan(K)[:2])
            args = (*head, *ptrs, *tail, threads, spt)

        def call():
            code = fns[name](*args, torch.cuda.current_stream().cuda_stream)
            assert code == 0, f"{name}: launch refused: {code}"
            return us, ess

        return call

    gen = torch.Generator(device=dev).manual_seed(0)
    eps2 = mppi.eps_kernel_layout(gen, N, 2, T, m, K, 1.0)
    kw = dict(T=T, iters=2, m=m, lam=1.0, sigma=1.0)
    us_p, ess_p = mppi.mppi_fused_reference(f, cost.rows, x0s, eps2, us0, **kw)
    for name in fns:
        us, ess = direct(name, eps2, 2)()
        torch.cuda.synchronize()
        du = cs.max_err(us, us_p)
        d_ess = ((ess.double() - ess_p.double()) / ess_p.double()).abs().max().item()
        again = [x.clone() for x in direct(name, eps2, 2)()]
        same = bool(torch.equal(again[0], us) and torch.equal(again[1], ess))
        held = du <= 2e-3 and d_ess <= 1e-3 and same
        record["checks"][f"{name} two rounds"] = {"dus": du, "dess_rel": d_ess,
                                                  "deterministic": same, "held": held}
        say(f"{name} two rounds vs plain: max|dus| {du:.3e} max rel dess {d_ess:.3e}, two "
            f"launches bit for bit: {same}: {'held' if held else 'NOT HELD'}"
            f"{' (an ablation: not checked)' if name in ABLATIONS else ''}")
    del eps2, us_p, ess_p

    eps = mppi.eps_kernel_layout(gen, N, cs.IT_MPPI, T, m, K, 1.0)
    calls = {name: direct(name, eps, cs.IT_MPPI) for name in fns}
    order = ["before", "current", *[k for k in fns if k not in ("before", "current")],
             "current", "before"]
    times = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name in order:
            times[name].append(cs.cuda_ms(calls[name], reps=3, inner=3, warmup=1))
    for name, ts in times.items():
        record["times_ms"][name] = ts
        say(f"time {name} N={N} K={K} T={T} iters={cs.IT_MPPI}: median "
            f"{statistics.median(ts):.4f} ms of {ts} [{smi}]")
    own = {}
    for name in ("before", "current", "current", "before"):
        us = cs.profiled_us(calls[name], ["mppi_wide_kernel"], 10)["mppi_wide_kernel"]
        own.setdefault(name, []).append(us[0])
    record["own_us"] = own
    n_bytes, n_ops = cs.mppi_work(N, K, T, cs.IT_MPPI, n, m, "pendulum_step")
    record["bound_ms"] = {"bytes": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                          "operations": n_ops / cs.FP32_FLOP_PER_S * 1e3,
                          "issue floor": cs.mppi_issue_floor_ms(N, K, T, cs.IT_MPPI)}
    say(f"own (torch.profiler, 10 launches, in turns): {own}; bound {record['bound_ms']} "
        f"[{smi}]")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "results.json").write_text(json.dumps(record, indent=1))
    return 0 if all(v["held"] for k, v in record["checks"].items()
                    if not any(k.startswith(a + " ") for a in ABLATIONS)) else 2


if __name__ == "__main__":
    sys.exit(main())
