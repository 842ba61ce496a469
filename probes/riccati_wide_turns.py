#!/usr/bin/env python3
"""The wide K5 before and after its redesign for the tensor cores, in turns
on one card, with the parts of each form timed by ablation.

    python probes/riccati_wide_turns.py [quick] [name ...]   (from the repository root)

Builds, one nvcc each, all at once, into build/probes/riccati_wide_turns/<name>/:
  - before: probes/riccati_wide_before.cu, the form before the redesign (a
    thread a column of [A | B], the products as fp32 FMA chains fed by
    shared-memory broadcasts, S factored by the block);
  - current: csrc/riccati_wide.cu as it is, csrc/tf32_mma.cuh inlined (its
    products in the rounded 3xTF32 form);
  - the named variants of current (VARIANTS, text substitutions) and
    ablations of before (BEFORE_ABLATIONS), all of them where none is named.
    An ablation takes one part out, so its results are wrong: its time only
    is read.

Then, at the four-quadrotor formation (n = 48, m = 16, N = 4096, T = 30;
chip_smoke phase 28's operands): each build's Ks and P0 against the plain
version (rtol 1e-3 / atol 1e-4 on Ks, 1e-3 on P0), and on the formation with
A far from the identity (chip_smoke.formation_far: -As, As O; N = 1003) also
against float64 (within four times the plain version's distance, phase
28's check); the CUDA-event time of
each build's direct library call, in turns (before, current, the others,
current, before) over ROUNDS rounds; the own durations (torch.profiler, 10
launches) of before and current, in turns; the package's wrapper; the bound
(chip_smoke.riccati_wide_ops: the products in 3xTF32 on the tensor cores,
the rest on the CUDA cores, and the bytes), with all of it as fp32 beside
it. Unless ``quick``: current against the plain version and float64 at
every bucket's edge (chip_smoke.K5_WIDE_SHAPES, N = 1003 and 1, T = 0, 1
and 3), and at the formation with N = 1003. All lines go to stdout and, as
one JSON object, to build/probes/riccati_wide_turns/results.json, with the
card's name and power limit and each build's ptxas lines.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import _build, riccati  # noqa: E402

OUT = ROOT / "build" / "probes" / "riccati_wide_turns"
ROUNDS = 3
# text substitutions of csrc/riccati_wide.cu (csrc/tf32_mma.cuh inlined):
# (old, new) pairs. blocks5: five blocks of 128 threads an SM at the
# formation (96 registers a thread, 20 warps); threads256: 256 threads a
# block where 128 are (two blocks an SM); rn_split_only: hi rounded, but
# hi*hi summed in the tensor cores' accumulator over the k loop;
# trunc_split: the truncated form (tf32_mma.cuh's default, the wide K7's),
# timed only, since on A itself it leaves the bounds; bound1: no register bound from
# the occupancy (one block an SM in the launch bound); noinline_inverse: S's
# inverse a call of its own; unroll1: the item loops kept rolled; the rest
# take one part out
# (ablations, their results wrong): single_pass (hi*hi alone), no_p1 (Y =
# PM), no_p2 (M'Y), no_inverse, no_p3 (K), no_p4 (P'), no_store (K to Ks)
THREADS_RULE = "NB + MB <= 32 ? 64 : NB + MB <= 64 ? 128 : 256;"
BOUND_RULE = "512 / WideLayout<NB, MB>::threads)"
INVERSE = "if constexpr (kWarpInverse) spd_inverse_sweep<MB>(Lq, ldL, m, Qi, ldq, lane);"
NOINLINE = """template <int MB>
__device__ __noinline__ void inverse_call(const float* Lq, int ldL, int m, float* Qi, int ldq,
                                         int lane) {
  spd_inverse_sweep<MB>(Lq, ldL, m, Qi, ldq, lane);
}

// At most 128 registers"""
ITEM_LOOPS = ("    for (int it = warp; it < nb * (nb + mb); it += nw) {",
              "      for (int it = 0; it < ns; ++it) block(it);",
              "      for (int it = (kWarpInverse ? ns : 0) + w; it < items; it += ws) block(it);",
              "      for (int it = warp; it < mb * nb; it += nw) {",
              "    for (int it = warp; it < nb * (nb + 1) / 2; it += nw) {")
ROUNDED = [("true, true, true>(", "true, true>("), ("false, true, true>(", "false, true>(")]
VARIANTS = {
    "rn_split_only": [("if constexpr (kRound) {\n      float part[4]",
                       "if constexpr (false) {\n      float part[4]")],
    "trunc_split": ROUNDED,
    "bound1": [(BOUND_RULE, "1)")],
    "noinline_inverse": [("// At most 128 registers", NOINLINE),
                         (INVERSE, INVERSE.replace("spd_inverse_sweep", "inverse_call"))],
    "unroll1": [(loop, "#pragma unroll 1\n" + loop) for loop in ITEM_LOOPS],
    "blocks5": [(BOUND_RULE, BOUND_RULE.replace("512", "640"))],
    "threads256": [(THREADS_RULE, "NB + MB <= 32 ? 64 : 256;")],
    "single_pass": [("mma_tf32(cr[h], al, bhh);\n    mma_tf32(cr[h], ah, blh);", "")],
    "no_p1": [("for (int it = warp; it < nb * (nb + mb); it += nw) {",
               "for (int it = warp; it < 0; it += nw) {")],
    "no_p2": [("auto block = [&](int it) {",
               "auto block = [&](int it) {\n      if (it >= 0) return;")],
    "no_inverse": [(INVERSE, "")],
    "no_p3": [("for (int it = warp; it < mb * nb; it += nw) {",
               "for (int it = warp; it < 0; it += nw) {")],
    "no_p4": [("for (int it = warp; it < nb * (nb + 1) / 2; it += nw) {",
               "for (int it = warp; it < 0; it += nw) {")],
    "no_store": [("for (int c = lane; c < n; c += 32) Kout[a * n + c] = XX[a * ldr + c];",
                  "for (int c = lane; c < 0; c += 32) Kout[a * n + c] = XX[a * ldr + c];")],
}
# text substitutions of probes/riccati_wide_before.cu, each taking one part out
BEFORE_ABLATIONS = {
    "before_no_y": [("#pragma unroll 2\n    for (int j = 0; j < NB; ++j) {",
                     "#pragma unroll 2\n    for (int j = 0; j < 0; ++j) {")],
    "before_no_z": [("for (int k = a_col ? 0 : NB; k < NC; k += 2) {",
                     "for (int k = a_col ? 0 : NB; k < 0; k += 2) {")],
    "before_no_factor": [("for (int j = 0; j < MB; ++j) {\n      const float inv",
                          "for (int j = 0; j < 0; ++j) {\n      const float inv")],
    "before_no_subst": [("for (int a = 0; a < MB; ++a) {\n        float v = G",
                         "for (int a = 0; a < 0; ++a) {\n        float v = G"),
                        ("for (int a = MB - 1; a >= 0; --a) {",
                         "for (int a = MB - 1; a >= MB; --a) {")],
    "before_no_gg": [("for (int a = 0; a < MB; ++a) {\n        float grow",
                      "for (int a = 0; a < 0; ++a) {\n        float grow")],
}
ABLATIONS = (*BEFORE_ABLATIONS, "single_pass", "no_p1", "no_p2", "no_inverse", "no_p3", "no_p4",
             "no_store", "trunc_split")


def sources(names) -> dict:
    # the shared TF32 helpers inlined, so that a variant may change them too
    src = (_build.CSRC / "riccati_wide.cu").read_text().replace(
        '#include "tf32_mma.cuh"', (_build.CSRC / "tf32_mma.cuh").read_text())
    before = (ROOT / "probes" / "riccati_wide_before.cu").read_text()
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


def operands(As, B, Q, R, QF, T, dev):
    """(As, Bs, Q, R, QF, T) on the card as the wrapper hands them to the
    kernel, B (n, m) broadcast to every scenario."""
    N, (n, m) = As.shape[0], B.shape
    return (torch.as_tensor(As, device=dev).contiguous(),
            torch.as_tensor(B, device=dev).expand(N, n, m).contiguous(),
            *(torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
              for x in (Q, R, QF)), T)


def main() -> int:
    if not torch.cuda.is_available():
        print("riccati_wide_turns: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    quick = "quick" in sys.argv[1:]
    built = build(sources([a for a in sys.argv[1:] if a != "quick"]))
    record = {"card": smi, "ptxas": {}, "checks": {}, "times_ms": {}}

    def say(line: str) -> None:
        print(f"[riccati_wide_turns] {line}", flush=True)

    fns = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (path, log) in built.items():
        record["ptxas"][name] = [f"{e.split('::')[-1]} {t}" for e, t in cs.ptxas_lines(log)]
        if path is None:
            say(f"{name}: build failed\n{log[-4000:]}")
            continue
        fn = ctypes.CDLL(str(path)).npt_riccati_fused_wide
        fn.argtypes = (P,) * 7 + (I,) * 4 + (P,)
        fn.restype = ctypes.c_int
        fns[name] = fn
        spills = sorted({x.split()[0] for x in record["ptxas"][name]
                         if "spill" in x and "0 bytes spill stores, 0 bytes spill loads" not in x})
        say(f"{name}: built; {[x for x in record['ptxas'][name] if '48, 16' in x]}; "
            f"instances with spills: {spills}")
    if "before" not in fns or "current" not in fns:
        return 1

    def direct(fn, ops):
        As, Bs, Q, R, QF, T = ops
        N, n, m = Bs.shape
        Ks = torch.empty((N, T, m, n), device=dev)
        P0 = torch.empty((N, n, n), device=dev)

        def call():
            code = fn(As.data_ptr(), Bs.data_ptr(), Q.data_ptr(), R.data_ptr(), QF.data_ptr(),
                      Ks.data_ptr(), P0.data_ptr(), N, n, m, T,
                      torch.cuda.current_stream().cuda_stream)
            assert code == 0, f"launch refused: {code}"
            return Ks, P0

        return call

    form = operands(*cs.formation(cs.N_FORMATION, cs.N), cs.T, dev)
    n, m = form[1].shape[1:]
    say(f"formation (n, m, N, T) = ({n}, {m}, {cs.N}, {cs.T}) [{smi}]")
    Ks_p, P0_p = riccati.riccati_batched_reference(*form)
    calls = {}
    for name, fn in fns.items():
        calls[name] = direct(fn, form)
        Ks, P0 = calls[name]()
        torch.cuda.synchronize()
        held = cs.close(Ks, Ks_p, 1e-3, 1e-4) and cs.close(P0, P0_p, 1e-3, 1e-3)
        record["checks"][f"{name} formation"] = {"dKs": cs.max_err(Ks, Ks_p),
                                                 "dP0": cs.max_err(P0, P0_p), "held": held}
        say(f"{name} formation vs plain: max|dKs| {cs.max_err(Ks, Ks_p):.3e} max|dP0| "
            f"{cs.max_err(P0, P0_p):.3e}: {'held' if held else 'NOT HELD'}"
            f"{' (an ablation: not checked)' if name in ABLATIONS else ''}")
    del Ks_p, P0_p

    order = ["before", "current", *[k for k in fns if k not in ("before", "current")],
             "current", "before"]
    times = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name in order:
            times[name].append(cs.cuda_ms(calls[name], reps=3, inner=3, warmup=1))
    for name, ts in times.items():
        record["times_ms"][name] = ts
        say(f"time {name} formation: median {statistics.median(ts):.4f} ms of {ts} [{smi}]")
    own = {}
    for name in ("before", "current", "current", "before"):
        us = cs.profiled_us(calls[name], ["riccati_wide_kernel"], 10)["riccati_wide_kernel"]
        own.setdefault(name, []).append(us[0])
    record["own_us"] = own
    wrapper = cs.cuda_ms(lambda: riccati.riccati_batched_fused(*form), reps=5, inner=3)
    record["wrapper_ms"] = wrapper
    cuda_ops, tf32_ops, n_bytes, fp32_all = cs.riccati_wide_ops(cs.N, cs.T, n, m)
    record["bound_ms"] = {"bytes": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                          "CUDA-core operations": cuda_ops / cs.FP32_FLOP_PER_S * 1e3,
                          "TF32 tensor operations": tf32_ops / cs.TF32_TENSOR_FLOP_PER_S * 1e3,
                          "all as fp32 (comparison)": fp32_all / cs.FP32_FLOP_PER_S * 1e3}
    say(f"own (torch.profiler, 10 launches, in turns): {own}; wrapper (current) "
        f"{wrapper:.4f} ms; bound {record['bound_ms']} [{smi}]")

    # the formation with A far from the identity: every build that is not
    # an ablation, against plain and float64
    for kind in cs.FAR_FROM_I:
        ops = operands(*cs.formation_far(kind, cs.N_FORMATION, cs.N_RAGGED), cs.T, dev)
        Ks_p, P0_p = riccati.riccati_batched_reference(*ops)
        Ks_64, P0_64 = riccati.riccati_batched_reference(*[x.double() for x in ops[:5]], ops[5])
        e_p = max(cs.scaled_err(Ks_p, Ks_64, 1e-3, 1e-4), cs.scaled_err(P0_p, P0_64, 1e-3, 1e-3))
        for name, fn in fns.items():
            if name in ABLATIONS and name != "trunc_split":
                continue
            Ks, P0 = direct(fn, ops)()
            e_k = max(cs.scaled_err(Ks, Ks_64, 1e-3, 1e-4), cs.scaled_err(P0, P0_64, 1e-3, 1e-3))
            held = (cs.close(Ks, Ks_p, 1e-3, 1e-4) and cs.close(P0, P0_p, 1e-3, 1e-3)
                    and e_k <= max(1.0, 4 * e_p))
            record["checks"][f"{name} formation A {kind}"] = {
                "dKs": cs.max_err(Ks, Ks_p), "dP0": cs.max_err(P0, P0_p), "f64_scaled": e_k,
                "plain_f64_scaled": e_p, "held": held}
            say(f"{name} formation, A {kind}, N={cs.N_RAGGED}: max|dKs| {cs.max_err(Ks, Ks_p):.3e} "
                f"max|dP0| {cs.max_err(P0, P0_p):.3e} vs plain; vs float64 scaled {e_k:.3e} "
                f"(plain {e_p:.3e}): {'held' if held else 'NOT HELD'}"
                f"{' (timed only: not checked)' if name in ABLATIONS else ''}")
        del Ks_p, P0_p, Ks_64, P0_64

    if not quick:
        shapes = [("formation N=1003", tuple(x[:cs.N_RAGGED] if i < 2 else x
                                             for i, x in enumerate(form)))]
        for n_e, m_e in cs.K5_WIDE_SHAPES:
            for N_e, T_e in ((cs.N_RAGGED, 3), (1, 1), (5, 0)):
                A_e, B_e, *c_e = cs.stable_plant(n_e, m_e, N_e, seed=n_e * 64 + m_e)
                shapes.append((f"({n_e}, {m_e}) N={N_e} T={T_e}",
                               operands(A_e, B_e, *c_e, T_e, dev)))
        for what, ops in shapes:
            Ks, P0 = direct(fns["current"], ops)()
            Ks_p, P0_p = riccati.riccati_batched_reference(*ops)
            ops64 = [x.double() for x in ops[:5]]
            Ks_64, P0_64 = riccati.riccati_batched_reference(*ops64, ops[5])
            pairs = [(P0, P0_p, P0_64, 1e-3, 1e-3)] + ([(Ks, Ks_p, Ks_64, 1e-3, 1e-4)]
                                                       if Ks.numel() else [])
            e_k = max(cs.scaled_err(a, c, r, t) for a, _, c, r, t in pairs)
            e_p = max(cs.scaled_err(b, c, r, t) for _, b, c, r, t in pairs)
            held = (cs.close(Ks, Ks_p, 1e-3, 1e-4) and cs.close(P0, P0_p, 1e-3, 1e-3)
                    and e_k <= max(1.0, 4 * e_p))
            dK = cs.max_err(Ks, Ks_p) if Ks.numel() else 0.0  # T = 0: no gains
            record["checks"][f"current {what}"] = {"dKs": dK, "dP0": cs.max_err(P0, P0_p),
                                                   "f64_scaled": e_k, "plain_f64_scaled": e_p,
                                                   "held": held}
            say(f"current {what}: max|dKs| {dK:.3e} max|dP0| {cs.max_err(P0, P0_p):.3e} vs "
                f"plain; vs float64 scaled {e_k:.3e} (plain {e_p:.3e}): "
                f"{'held' if held else 'NOT HELD'}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "results.json").write_text(json.dumps(record, indent=1))
    return 0 if all(v["held"] for k, v in record["checks"].items()
                    if not any(k.startswith(a + " ") for a in ABLATIONS)) else 2


if __name__ == "__main__":
    sys.exit(main())
