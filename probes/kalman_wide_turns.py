#!/usr/bin/env python3
"""The wide K9 before and after its form 0 moved to the tensor cores, in
turns on one card, with the parts of the new form timed by ablation.

    python probes/kalman_wide_turns.py [quick] [name ...] [name=file.cu ...]
        (from the repository root)

Builds, one nvcc each, all at once, into build/probes/kalman_wide_turns/<name>/:
  - before: probes/kalman_wide_before.cu, the form before the redesign (a
    block of 256 threads a tile of 32 trajectories, each thread 4 x 4
    outputs of a step's products as fp32 FMA chains fed by 16-byte shared
    loads, the stores a warp a row);
  - current: csrc/kalman_wide.cu as it is, csrc/tf32_mma.cuh inlined (its
    products in the rounded 3xTF32 form on mma.sync, a block of eight warps
    a tile of 16, alpha a step later beside x_p C', the copies issued by two
    warps, x_f and x_p out by bulk copies);
  - the named variants of current (VARIANTS, text substitutions), all of
    them where none is named, and each name=file.cu given (another form of
    csrc/kalman_wide.cu, timed and checked as current is). An ablation takes one part out, so its
    results are wrong: its time only is read.

Then, at the four-quadrotor formation (n = 48, p = 24, N = 4096, T = 50;
chip_smoke phase 30's operands): each build's xs_f, xs_p and ll against the
plain version and float64 with phase 30's bounds (chip_smoke.held_against:
means atol 2e-5, ll rtol 2e-4 / atol 2e-3, or four times the plain fp32
version's own distance), without and with inputs; the CUDA-event time of
each build's direct library call, in turns (before, current, the others,
current, before) over ROUNDS rounds; the own durations (torch.profiler, 10
launches) of before and current, in turns, without and with inputs; the
bound (chip_smoke.kalman_wide_ops: the products in 3xTF32 on the tensor
cores, the rest on the CUDA cores, and the bytes), with all of it as fp32
beside it. Unless ``quick``: current against the plain version and float64
at the formation with N = 1003 and at chip_smoke.KALMAN_WIDE_EDGES (N =
4096, T = 13), without and with inputs. All lines go to stdout and, as one
JSON object, to build/probes/kalman_wide_turns/results.json, with the
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
from numpower_tpu_torch.kernels import _build, kalman_mean  # noqa: E402

OUT = ROOT / "build" / "probes" / "kalman_wide_turns"
ROUNDS = 3
PLAN = "layout_k9_mma(n, p, has_u, full ? 2 : 1, full)"
KLOOP = "  for (int kk = 0; kk < ksteps; ++kk) {\n    uint32_t ah[4], al[4];"
# text substitutions of csrc/kalman_wide.cu (csrc/tf32_mma.cuh inlined):
# (old, new) pairs. Forms: lean (one buffer of W_t staged at the step and no
# dense buffers: x_f and x_p stored from the tile, a warp a row; the form
# taken where the full one does not fit), single_wl (one buffer of W_t with
# the bulk stores), tile_stores (two buffers, the stores from the tile),
# warps4 (a block of four warps), unroll1 / unroll3 / unroll6 (the products'
# k-loop so unrolled), all_stage (the step's copies issued by every thread,
# not by the last two warps alone), one_stager (by the last warp alone);
# trunc_split (hi truncated and hi*hi summed in the accumulator, the wide
# K7's form) is timed only. The rest take one part out (ablations, their
# results wrong): no_a (x A'), no_b (x_p C'), no_c (v W_t), no_alpha (v
# invL_t'), no_stores (x_f and x_p), single_pass (hi*hi alone), no_hmma
# (each mma.sync an add of its operands' bits), half_depth (x A' and x_p C'
# over half their depth), no_stage (the step's copies of W_t, invL_t, y_t
# and u_t), no_wait (the step's wait for them), no_cst (the step's
# constant), no_bulk_wait (the waits before a dense buffer is written
# again), no_fence (the proxy fences before the bulk copies), compute_only
# (no_stores and no_stage), skeleton (that and no_a, no_b, no_c, no_alpha:
# the step's barriers, ll and what is left of its epilogues); stamps adds
# cycle stamps (probes/stamps.cuh) at the step's parts.
VARIANTS = {
    "lean": [(PLAN, "layout_k9_mma(n, p, has_u, 1, 0)")],
    "single_wl": [(PLAN, "layout_k9_mma(n, p, has_u, 1, 1)")],
    "tile_stores": [(PLAN, "layout_k9_mma(n, p, has_u, 2, 0)")],
    "trunc_split": [("split_tf32<true>", "split_tf32<false>")],
    "warps4": [("constexpr int kMmaThreads = 256;", "constexpr int kMmaThreads = 128;")],
    "no_a": [("j < JA; j += kMmaWarps) {", "j < 0; j += kMmaWarps) {")],
    "no_b": [("          continue;\n        }\n        float out[4];\n",
              "          continue;\n        }\n        if (u >= 0) continue;\n        float out[4];\n")],
    "no_c": [("q < JA; q += kMmaWarps) {", "q < 0; q += kMmaWarps) {")],
    "no_alpha": [("          alpha_tile(u - JB, (t - 1) & 1);\n", "")],
    "one_stager": [("  constexpr int kStagers = 64;", "  constexpr int kStagers = 32;")],
    "no_stores": [("    const int bytes = 4 * rows * n;\n",
                   "    const int bytes = 4 * rows * n;\n    if (bytes >= 0) return;\n")],
    "single_pass": [("  tf32_mma::mma_tf32(cr, al, bh);\n  tf32_mma::mma_tf32(cr, ah, bl);\n", "")],
    **{f"unroll{u}": [(KLOOP, f"#pragma unroll {u}\n" + KLOOP)] for u in (1, 3, 6)},
    "no_wait": [("    __pipeline_wait_prior(1);\n    if (dense && tid == 0) bulk_wait_read<2>();",
                 "    if (dense && tid == 0) bulk_wait_read<2>();"),
                ("    __pipeline_wait_prior(1);  // invL of step t - 1 landed\n", "")],
    "no_cst": [("    const float cst_t = __ldg(a.cst + t);  // used a step later\n"
                "    __pipeline_wait_prior(1);\n    if (dense",
                "    const float cst_t = 0.0f;\n    __pipeline_wait_prior(1);\n    if (dense")],
    "no_hmma": [('  asm volatile(\n      "mma.sync.aligned.m16n8k8',
                 "  d[0] += __uint_as_float(a[0] & b[0]);\n"
                 "  d[1] += __uint_as_float(a[1] & b[1]);\n"
                 "  d[2] += __uint_as_float(a[2] & b[0]);\n"
                 "  d[3] += __uint_as_float(a[3] & b[1]);\n"
                 '  if (false) asm volatile(\n      "mma.sync.aligned.m16n8k8')],
    "half_depth": [("KA = g.nP >> 3, KB = g.pP >> 3;", "KA = (g.nP >> 3) / 2, KB = g.pP >> 3;")],
    "no_stage": [("    if (stager) {\n      if (!two_w) stage_wt(t, 0);",
                  "    if (false) {\n      if (!two_w) stage_wt(t, 0);"),
                 ("    if (stager && t + 1 < T) stage_yu(t + 1);", "    if (false) stage_yu(t + 1);"),
                 ("    if (stager) stage_l(sm + g.oL,", "    if (false) stage_l(sm + g.oL,")],
    "all_stage": [("  constexpr int kStagers = 64;", "  constexpr int kStagers = kMmaThreads;")],
    "no_bulk_wait": [("    if (dense && tid == 0) bulk_wait_read<2>();", ""),
                     ("    if (dense && tid == 0) bulk_wait_read<3>();", "")],
    "no_fence": [("    if (dense) fence_proxy_async();\n", "")],
    "stamps": [
        ("#include \"async_copy.cuh\"", "#include \"async_copy.cuh\"\n#include \"stamps.cuh\""),
        ("kalman_wide_kernel(const K9Args a, const Geo g) {\n",
         "kalman_wide_kernel(const K9Args a, const Geo g) {\n  NPT_STAMP_BEGIN;\n"),
        ("    __syncthreads();  // step t's inputs landed; step t - 1 done\n    const int wb",
         "    __syncthreads();  // step t's inputs landed; step t - 1 done\n    NPT_STAMP(0);\n"
         "    const int wb"),
        ("      else if (t + 1 < T) stage_wt(t + 1, (t + 1) & 1);\n    }\n    __pipeline_commit();\n",
         "      else if (t + 1 < T) stage_wt(t + 1, (t + 1) & 1);\n    }\n    __pipeline_commit();\n"
         "    NPT_STAMP(1);\n"),
        ("    if (dense) fence_proxy_async();\n    __syncthreads();\n\n    // phase B",
         "    NPT_STAMP(2);\n    if (dense) fence_proxy_async();\n    __syncthreads();\n"
         "    NPT_STAMP(3);\n\n    // phase B"),
        ("    if (!two_w) __pipeline_wait_prior(1);  // W_t landed",
         "    NPT_STAMP(4);\n    if (!two_w) __pipeline_wait_prior(1);  // W_t landed"),
        ("    __syncthreads();\n\n    // phase C: invL_t in",
         "    __syncthreads();\n    NPT_STAMP(5);\n\n    // phase C: invL_t in"),
        ("    if (dense) fence_proxy_async();\n    cst_prev = cst_t;",
         "    NPT_STAMP(6);\n    if (dense) fence_proxy_async();\n    cst_prev = cst_t;"),
        ("  if (dense && tid == 0) bulk_wait_all();\n}",
         "  if (dense && tid == 0) bulk_wait_all();\n  NPT_STAMP_END;\n}"),
    ],
}
STAMP_PARTS = ("top barrier (copies and bulk waits)", "x_f out, W in", "phase A",
               "barrier after A", "x_p out, y and u in, phase B and alpha", "barrier before C",
               "invL in, ll, phase C")
VARIANTS["compute_only"] = VARIANTS["no_stores"] + VARIANTS["no_stage"]
VARIANTS["skeleton"] = (VARIANTS["no_a"] + VARIANTS["no_b"] + VARIANTS["no_c"]
                        + VARIANTS["no_alpha"] + VARIANTS["compute_only"])
ABLATIONS = ("compute_only", "skeleton", "no_a", "no_b", "no_c", "no_alpha", "no_stores",
             "single_pass",
             "trunc_split", "no_stage", "no_bulk_wait", "no_fence", "stamps", "no_hmma",
             "half_depth", "no_wait", "no_cst")


def sources(names) -> dict:
    # the shared TF32 helpers inlined, so that a variant may change them too
    tf32 = (_build.CSRC / "tf32_mma.cuh").read_text()
    src = (_build.CSRC / "kalman_wide.cu").read_text().replace('#include "tf32_mma.cuh"', tf32)
    out = {"before": (ROOT / "probes" / "kalman_wide_before.cu").read_text(), "current": src}
    for name, path in (a.split("=", 1) for a in names if "=" in a):
        out[name] = (ROOT / path).read_text().replace('#include "tf32_mma.cuh"', tf32)
    names = [a for a in names if "=" not in a]
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
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-I", str(ROOT / "probes"),
               "-shared", "-o",
               str(d / "lib.so"), str(d / "wide.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    return {name: (OUT / name / "lib.so" if proc.returncode == 0 else None, log)
            for name, proc in procs.items() for log in [proc.communicate()[0]]}


def bind(path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.npt_kalman_mean_wide.argtypes = (P,) * 12 + (I, I, I, I, P)
    lib.npt_kalman_mean_wide.restype = I
    lib.npt_kalman_mean_wide_workspace.argtypes = (I, I, I, I)
    lib.npt_kalman_mean_wide_workspace.restype = ctypes.c_longlong
    lib.npt_kalman_mean_wide_plan.argtypes = (I, I, I)
    lib.npt_kalman_mean_wide_plan.restype = I
    return lib


def direct(lib, args, dev):
    """A call of the build's kernel on kalman_mean_pass's operands (the
    wrapper's arguments, formed once)."""
    A, C, Ws, invLs, logdets, x0s, ys_t, us_t = args
    T, N, p = ys_t.shape
    n = x0s.shape[1]
    cst = kalman_mean._step_constants(logdets, p).contiguous()
    xs_f = torch.empty((T, N, n), device=dev)
    xs_p = torch.empty((T, N, n), device=dev)
    ll = torch.empty((N,), device=dev)
    floats = lib.npt_kalman_mean_wide_workspace(N, n, p, int(us_t is not None))
    work = torch.empty(max(floats, 1), device=dev)

    def call():
        code = lib.npt_kalman_mean_wide(
            A.data_ptr(), C.data_ptr(), Ws.data_ptr(), invLs.data_ptr(), cst.data_ptr(),
            x0s.data_ptr(), ys_t.data_ptr(), None if us_t is None else us_t.data_ptr(),
            xs_f.data_ptr(), xs_p.data_ptr(), ll.data_ptr(), work.data_ptr() if floats else None,
            N, T, n, p, torch.cuda.current_stream().cuda_stream)
        assert code == 0, f"launch refused: {code}"
        return xs_f, xs_p, ll

    return call


def check(got, args) -> tuple:
    """(held, the scaled distances of the means and of ll from plain and
    from float64, the plain version's from float64): phase 30's check."""
    plain = kalman_mean.kalman_mean_pass_reference(*args)
    f64 = kalman_mean.kalman_mean_pass_reference(*(None if x is None else x.double()
                                                   for x in args))
    hx = [cs.held_against(got[k], plain[k], f64[k], 0.0, 2e-5) for k in range(2)]
    hl = cs.held_against(got[2], plain[2], f64[2], 2e-4, 2e-3)
    held = all(h[0] for h in hx) and hl[0]
    return held, {"x": [max(h[i] for h in hx) for i in (1, 2, 3)], "ll": list(hl[1:])}


def main() -> int:
    if not torch.cuda.is_available():
        print("kalman_wide_turns: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    quick = "quick" in sys.argv[1:]
    built = build(sources([a for a in sys.argv[1:] if a != "quick"]))
    record = {"card": smi, "ptxas": {}, "checks": {}, "times_ms": {}, "plans": {}}

    def say(line: str) -> None:
        print(f"[kalman_wide_turns] {line}", flush=True)

    libs = {}
    for name, (path, log) in built.items():
        record["ptxas"][name] = [f"{e.split('::')[-1]} {t}" for e, t in cs.ptxas_lines(log)]
        if path is None:
            say(f"{name}: build failed\n{log[-4000:]}")
            continue
        libs[name] = bind(path)
        say(f"{name}: built; {record['ptxas'][name]}")
    if "before" not in libs or "current" not in libs:
        return 1
    if "stamps" in libs:  # the stamps' buffer: 8 counters a thread at N = 4096
        buf = torch.zeros((cs.N + 15) // 16 * 256 * 8, dtype=torch.int64, device=dev)
        assert libs["stamps"].probe_set_stamps(ctypes.c_void_p(buf.data_ptr())) == 0

    q = {k: torch.as_tensor(v, device=dev)
         for k, v in cs.quad_estimation(cs.N_FORMATION, cs.N, cs.T_KF).items()}
    ops = cs.kalman_mean_operands(q["A"], q["C"], q["Q"], q["R"], q["P0"], q["x0s"], q["yss"],
                                  q["B"], q["uss"])
    n, p = ops[0].shape[0], ops[1].shape[0]
    say(f"formation (n, p, N, T) = ({n}, {p}, {cs.N}, {cs.T_KF}) [{smi}]")
    forms = {"": ops[:7] + [None], " with inputs": ops}
    calls = {}
    for name, lib in libs.items():
        for what, args in forms.items():
            record["plans"][f"{name}{what}"] = divmod(
                lib.npt_kalman_mean_wide_plan(n, p, int(args[7] is not None)), 100)
            calls[name + what] = direct(lib, args, dev)
            got = calls[name + what]()
            torch.cuda.synchronize()
            held, e = check(got, args)
            record["checks"][f"{name} formation{what}"] = {**e, "held": held}
            say(f"{name} formation{what} plan {record['plans'][name + what]}: scaled x vs plain / "
                f"float64 / plain vs float64 {e['x']}, ll {e['ll']}: "
                f"{'held' if held else 'NOT HELD'}"
                f"{' (an ablation: not checked)' if name in ABLATIONS else ''}")

    order = ["before", "current", *[k for k in libs if k not in ("before", "current")],
             "current", "before"]
    for what in forms:
        times = {name: [] for name in libs}
        for _ in range(ROUNDS):
            for name in order:
                times[name].append(cs.cuda_ms(calls[name + what], reps=3, inner=5, warmup=1))
        for name, ts in times.items():
            record["times_ms"][f"{name}{what}"] = ts
            say(f"time {name} formation{what}: median {statistics.median(ts):.4f} ms of {ts} "
                f"[{smi}]")
    own = {}
    for what in forms:
        for name in ("before", "current", "current", "before"):
            us = cs.profiled_us(calls[name + what], ["kalman_wide"], 10)["kalman_wide"]
            own.setdefault(name + what, []).append(us[0])
    record["own_us"] = own
    wrapper = {what: cs.cuda_ms(lambda a=args: kalman_mean.kalman_mean_pass(*a), reps=5, inner=3)
               for what, args in forms.items()}
    record["wrapper_ms"] = wrapper
    record["bound_ms"] = {}
    for what, args in forms.items():
        cuda_ops, tf32_ops, n_bytes, fp32_all = cs.kalman_wide_ops(cs.N, cs.T_KF, n, p,
                                                                   args[7] is not None)
        record["bound_ms"][what or "no inputs"] = {
            "bytes": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
            "CUDA-core operations": cuda_ops / cs.FP32_FLOP_PER_S * 1e3,
            "TF32 tensor operations": tf32_ops / cs.TF32_TENSOR_FLOP_PER_S * 1e3,
            "all as fp32 (comparison)": fp32_all / cs.FP32_FLOP_PER_S * 1e3}
    say(f"own (torch.profiler, 10 launches, in turns): {own}; wrapper (current) {wrapper}; "
        f"bound {record['bound_ms']} [{smi}]")

    if "stamps" in libs:  # cycles a step in each part, each warp's lane 0, over the blocks
        blocks = (cs.N + 15) // 16
        calls["stamps"]()
        torch.cuda.synchronize()
        st = buf.view(blocks, 8, 32, 8)[:, :, 0, :].double() / cs.T_KF  # (block, warp, part)
        mean = st.mean(0)
        record["stamps_cycles_a_step"] = {f"warp {w}": dict(zip((*STAMP_PARTS, "all"),
                                                                mean[w].tolist()))
                                          for w in range(8)}
        for w in range(8):
            say(f"stamps warp {w}, cycles a step: "
                + ", ".join(f"{k} {v:.0f}" for k, v in zip((*STAMP_PARTS, "all"), mean[w])))
    if "scan" in sys.argv[1:]:  # before and current by T and by N: a step's cost
        for N_s, T_s in ((4096, 1), (4096, 10), (4096, 50), (2112, 50), (8192, 50)):
            q_s = {k: torch.as_tensor(v, device=dev)
                   for k, v in cs.quad_estimation(cs.N_FORMATION, N_s, T_s).items()}
            ops_s = cs.kalman_mean_operands(q_s["A"], q_s["C"], q_s["Q"], q_s["R"], q_s["P0"],
                                            q_s["x0s"], q_s["yss"])
            for name in ("before", "current", "current", "before"):
                us = cs.profiled_us(direct(libs[name], ops_s[:7] + [None], dev), ["kalman_wide"],
                                    10)["kalman_wide"][0]
                record["own_us"].setdefault(f"{name} N={N_s} T={T_s}", []).append(us)
            say(f"scan N={N_s} T={T_s}: own before {record['own_us'][f'before N={N_s} T={T_s}']}"
                f" current {record['own_us'][f'current N={N_s} T={T_s}']} us [{smi}]")
    if not quick:
        cases = [(f"formation N={cs.N_RAGGED}{what}",
                  args[:5] + [args[5][:cs.N_RAGGED], args[6][:, :cs.N_RAGGED].contiguous(),
                              None if args[7] is None else args[7][:, :cs.N_RAGGED].contiguous()])
                 for what, args in forms.items()]
        for n_e, p_e in cs.KALMAN_WIDE_EDGES:
            d = cs.random_estimation(n_e, p_e, cs.N, cs.T_KF_EDGE, seed=n_e + p_e, dev=dev)
            e_ops = cs.kalman_mean_operands(d["A"], d["C"], d["Q"], d["R"], d["P0"], d["x0s"],
                                            d["yss"], d["B"], d["uss"])
            cases += [(f"({n_e}, {p_e}) N={cs.N} T={cs.T_KF_EDGE}", e_ops[:7] + [None]),
                      (f"({n_e}, {p_e}) N={cs.N} T={cs.T_KF_EDGE} with inputs", e_ops)]
        for what, args in cases:
            lib = libs["current"]
            plan = divmod(lib.npt_kalman_mean_wide_plan(args[5].shape[1], args[6].shape[2],
                                                        int(args[7] is not None)), 100)
            held, e = check(direct(lib, args, dev)(), args)
            record["checks"][f"current {what}"] = {**e, "plan": plan, "held": held}
            say(f"current {what} plan {plan}: scaled x vs plain / float64 / plain vs float64 "
                f"{e['x']}, ll {e['ll']}: {'held' if held else 'NOT HELD'}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "results.json").write_text(json.dumps(record, indent=1))
    return 0 if all(v["held"] for k, v in record["checks"].items()
                    if k.split()[0] not in ABLATIONS) else 2


if __name__ == "__main__":
    sys.exit(main())
