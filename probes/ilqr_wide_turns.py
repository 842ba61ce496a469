#!/usr/bin/env python3
"""The wide K7 before and after its redesign for the tensor cores, in turns
on one card, with the variants of the new form that were tried.

    python probes/ilqr_wide_turns.py [quick] [variant ...]   (from the repository root)

Builds, one nvcc each, all at once, into build/probes/ilqr_wide_turns/<name>/:
  - before: probes/ilqr_backward_wide_before.cu, the form before the
    redesign (its products as fp32 FMAs; As and Bs row-major contiguous,
    so its wrapper copied the linearization's column-major Jacobians);
  - current: csrc/ilqr_backward_wide.cu as it is, csrc/tf32_mma.cuh inlined
    (the products on the tensor cores in 3xTF32, As and Bs read at their
    strides);
  - the variants named (all where none is), text substitutions into current
    (VARIANTS): threads64 / threads256 (64 or 256 threads a block at every
    shape; current picks by n + m), depth1 (one stage buffer at every
    shape: a smaller block), serial_inverse (warp 0 inverts Quu after phase
    2's barrier, as the first form did, not beside Qux and Qxx), one_acc
    (the 3xTF32 corrections into the hi*hi accumulator, not a second one),
    rna_split (the split by cvt.rna.tf32.f32, not by truncation),
    scalar_frags (the fragments by 32-bit loads, not ldmatrix), and
    ablations whose results are wrong, for the time only: single_pass (hi*hi
    alone), no_p1, no_matvec, no_p2, no_xx, no_p5 (a phase taken out:
    Y = Vxx M; Qx and Qu; M'Y; [k | K]; Vxx'), no_inverse, no_copy (no
    stage copies of A and B).

Then, at the eight-quadrotor formation's first backward pass (n = 48, m =
16, N = 4096, T = 50, the linearization's column-major Jacobians; chip_smoke
phase 29's operands): each build against the plain version (max|dks|,
max|dKs|, and whether rtol 1e-3 / atol 1e-4 holds), current's result for the
column-major views and for contiguous copies bit for bit; the CUDA-event time
of each build's direct library call, in turns (before, current, the
variants, current, before) over ROUNDS rounds; the own durations
(torch.profiler, 10 launches) of before and current; the wrappers' times: the
package's wrapper (current, no copy) and the parent's (the two contiguous
copies and the before kernel); the plain version's time. Current is also
held against the plain version and float64 at phase 29's other shapes
(ILQR_WIDE_EDGES at T_EDGE, ILQR_DEPTH1_SHAPES, ILQR_WORKSPACE_SHAPE, the
formation at N = 1003), with and without luu_diags (``quick``: the
formation only, no wrappers, no plain version). All lines go to stdout
and, as one JSON object, to build/probes/ilqr_wide_turns/results.json, with
the card's name and power limit and each build's ptxas lines.
"""

from __future__ import annotations

import collections
import ctypes
import functools
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
from numpower_tpu_torch.kernels import _build, ilqr_backward  # noqa: E402

OUT = ROOT / "build" / "probes" / "ilqr_wide_turns"
ROUNDS = 3
ENTRY_BEFORE = """
extern "C" int probe_wide(const float* As, const float* Bs, const float* lxs, const float* lus,
                          const float* luud, const float* lxx, const float* luu_reg,
                          const float* lxT, const float* lxxT, float* ks, float* Ks, int N, int n,
                          int m, int T, float* work, long long, long long, long long, long long,
                          long long, long long, long long, long long, void* stream) {
  return static_cast<int>(ilqr_bwd::launch_wide(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT,
                                                ks, Ks, N, n, m, T, work,
                                                static_cast<cudaStream_t>(stream)));
}
"""
ENTRY = """
extern "C" int probe_wide(const float* As, const float* Bs, const float* lxs, const float* lus,
                          const float* luud, const float* lxx, const float* luu_reg,
                          const float* lxT, const float* lxxT, float* ks, float* Ks, int N, int n,
                          int m, int T, float* work, long long a0, long long a1, long long a2,
                          long long a3, long long b0, long long b1, long long b2, long long b3,
                          void* stream) {
  return static_cast<int>(ilqr_bwd::launch_wide_strided(
      As, Bs, ilqr_bwd::Strides{a0, a1, a2, a3}, ilqr_bwd::Strides{b0, b1, b2, b3}, lxs, lus,
      luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, T, work, static_cast<cudaStream_t>(stream)));
}
"""
THREADS_RULE = ("return n + m <= 32 ? kWideThreadsSmall : n + m <= 64 ? kWideThreads : "
                "kWideThreadsBig;")
# text substitutions of csrc/ilqr_backward_wide.cu: (old, new) pairs
VARIANTS = {
    "threads64": [(THREADS_RULE, "return 64;")],
    "threads256": [(THREADS_RULE, "return 256;")],
    "depth1": [("for (int depth = 2; depth >= 1; --depth)",
                "for (int depth = 1; depth >= 1; --depth)")],
    "serial_inverse": [
        ("if (MB > 0 && warp == 0) {", "if (false) {"),
        ("const int w = MB > 0 ? warp - 1 : warp, ws = MB > 0 ? nw - 1 : nw;\n"
         "      for (int it = (MB > 0 ? nquu : 0) + w; it < items; it += ws) block(it);",
         "for (int it = warp; it < items; it += nw) block(it);"),
        ("    if constexpr (MB > 0) {\n      // 3. [k | K]",
         "    if constexpr (MB > 0) {\n      if (warp == 0) spd_inverse_warp<MB>(Lq, ldL, m, Qi, "
         "m16, lane);\n      __syncthreads();\n      // 3. [k | K]")],
    "one_acc": [("mma_tf32(cr[h], al, bhh);\n    mma_tf32(cr[h], ah, blh);",
                 "mma_tf32(hh[h], al, bhh);\n    mma_tf32(hh[h], ah, blh);")],
    "rna_split": [("  hi = (kRound ? x + 0x1000u : x) & 0xffffe000u;\n"
                   "  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));",
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : "
                   "\"f\"(__uint_as_float(x)));\n"
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo) : "
                   "\"f\"(__uint_as_float(x) - __uint_as_float(hi)));")],
    "scalar_frags": [("if constexpr (kKRow && kShared) {", "if constexpr (false) {")],
    "single_pass": [("mma_tf32(cr[h], al, bhh);\n    mma_tf32(cr[h], ah, blh);", "")],
    "no_p1": [("for (int it = warp; it < nb * (nb + mb); it += nw) {",
               "for (int it = warp; it < 0; it += nw) {")],
    "no_matvec": [("for (int c = tid; c < n + m; c += nt) {",
                   "for (int c = tid; c < 0; c += nt) {")],
    "no_p2": [("auto block = [&](int it) {",
               "auto block = [&](int it) {\n      if (it >= 0) return;")],
    "no_xx": [("for (int it = warp; it < mb * ncb; it += nw) {",
               "for (int it = warp; it < 0; it += nw) {")],
    "no_p5": [("for (int it = warp; it < nb * (nb + 1) / 2; it += nw) {",
               "for (int it = warp; it < 0; it += nw) {")],
    "no_inverse": [("if constexpr (MB > 0) spd_inverse_warp<MB>(Lq, ldL, m, Qi, m16, lane);", "")],
    "no_copy": [("    copy_columns<kShared>(buf, ld, As",
                 "    if (false) copy_columns<kShared>(buf, ld, As"),
                ("    copy_columns<kShared>(buf + bslot * ld, ld, Bs",
                 "    if (false) copy_columns<kShared>(buf + bslot * ld, ld, Bs")],
}
# ablations: their results are not checked
WRONG = ("single_pass", "no_p1", "no_matvec", "no_p2", "no_xx", "no_p5", "no_inverse", "no_copy")


def sources(names) -> dict:
    # the shared TF32 helpers inlined, so that a variant may change them too
    src = (_build.CSRC / "ilqr_backward_wide.cu").read_text().replace(
        '#include "tf32_mma.cuh"', (_build.CSRC / "tf32_mma.cuh").read_text())
    out = {"before": (ROOT / "probes" / "ilqr_backward_wide_before.cu").read_text() + ENTRY_BEFORE,
           "current": src + ENTRY}
    for name, subs in VARIANTS.items():
        if names and name not in names:
            continue
        text = src
        for old, new in subs:
            assert old in text, f"csrc/ilqr_backward_wide.cu no longer has {old!r}"
            text = text.replace(old, new)
        out[name] = text + ENTRY
    return out


def build(texts: dict) -> dict:
    """{name: (library path or None, build log)}, built side by side."""
    nvcc, procs = _build._nvcc(), {}
    for name, text in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wide.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "wide.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    return {name: (OUT / name / "lib.so" if proc.returncode == 0 else None, log)
            for name, proc in procs.items() for log in [proc.communicate()[0]]}


def formation_ops(dev):
    """Phase 29's operands of the formation's first backward pass: As and Bs
    the linearization's column-major views."""
    from numpower_tpu_torch.models import linearize_trajectory, rollout_nonlinear

    f, Q, R, QF, goal, x0s = (x if callable(x) else torch.as_tensor(x, device=dev)
                              for x in cs.quad_formation(cs.N_QUADS, cs.N))
    T, m = cs.T_QUADS, R.shape[0]
    us0 = torch.full((cs.N, T, m), cs.HOVER_THRUST, device=dev)
    xs0 = rollout_nonlinear(f, x0s, us0)
    As, Bs = linearize_trajectory(f, xs0, us0)
    return [As, Bs, 2.0 * (xs0[:, :T] - goal) @ Q.T, 2.0 * us0 @ R.T, 2.0 * Q, 2.0 * R,
            2.0 * (xs0[:, T] - goal) @ QF.T, 2.0 * QF]


def main() -> int:
    if not torch.cuda.is_available():
        print("ilqr_wide_turns: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    quick = "quick" in sys.argv[1:]
    built = build(sources([a for a in sys.argv[1:] if a != "quick"]))
    record = {"card": smi, "ptxas": {}, "checks": {}, "times_ms": {}}

    def say(line: str) -> None:
        print(f"[ilqr_wide_turns] {line}", flush=True)

    libs = {}
    for name, (path, log) in built.items():
        record["ptxas"][name] = [f"{e.split('::')[-1]} {t}" for e, t in cs.ptxas_lines(log)]
        if path is None:
            say(f"{name}: build failed\n{log[-4000:]}")
            continue
        lib = ctypes.CDLL(str(path))
        lib.probe_wide.argtypes = _build._SIGNATURES["npt_ilqr_backward_wide"]
        lib.probe_wide.restype = ctypes.c_int
        lib.npt_ilqr_backward_workspace.argtypes = (ctypes.c_int,) * 3
        lib.npt_ilqr_backward_workspace.restype = ctypes.c_longlong
        libs[name] = lib
        say(f"{name}: built; {record['ptxas'][name]}")
        if name in ("before", "current", "rna_split"):
            ops = collections.Counter()
            for fn, body in cs.sass_by_kernel(path).items():
                if "backward_wide_kernel<true, 16>" in fn:
                    for line in body:
                        code = (line.split("*/", 1)[1].split()
                                if line.lstrip().startswith("/*") else [])
                        code = code[1:] if code and code[0].startswith("@") else code
                        if code:
                            ops[code[0].split(".")[0]] += 1
            record.setdefault("sass", {})[name] = dict(ops.most_common(30))
            say(f"{name} SASS of backward_wide_kernel<true, 16>: {dict(ops.most_common(30))}")
    if "before" not in libs or "current" not in libs:
        return 1

    def direct(lib, ops, diags=None):
        """A direct library call of `lib` on ops (K7's operands), its outputs
        allocated once: (call, ks, Ks)."""
        As, Bs, lxs, lus, lxx, luu, lxT, lxxT = ops
        N, T, n = As.shape[:3]
        m = Bs.shape[-1]
        luu_reg = (luu + 1e-3 * torch.eye(m, device=dev)).contiguous()
        rest = [x.contiguous() for x in (lxs, lus)]
        tail = [x.contiguous() for x in (lxx, luu_reg, lxT, lxxT)]
        ks = torch.empty((N, T, m), device=dev)
        Ks = torch.empty((N, T, m, n), device=dev)
        floats = lib.npt_ilqr_backward_workspace(N, n, m)
        work = torch.empty(max(floats, 1), device=dev)
        strides = (*As.stride(), *Bs.stride())

        def call():
            code = lib.probe_wide(As.data_ptr(), Bs.data_ptr(), *(x.data_ptr() for x in rest),
                                  None if diags is None else diags.data_ptr(),
                                  *(x.data_ptr() for x in tail), ks.data_ptr(), Ks.data_ptr(),
                                  N, n, m, T, work.data_ptr() if floats else None, *strides,
                                  torch.cuda.current_stream().cuda_stream)
            assert code == 0, f"launch refused: {code}"
            return ks, Ks

        return call

    form = formation_ops(dev)
    form_c = [x.contiguous() for x in form[:2]] + form[2:]
    n, m = form[0].shape[-1], form[1].shape[-1]
    say(f"formation (n, m, N, T) = ({n}, {m}, {cs.N}, {cs.T_QUADS}); As strides "
        f"{form[0].stride()}, Bs strides {form[1].stride()} [{smi}]")
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*form, reg=1e-3)
    calls = {}
    for name, lib in libs.items():
        calls[name] = direct(lib, form_c if name == "before" else form)
        ks, Ks = calls[name]()
        torch.cuda.synchronize()
        dk, dK = cs.max_err(ks, ks_p), cs.max_err(Ks, Ks_p)
        held = cs.close(ks, ks_p, 1e-3, 1e-4) and cs.close(Ks, Ks_p, 1e-3, 1e-4)
        record["checks"][f"{name} formation"] = {"dks": dk, "dKs": dK, "held": held}
        say(f"{name} formation vs plain: max|dks| {dk:.3e} max|dKs| {dK:.3e} "
            f"(|Ks| {Ks_p.abs().max().item():.3e}): {'held' if held else 'NOT HELD'}"
            f"{' (an ablation: not checked)' if name in WRONG else ''}")
    ks1, Ks1 = (x.clone() for x in calls["current"]())
    ks2, Ks2 = direct(libs["current"], form_c)()
    same = bool(torch.equal(ks1, ks2) and torch.equal(Ks1, Ks2))
    record["checks"]["current column-major == contiguous"] = same
    say(f"current: column-major views and contiguous copies bit for bit: {same}")

    # phase 29's other shapes, current only
    shapes = [] if quick else [("formation N=1003", [x[:cs.N_RAGGED] if i in (0, 1, 2, 3, 6) else x
                                   for i, x in enumerate(form)], None)]
    for n_e, m_e in () if quick else cs.ILQR_WIDE_EDGES:
        ops, d = cs.random_ltv(cs.N, cs.T_EDGE, n_e, m_e, dev, seed=n_e * 10 + m_e)
        shapes.append((f"({n_e}, {m_e}) N={cs.N} T={cs.T_EDGE}", list(ops), d))
    for n_e, m_e, N_e, T_e in () if quick else cs.ILQR_DEPTH1_SHAPES:
        ops, d = cs.random_ltv(N_e, T_e, n_e, m_e, dev, seed=n_e * 10 + m_e)
        shapes.append((f"({n_e}, {m_e}) N={N_e} T={T_e}", list(ops), d))
    n_w, m_w, N_w, T_w = cs.ILQR_WORKSPACE_SHAPE
    if not quick:
        ops, d = cs.random_ltv(N_w, T_w, n_w, m_w, dev, seed=7)
        shapes.append((f"({n_w}, {m_w}) N={N_w} T={T_w} workspace", list(ops), d))
    for what, ops, d in shapes:
        for diags in ((None,) if d is None else (None, d)):
            ks, Ks = direct(libs["current"], ops, diags)()
            ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*ops, reg=1e-3, luu_diags=diags)
            ops64 = [x.double() for x in ops]
            ks_64, Ks_64 = ilqr_backward.ilqr_backward_reference(
                *ops64, reg=1e-3, luu_diags=None if diags is None else diags.double())
            e_k = max(cs.scaled_err(ks, ks_64, 1e-3, 1e-4), cs.scaled_err(Ks, Ks_64, 1e-3, 1e-4))
            e_p = max(cs.scaled_err(ks_p, ks_64, 1e-3, 1e-4),
                      cs.scaled_err(Ks_p, Ks_64, 1e-3, 1e-4))
            held = (cs.close(ks, ks_p, 1e-3, 1e-4) and cs.close(Ks, Ks_p, 1e-3, 1e-4)
                    and e_k <= max(1.0, 4 * e_p))
            label = f"current {what}{' luu_diags' if diags is not None else ''}"
            record["checks"][label] = {"dks": cs.max_err(ks, ks_p), "dKs": cs.max_err(Ks, Ks_p),
                                       "f64_scaled": e_k, "plain_f64_scaled": e_p, "held": held}
            say(f"{label}: max|dks| {cs.max_err(ks, ks_p):.3e} max|dKs| "
                f"{cs.max_err(Ks, Ks_p):.3e} vs plain; vs float64 scaled {e_k:.3e} (plain "
                f"{e_p:.3e}): {'held' if held else 'NOT HELD'}")

    # times at the formation, in turns
    order = ["before", "current", *[k for k in libs if k not in ("before", "current")],
             "current", "before"]
    times = {name: [] for name in libs}
    for _ in range(ROUNDS):
        for name in order:
            times[name].append(cs.cuda_ms(calls[name], reps=3, inner=3, warmup=1))
    for name, ts in times.items():
        record["times_ms"][name] = ts
        say(f"time {name} formation: median {statistics.median(ts):.4f} ms of {ts} [{smi}]")
    own = {}
    for name in ("before", "current", "current", "before"):
        us = cs.profiled_us(calls[name], ["backward_wide_kernel"], 10)["backward_wide_kernel"]
        own.setdefault(name, []).append(us[0])
    record["own_us"] = own
    say(f"own (torch.profiler, 10 launches, in turns): {own} [{smi}]")

    def parent_wrapper():
        As, Bs = form[0].contiguous(), form[1].contiguous()
        return calls["before"]() + (As, Bs)

    if quick:
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "results.json").write_text(json.dumps(record, indent=1))
        return 0
    wrap = functools.partial(ilqr_backward.ilqr_backward_fused, *form, reg=1e-3)
    wr = {"package (current)": [], "parent (copies + before)": []}
    for _ in range(ROUNDS):
        wr["package (current)"].append(cs.cuda_ms(wrap, reps=3, inner=3, warmup=1))
        wr["parent (copies + before)"].append(cs.cuda_ms(parent_wrapper, reps=3, inner=3,
                                                         warmup=1))
    record["wrapper_ms"] = wr
    say(f"wrappers: {wr} [{smi}]")
    plain = cs.cuda_ms(lambda: ilqr_backward.ilqr_backward_reference(*form, reg=1e-3), reps=3,
                       inner=1, warmup=1)
    record["plain_ms"] = plain
    ops_k7, bytes_k7 = cs.ilqr_backward_work(cs.N, cs.T_QUADS, n, m)
    cuda_k7, tf32_k7 = cs.ilqr_backward_wide_ops(cs.N, cs.T_QUADS, n, m)
    record["bound_ms"] = {"bytes": bytes_k7 / cs.HBM_BYTES_PER_S * 1e3,
                          "CUDA-core operations": cuda_k7 / cs.FP32_FLOP_PER_S * 1e3,
                          "TF32 tensor operations": tf32_k7 / cs.TF32_TENSOR_FLOP_PER_S * 1e3,
                          "all as fp32 (comparison)": ops_k7 / cs.FP32_FLOP_PER_S * 1e3}
    say(f"plain {plain:.4f} ms; bound {record['bound_ms']} [{smi}]")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "results.json").write_text(json.dumps(record, indent=1))
    return 0 if all(v["held"] for k, v in record["checks"].items()
                    if isinstance(v, dict) and not any(w in k for w in WRONG)) else 2


if __name__ == "__main__":
    sys.exit(main())
