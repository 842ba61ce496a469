#!/usr/bin/env python3
"""The wide box-QP tile (csrc/boxqp_tile.cuh, WideTile) before and after
its serialization fix, in turns on one card, with the variants and
ablations that were tried.

    python probes/boxqp_wide_turns.py [quick] [at=LABEL] [k=K2,K1] [variant ...]
    (from the repository root)

Builds, side by side, into build/probes/boxqp_wide_turns/<name>/, a small
library of csrc/boxqp_fista.cu, csrc/boxqp_admm.cu and csrc/status.cu each
(a build whose sources are unchanged is reused):
  - before: with probes/boxqp_tile_before.cuh as boxqp_tile.cuh (the tile
    before the fix: a warpgroup whose rows were all past d skipped its
    passes, and that branch made ptxas serialize every wgmma);
  - current: with csrc/boxqp_tile.cuh as it is;
  - multicast: probes/boxqp_tile_multicast.cuh, two tiles a cluster sharing
    A's slabs by multicast bulk copies, its handshake on thread 0;
  - the variants named (all where none is), text substitutions into the
    current tile or the multicast one (VARIANTS): own_first (in a cluster of
    four or more CTAs, CTA r walks K from slab 2r, its own slice of B
    first, and wraps around, so that the CTAs do not all read one owner's B
    at once), own_last (from slab 2r + 2, its own slice last), own_last_all
    (that at every cluster size), own_last_sums (own_last, each slab summed
    in accumulators of its own, added to a rounded fp32 total);
    parent_order (slab s + 1 loaded before slab s's passes are issued, each
    slab's passes waited for at once: the parent's loop without its
    branch), no_pipeline (slab s + 1 loaded once slab s's passes are done);
    the ablations no_a_stream (A's panel loaded for a product's first slab
    only: the L2 stream gone, results wrong), local_b (B's slab from this
    CTA's own buffer, not a peer's: results wrong) and one_pass (the
    correction passes dropped, the loads kept: results wrong); mc_asmwait
    (the multicast tile's mbarrier wait as one PTX loop), mc_pred (that, and
    its handshake on every thread, the copies and arrivals predicated on
    thread 0 in PTX, no branch) and mc_pred_late (that, the handshake after
    the slab's passes are issued).
``at=`` keeps the shapes whose label holds LABEL (e.g. ``at=d = 400``),
``k=`` the kernels named.
The package's wrappers run on each library in turn (kernels._build.library
pointed at it), so every build sees the same operands: K2 and K1 (the fused
kernels with residuals, "highest", the default schedules, warm), K2' and K1'
(g formed in the kernel, no residuals, cold), K3b and K3a (the two-step
ones, at config #4's plant only) at config #4's plant (quadrotor12(0.02), Q = I, R = 0.1
I, QF = 5 I) at T = 33, 100 and 256 (d = 132, 400, 1024; chip_smoke phase
27) and K2, K1 at the four-quadrotor formation's MPC at T = 20 and 30 (n =
48, d = 320, 480; phase 31), N = 4096, 40 iterations; ``quick`` times
before and current only (no variants) in one round. For each: the SHA-256
prefix of the outputs of every build (current against before: the same bits,
or not), the largest difference from before, the CUDA-event time of the
wrapper in turns (before, current, the variants, current, before) over
ROUNDS rounds, and the own durations (torch.profiler, 10 launches) of before
and current. All lines go to stdout and, as one JSON object, to
build/probes/boxqp_wide_turns/results-<variants>.json, with the card's name and power limit,
cudaOccupancyMaxActiveClusters of each build at each d, and the ptxas lines.
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista  # noqa: E402
from numpower_tpu_torch.models import condense, quadrotor12  # noqa: E402
from numpower_tpu_torch.models.condensed import (  # noqa: E402
    admm_coarse_iters, default_coarse_iters,
)

OUT = ROOT / "build" / "probes" / "boxqp_wide_turns"
ROUNDS, ITERS = 3, 40
ENTRIES = [name for name in _build._SIGNATURES if "fista" in name or "admm" in name
           or name == "npt_boxqp_wide_clusters"]
# the current slab loop's head and tail (slab s's passes issued before slab
# s + 1 is loaded), and the parent's order (slab s + 1 loaded before slab s's
# passes are issued, each slab's passes waited for at once)
_WAIT = r'''      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operand(hh);
      fence_operand(corr);
'''
_HEAD = _WAIT + r'''      asm volatile("cp.async.wait_all;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // slab s staged; every pass of slab s - 1 done
'''
_COMMIT = '      asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");\n'
_LOAD_NEXT = "      if (s + 1 < slabs) load_slab<kParts>(s + 1, stage ^ 1, buf);\n"
_TAIL = _COMMIT + _LOAD_NEXT + "    }\n" + _WAIT.replace("      ", "    ")
_PARENT_HEAD = r'''      asm volatile("cp.async.wait_all;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // slab s staged; slab s - 1's passes done (waited below)
'''
_PARENT_ORDER = [(_HEAD, _PARENT_HEAD + _LOAD_NEXT), (_TAIL, _COMMIT + _WAIT + "    }\n")]
_NO_PIPELINE = [(_HEAD, _PARENT_HEAD), (_TAIL, _COMMIT + _WAIT + _LOAD_NEXT + "    }\n")]


def _rotate(turn: str) -> list:
    # CTA rank of a cluster walks K from slab `turn` and wraps around
    return [("    load_slab<kParts>(0, 0, buf);\n",
             f"    const int turn = {turn};\n    load_slab<kParts>(turn, 0, buf);\n"),
            ("      const int stage = s & 1;\n",
             "      const int stage = s & 1, slab = (s + turn) % slabs;\n"),
            ("      const int steps = min(4, ksteps - 4 * s);\n",
             "      const int steps = min(4, ksteps - 4 * slab);\n"),
            ("load_slab<kParts>(s + 1, stage ^ 1, buf)",
             "load_slab<kParts>((s + 1 + turn) % slabs, stage ^ 1, buf)")]


# each slab summed in accumulators of its own, added to a rounded fp32 total
_SLAB_SUMS = [
    ("    float hh[16], corr[16];\n#pragma unroll\n    for (int r = 0; r < 16; ++r) hh[r] = corr[r] = 0.0f;\n",
     "    float hh[16], corr[16], sum[16];\n#pragma unroll\n"
     "    for (int r = 0; r < 16; ++r) hh[r] = corr[r] = sum[r] = 0.0f;\n"),
    ('      fence_operand(corr);\n      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n',
     "      fence_operand(corr);\n#pragma unroll\n"
     "      for (int r = 0; r < 16; ++r) {  // slab s - 1's sums into the total, rounded\n"
     "        sum[r] += kPasses == 1 ? hh[r] : hh[r] + corr[r];\n"
     "        hh[r] = corr[r] = 0.0f;\n      }\n"
     '      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'),
    ("    for (int r = 0; r < 16; ++r) out[r] = kPasses == 1 ? hh[r] : hh[r] + corr[r];\n  }\n\n  // Publish",
     "    for (int r = 0; r < 16; ++r) out[r] = sum[r] + (kPasses == 1 ? hh[r] : hh[r] + corr[r]);\n"
     "  }\n\n  // Publish")]
# the multicast tile's mbarrier wait as one PTX loop (a bounded spin that traps)
_MC_WAIT = [(r'''  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spins > (1ll << 26)) __trap();
  }
''', r'''  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 c;\nmov.u32 c, 0;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "add.u32 c, c, 1;\n"
      "setp.gt.u32 p, c, 67108864;\n"
      "@p trap;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
''')]
# every thread takes the handshake; the arrivals and copies predicated on
# thread 0 inside the PTX, so the slab loop has no thread-dependent branch
_MC_PRED = _MC_WAIT + [
    (r'''  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(peer)
               : "memory");''',
     r'''  asm volatile(
      "{\n.reg .pred q;\nsetp.eq.u32 q, %1, 0;\n"
      "@q mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n}\n" ::"r"(peer),
      "r"(threadIdx.x)
      : "memory");'''),
    (r'''    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(full + stage)),
                 "r"(static_cast<uint32_t>(kParts * kASlabElems * sizeof(__nv_bfloat16)))
                 : "memory");''',
     r'''    asm volatile(
        "{\n.reg .pred q;\nsetp.eq.u32 q, %2, 0;\n"
        "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
            smem_u32(full + stage)),
        "r"(static_cast<uint32_t>(kParts * kASlabElems * sizeof(__nv_bfloat16))),
        "r"(threadIdx.x)
        : "memory");'''),
    (r'''            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
            " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
            "l"(src), "r"(bytes), "r"(smem_u32(full + stage)), "h"(mask)
            : "memory");''',
     r'''            "{\n.reg .pred q;\nsetp.eq.u32 q, %5, 0;\n"
            "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
            " [%0], [%1], %2, [%3], %4;\n}\n" ::"r"(smem_u32(dst)),
            "l"(src), "r"(bytes), "r"(smem_u32(full + stage)), "h"(mask), "r"(threadIdx.x)
            : "memory");'''),
    (r'''            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(full + stage))
            : "memory");''',
     r'''            "{\n.reg .pred q;\nsetp.eq.u32 q, %4, 0;\n"
            "@q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n}\n"
            ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(full + stage)),
            "r"(threadIdx.x)
            : "memory");'''),
    ("    if (threadIdx.x == 0) produce<kParts>(0);\n", "    produce<kParts>(0);\n"),
    ("    if (threadIdx.x == 0) release(first + slabs - 1);\n",
     "    release(first + slabs - 1);\n"),
]
_MC_HANDSHAKE = r'''      if (threadIdx.x == 0) {
        if (s > 0) release(u - 1);
        if (s + 1 < slabs) produce<kParts>(s + 1);
      }
'''
_MC_HANDSHAKE_ALL = r'''      if (s > 0) release(u - 1);
      if (s + 1 < slabs) produce<kParts>(s + 1);
'''
_MC_COMMIT = r'''      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (s + 1 < slabs) load_b<kParts>(s + 1, stage ^ 1, buf);
'''
# name: (the tile substituted, its (old, new) pairs)
VARIANTS = {
    "own_first": ("current", _rotate("ctas >= 4 ? 2 * rank : 0")),
    "own_last": ("current", _rotate("ctas >= 4 ? (2 * rank + 2) % slabs : 0")),
    "own_last_all": ("current", _rotate("(2 * rank + 2) % slabs")),
    "own_last_sums": ("current", _rotate("ctas >= 4 ? (2 * rank + 2) % slabs : 0") + _SLAB_SUMS),
    "parent_order": ("current", _PARENT_ORDER),
    "no_pipeline": ("current", _NO_PIPELINE),
    "no_a_stream": ("current", [("        cp_async16(dst + at, src + at);",
                                 "        if (slab == 0) cp_async16(dst + at, src + at);")]),
    "local_b": ("current", [("      const uint4 v = load_peer(src + 8 * t, owner);",
                             "      const uint4 v = *reinterpret_cast<const uint4*>(src + 8 * t);"
                             "\n      (void)owner;")]),
    "one_pass": ("current", [
        ("        if constexpr (kPasses >= 3) {", "        if constexpr (false) {"),
        ("        if constexpr (kPasses == 6) {", "        if constexpr (false) {"),
        ("        if constexpr (kPasses >= 4) wgmma_m64n32k16(corr, am + da, bm + db);\n", "")]),
    "mc_asmwait": ("multicast", _MC_WAIT),
    "mc_pred": ("multicast", _MC_PRED + [(_MC_HANDSHAKE, _MC_HANDSHAKE_ALL)]),
    "mc_pred_late": ("multicast", _MC_PRED + [(_MC_HANDSHAKE, ""),
                                              (_MC_COMMIT, _MC_COMMIT.replace(
                                                  "      if (s + 1 < slabs) load_b",
                                                  _MC_HANDSHAKE_ALL + "      if (s + 1 < slabs) load_b"))]),
}


def build(names) -> dict:
    """{name: (library path or None, build log)}, built side by side."""
    bases = {"current": (_build.CSRC / "boxqp_tile.cuh").read_text(),
             "multicast": (ROOT / "probes" / "boxqp_tile_multicast.cuh").read_text()}
    headers = {"before": (ROOT / "probes" / "boxqp_tile_before.cuh").read_text(),
               "current": bases["current"]}
    if not names or "multicast" in names:
        headers["multicast"] = bases["multicast"]
    for name, (base, subs) in VARIANTS.items():
        if names and name not in names:
            continue
        text = bases[base]
        for old, new in subs:
            assert text.count(old) == 1, f"the {base} tile has not one {old!r}"
            text = text.replace(old, new)
        headers[name] = text
    nvcc, procs, built = _build._nvcc(), {}, {}
    for name, header in headers.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        sources = {src: (_build.CSRC / src).read_text()
                   for src in ("boxqp_fista.cu", "boxqp_admm.cu", "status.cu", "async_copy.cuh")}
        sources["boxqp_tile.cuh"] = header
        if (d / "lib.so").is_file() and (d / "build.log").is_file() and all(
                (d / src).is_file() and (d / src).read_text() == text
                for src, text in sources.items()):
            built[name] = (d / "lib.so", (d / "build.log").read_text())  # built by an earlier run
            continue
        (d / "lib.so").unlink(missing_ok=True)
        for src, text in sources.items():
            (d / src).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               *(str(d / s) for s in ("boxqp_fista.cu", "boxqp_admm.cu", "status.cu"))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (OUT / name / "build.log").write_text(log)
        built[name] = (OUT / name / "lib.so" if proc.returncode == 0 else None, log)
    return built


class Library:
    """The box-QP entries of one build, as kernels._build.library() gives them."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            setattr(self, name, fn)
        lib.npt_error_string.argtypes = (ctypes.c_int,)
        lib.npt_error_string.restype = ctypes.c_char_p
        self.npt_error_string = lib.npt_error_string


def cases(dev) -> dict:
    """{label: (d, {kernel: call})}: the wrappers' calls at each shape."""
    rng = np.random.default_rng(23)
    Aq, Bq = quadrotor12(0.02)
    plants = {f"config #4 T = {T}": (Aq, Bq, np.eye(12), 0.1 * np.eye(4), 5.0 * np.eye(12), T)
              for T in (33, 100, 256)}
    A, B, Q, R, QF = cs.formation_mpc(cs.N_FORMATION)
    plants.update({f"formation T = {T}": (A, B, Q, R, QF, T) for T in cs.T_FORM_MPC})
    out = {}
    for label, (A_, B_, Q_, R_, QF_, T) in plants.items():
        qp = condense(A_, B_, Q_, R_, QF_, T, device=dev)
        n, d = A_.shape[0], qp.H.shape[0]
        x0s = torch.as_tensor(0.3 * rng.standard_normal((cs.N, n)), dtype=torch.float32,
                              device=dev)
        U0 = torch.as_tensor(np.clip(0.5 * rng.standard_normal((cs.N, d)), cs.LO, cs.HI),
                             dtype=torch.float32, device=dev)
        g = torch.as_tensor(rng.standard_normal((cs.N, d)), dtype=torch.float32, device=dev)
        rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
        Minv = boxqp_admm.minv_factor(qp.H, rho)
        ci_f, ci_a = default_coarse_iters(qp, ITERS), admm_coarse_iters(qp, ITERS)
        fold = (qp.H, qp.Sx.T, qp.SuTQ.T, x0s, cs.LO, cs.HI)
        calls = {
            "K2": lambda fold=fold, qp=qp, ci_f=ci_f, U0=U0: boxqp_fista._fista_mpc_res(
                *fold, qp.lipschitz, ITERS, ci_f, U0, "highest", "highest", None),
            "K1": lambda fold=fold, rho=rho, ci_a=ci_a, Minv=Minv, U0=U0: boxqp_admm._admm_mpc_res(
                *fold, rho, ITERS, ci_a, 1.6, Minv, U0, "s", "highest", None),
        }
        calls["K2'"] = lambda fold=fold, qp=qp, ci_f=ci_f: boxqp_fista.fista_mpc(
            *fold, qp.lipschitz, ITERS, ci_f)
        calls["K1'"] = lambda fold=fold, rho=rho, ci_a=ci_a, Minv=Minv: boxqp_admm.admm_mpc(
            *fold, rho, ITERS, ci_a, Minv=Minv)
        if label.startswith("config"):
            calls["K3b"] = lambda qp=qp, g=g, ci_f=ci_f: boxqp_fista.fista_boxqp(
                qp.H, g, cs.LO, cs.HI, qp.lipschitz, ITERS, ci_f)
            calls["K3a"] = lambda qp=qp, g=g, rho=rho, ci_a=ci_a: boxqp_admm.admm_boxqp(
                qp.H, g, cs.LO, cs.HI, rho, ITERS, ci_a)
        out[f"{label} (n = {n}, d = {d})"] = (n, d, calls)
    return out


def digest(result) -> str:
    h = hashlib.sha256()
    for r in (result if isinstance(result, (tuple, list)) else (result,)):
        h.update(r.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    if not torch.cuda.is_available():
        print("boxqp_wide_turns: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)

    def say(line: str) -> None:
        print(f"[boxqp_wide_turns] {line}", flush=True)

    record = {"card": smi, "ptxas": {}, "cases": {}}
    libs = {}
    args = sys.argv[1:]
    quick = "quick" in args
    at = [a[3:] for a in args if a.startswith("at=")]
    only = [k for a in args if a.startswith("k=") for k in a[2:].split(",")]
    names = [a for a in args if a != "quick" and "=" not in a]
    for name, (path, log) in build(names or (["none"] if quick else [])).items():
        record["ptxas"][name] = [f"{e} {t}" for e, t in cs.ptxas_lines(log)
                                 if "WideTile" in e]
        serial = [line for line in log.splitlines() if "C7520" in line and "WideTile" in line]
        record.setdefault("serialized_wide_instances", {})[name] = len(serial)
        if path is None:
            say(f"{name}: build failed\n{log[-4000:]}")
            continue
        libs[name] = Library(path)
        say(f"{name}: built; wide instances whose wgmma ptxas serialized (C7520): "
            f"{len(serial)}; {record['ptxas'][name]}")
    if "before" not in libs or "current" not in libs:
        return 1
    package_library = _build.library
    use = {"lib": None}
    _build.library = lambda: use["lib"]
    try:
        for label, (n, d, calls) in cases(dev).items():
            if at and not any(a in label for a in at):
                continue
            row = record["cases"][label] = {}
            for name, lib in libs.items():
                row.setdefault("clusters", {})[name] = lib.npt_boxqp_wide_clusters(n, d)
            for kernel, call in calls.items():
                if only and kernel not in only:
                    continue
                res = {}
                for name, lib in libs.items():
                    use["lib"] = lib
                    out = call()
                    torch.cuda.synchronize()
                    res[name] = ([x.clone() for x in out] if isinstance(out, tuple) else
                                 [out.clone()])
                entry = row[kernel] = {"sha256": {k: digest(v) for k, v in res.items()}}
                entry["max_diff_vs_before"] = {
                    k: max(cs.max_err(a, b) for a, b in zip(v, res["before"]))
                    for k, v in res.items()}
                order = ["before", "current", *[k for k in libs if k not in ("before", "current")],
                         "current", "before"]
                times = {k: [] for k in libs}
                for _ in range(1 if quick else ROUNDS):
                    for name in order:
                        use["lib"] = libs[name]
                        times[name].append(cs.cuda_ms(call, reps=3, inner=2, warmup=1))
                entry["wrapper_ms"] = times
                kern = "fista_kernel" if kernel in ("K2", "K3b", "K2'") else "admm_kernel"
                own = {}
                for name in order:
                    use["lib"] = libs[name]
                    own.setdefault(name, []).append(cs.profiled_us(call, [kern], 10)[kern][0])
                entry["own_us"] = own
                say(f"{label} {kernel}: sha256 {entry['sha256']}, max|d| vs before "
                    f"{entry['max_diff_vs_before']}; wrapper ms (median) "
                    f"{ {k: round(statistics.median(v), 4) for k, v in times.items()} }; own us "
                    f"{own}; clusters {row['clusters']} [{smi}]")
    finally:
        _build.library = package_library
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"results-{'-'.join(names) or 'all'}.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
