#!/usr/bin/env python3
"""Where the first form of the wide K7 (probes/ilqr_backward_wide_before.cu,
csrc/ilqr_backward_wide.cu before its redesign for the tensor cores; the
redesigned form's variants are in probes/ilqr_wide_turns.py) spends its
time on the card, and what its choices gained.

    python probes/ilqr_wide_variants.py [variant ...]   (from the repository root)

Builds the variants named (all where none is), one nvcc each, all at once,
into build/probes/ilqr_wide/<variant>/:
  - current: probes/ilqr_backward_wide_before.cu as it is;
  - threads64 / threads128 / threads256: current with 64, 128 or 256
    threads a block at every shape (current picks by n + m);
  - mb32_only: the warp's register inverse of Quu in its MB = 32 instance
    for every m <= 32 (current picks MB = 8, 16 or 32 by m);
  - ablations of current, one part taken out (the results are then wrong;
    only the time is read): no_p1 ([W | W2] = Vxx M, Qx, Qu), no_p2 (M'[W |
    W2]), no_factor (phases 3-4: the warp's inverse of Quu and the product
    with it, or the block's factor and both substitutions), no_p5
    (Vx', Vxx'), no_copy (the stage copies).
Each is called directly (an appended C entry over its launch_wide) on random
LTV problems (chip_smoke.random_ltv): (48, 16) at N = 4096, T = 50 (the
eight-quadrotor formation's shape), (48, 48) and (64, 32) at T = 8, (17, 1)
and (4, 12) at T = 50, (96, 48) and (100, 32) at N = 1003, T = 8 (one
shared-memory stage buffer), and (128, 64) at N = 64, T = 4 (the workspace
form); the probe prints each one's CUDA-event time (median of 5 windows of 2
calls), the largest difference of current's and mb32_only's gains from the
package's wrapper, and the ptxas lines, with the card's name and power
limit. The times of the kernel's first form (Quu factored a thread a row,
a thread a column substituting) are in PERF.md, section 6.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import _build, ilqr_backward  # noqa: E402

OUT = ROOT / "build" / "probes" / "ilqr_wide"
SHAPES = ((48, 16, 4096, 50), (48, 48, 4096, 8), (64, 32, 4096, 8), (17, 1, 4096, 50),
          (4, 12, 4096, 50), (96, 48, 1003, 8), (100, 32, 1003, 8), (128, 64, 64, 4))
# text substitutions of csrc/ilqr_backward_wide.cu: (old, new) pairs
ABLATIONS = {
    "threads64": [("return n + m <= 32 ? kWideThreadsSmall : n + m <= 64 ? kWideThreads : "
                   "kWideThreadsBig;", "return 64;")],
    "threads128": [("return n + m <= 32 ? kWideThreadsSmall : n + m <= 64 ? kWideThreads : "
                    "kWideThreadsBig;", "return 128;")],
    "threads256": [("return n + m <= 32 ? kWideThreadsSmall : n + m <= 64 ? kWideThreads : "
                    "kWideThreadsBig;", "return 256;")],
    "mb32_only": [("if (m <= 8)\n    return launch_wide_mb<8>", "if (false)\n    return launch_wide_mb<8>"),
                  ("if (m <= 16)\n    return launch_wide_mb<16>",
                   "if (false)\n    return launch_wide_mb<16>")],
    "no_p1": [("it < pairs * tilesV; it += nt", "it < 0; it += nt"),
              ("for (int c = tid; c < nm; c += nt) {", "for (int c = tid; c < 0; c += nt) {")],
    "no_p2": [("it < itemsA + pairsB * tilesB; it += nt", "it < 0; it += nt")],
    "no_factor": [("for (int j = 0; j < m; ++j) {\n      const float inv",
                   "for (int j = 0; j < 0; ++j) {\n      const float inv"),
                  ("for (int a = m - 1; a >= 0; --a) {", "for (int a = -1; a >= 0; --a) {"),
                  ("if (warp == 0) spd_inverse_warp<MB>(", "if (false) spd_inverse_warp<MB>("),
                  ("it < nc * tilesQ; it += nt", "it < 0; it += nt")],
    "no_p5": [("it < n * tilesV; it += nt", "it < 0; it += nt")],
    "no_copy": [("    copy_rows<kShared>(buf, ldM, As", "    if (false) copy_rows<kShared>(buf, ldM, As"),
                ("    copy_rows<kShared>(buf + nA, ldM, Bs",
                 "    if (false) copy_rows<kShared>(buf + nA, ldM, Bs")],
}
ENTRY = """
extern "C" int probe_wide(const float* As, const float* Bs, const float* lxs, const float* lus,
                          const float* luud, const float* lxx, const float* luu_reg,
                          const float* lxT, const float* lxxT, float* ks, float* Ks, int N, int n,
                          int m, int T, float* work, void* stream) {
  return static_cast<int>(%s::launch_wide(As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks,
                                           Ks, N, n, m, T, work,
                                           static_cast<cudaStream_t>(stream)));
}
"""


def variants(names) -> dict:
    src = (ROOT / "probes" / "ilqr_backward_wide_before.cu").read_text()
    out = {"current": src + ENTRY % "ilqr_bwd"}
    for name, subs in ABLATIONS.items():
        text = src
        for old, new in subs:
            assert old in text, f"probes/ilqr_backward_wide_before.cu no longer has {old!r}"
            text = text.replace(old, new)
        out[name] = text + ENTRY % "ilqr_bwd"
    return {name: text for name, text in out.items() if not names or name in names}


def build(texts: dict) -> dict:
    """{variant: (library path or None, build log)}, built side by side."""
    nvcc, procs = _build._nvcc(), {}
    for name, text in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wide.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "wide.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        built[name] = (OUT / name / "lib.so" if proc.returncode == 0 else None, log)
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("ilqr_wide_variants: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    built = build(variants(sys.argv[1:]))
    problems = {}
    for n, m, N, T in SHAPES:
        ops, _ = cs.random_ltv(N, T, n, m, dev, seed=n + m)
        lxx, luu, lxxT = ops[4], ops[5], ops[7]
        luu_reg = (luu + 1e-3 * torch.eye(m, device=dev)).contiguous()
        ks_pkg, Ks_pkg = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3)
        problems[(n, m, N, T)] = (ops, luu_reg, ks_pkg, Ks_pkg)
    for name, (path, log) in built.items():
        if path is None:
            print(f"variant {name}: build failed\n{log[-3000:]}", flush=True)
            continue
        lib = ctypes.CDLL(str(path))
        fn = lib.probe_wide
        # npt_ilqr_backward's arguments with the workspace before the stream
        fn.argtypes = (*_build._SIGNATURES["npt_ilqr_backward"][:-1], ctypes.c_void_p,
                       ctypes.c_void_p)
        lib.npt_ilqr_backward_workspace.argtypes = (ctypes.c_int,) * 3
        lib.npt_ilqr_backward_workspace.restype = ctypes.c_longlong
        line = []
        for (n, m, N, T), (ops, luu_reg, ks_pkg, Ks_pkg) in problems.items():
            As, Bs, lxs, lus, lxx, _, lxT, lxxT = ops
            ks = torch.empty((N, T, m), device=dev)
            Ks = torch.empty((N, T, m, n), device=dev)
            floats = lib.npt_ilqr_backward_workspace(N, n, m)
            work = torch.empty(max(floats, 1), device=dev)

            def call(ops=(As, Bs, lxs, lus), rest=(lxx, luu_reg, lxT, lxxT), ks=ks, Ks=Ks, N=N,
                     n=n, m=m, T=T, work=work, floats=floats):
                return fn(*(x.data_ptr() for x in ops), None, *(x.data_ptr() for x in rest),
                          ks.data_ptr(), Ks.data_ptr(), N, n, m, T,
                          work.data_ptr() if floats else None,
                          torch.cuda.current_stream().cuda_stream)

            assert call() == 0, f"{name} refused ({n}, {m})"
            ms = cs.cuda_ms(call, reps=5, inner=2, warmup=1)
            err = (f", |dK| {cs.max_err(Ks, Ks_pkg):.1e}" if name in ("current", "mb32_only")
                   else "")
            line.append(f"({n}, {m}) N={N} T={T} {ms:.4f} ms{err}")
        regs = [f"{entry.split('::')[-1]} {text}" for entry, text in cs.ptxas_lines(log)]
        print(f"variant {name}: " + "; ".join(line) + f" | {regs} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
