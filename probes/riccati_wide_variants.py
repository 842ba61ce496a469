#!/usr/bin/env python3
"""What the wide fused Riccati kernel (K5 past n = 16, csrc/riccati_wide.cu)
gains or loses from its unrolling and its register budget on the card.

    python probes/riccati_wide_variants.py        (from the repository root)

Builds csrc/riccati_wide.cu alone into build/probes/riccati_wide/<variant>/
once as it is and once for each change below, one nvcc each, all at once:
  - s1u1: step 1 (y = P M[:, c]) takes one row of P an iteration, not two;
  - occ384 / occ512: the launch bound asks for 384 / 512 threads an SM
    (minBlocksPerMultiprocessor = 384 or 512 over the block's threads), so
    ptxas caps the registers at 168 / 128;
  - s1u1_occ384, s1u1_occ512: both.
Each variant runs npt_riccati_fused_wide on the four-quadrotor formation of
chip_smoke.py phase 28 (n = 48, m = 16, N = 4096, T = 30) and on the edges
(48, 48), (17, 1), (32, 8) at N = 4096, T = 8; the probe prints its
CUDA-event time (median of 5 windows of 3 calls), its Ks against the
package's own kernel, and the ptxas lines (registers, spills) of its
(48, 16) and (48, 48) instances, with the card's name and power limit.
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
from numpower_tpu_torch.kernels import _build, riccati  # noqa: E402

OUT = ROOT / "build" / "probes" / "riccati_wide"
BOUND = "__launch_bounds__(WideLayout<NB, MB>::kThreads, 1)"
STEP1 = "#pragma unroll 2\n    for (int j = 0; j < NB; ++j) {"


def variants() -> dict:
    src = (_build.CSRC / "riccati_wide.cu").read_text()
    assert BOUND in src and STEP1 in src, "csrc/riccati_wide.cu no longer has the probed lines"

    def occupancy(text, threads):
        return text.replace(BOUND, BOUND.replace(
            ", 1)", f", {threads} / WideLayout<NB, MB>::kThreads)"))

    s1u1 = src.replace(STEP1, STEP1.replace("unroll 2", "unroll 1"))
    return {"base": src, "s1u1": s1u1, "occ384": occupancy(src, 384),
            "occ512": occupancy(src, 512), "s1u1_occ384": occupancy(s1u1, 384),
            "s1u1_occ512": occupancy(s1u1, 512)}


def build(texts: dict) -> dict:
    """{variant: (library path or None, build log)}, built side by side."""
    nvcc, procs = _build._nvcc(), {}
    for name, text in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "riccati_wide.cu").write_text(text)
        # the source includes nothing of csrc/ but cuda_runtime.h
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "riccati_wide.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        built[name] = (OUT / name / "lib.so" if proc.returncode == 0 else None, log)
    return built


def cases(dev) -> dict:
    """{label: (As, Bs, Q, R, QF, T)} on the card, Bs contiguous."""
    As, B, Q, R, QF = cs.formation(cs.N_FORMATION, cs.N)
    n, m = B.shape
    out = {"formation": (torch.as_tensor(As, device=dev),
                         torch.as_tensor(B, device=dev).expand(cs.N, n, m).contiguous(),
                         Q, R, QF, cs.T)}
    for n_e, m_e in ((48, 48), (17, 1), (32, 8)):
        A_e, B_e, *c_e = cs.stable_plant(n_e, m_e, cs.N, seed=n_e + m_e)
        out[f"({n_e}, {m_e})"] = (torch.as_tensor(A_e, device=dev),
                                  torch.as_tensor(B_e, device=dev).expand(cs.N, n_e, m_e)
                                  .contiguous(), *c_e, cs.T_EDGE)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("riccati_wide_variants: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    built = build(variants())
    inputs = cases(dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (path, log) in built.items():
        if path is None:
            print(f"variant {name}: build failed\n{log[-2000:]}")
            continue
        fn = ctypes.CDLL(str(path)).npt_riccati_fused_wide
        fn.argtypes = (P,) * 7 + (I,) * 4 + (P,)
        line = []
        for label, (As, Bs, Q, R, QF, T) in inputs.items():
            N, n, m = As.shape[0], As.shape[1], Bs.shape[2]
            Qt, Rt, QFt = (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
                           for x in (Q, R, QF))
            Ks = torch.empty((N, T, m, n), device=dev)
            P0 = torch.empty((N, n, n), device=dev)

            def call(As=As, Bs=Bs, Qt=Qt, Rt=Rt, QFt=QFt, Ks=Ks, P0=P0, N=N, n=n, m=m, T=T):
                return fn(As.data_ptr(), Bs.data_ptr(), Qt.data_ptr(), Rt.data_ptr(),
                          QFt.data_ptr(), Ks.data_ptr(), P0.data_ptr(), N, n, m, T,
                          torch.cuda.current_stream().cuda_stream)

            assert call() == 0, f"{name} refused {label}"
            Ks_pkg, _ = riccati.riccati_batched_fused(As, Bs, Qt, Rt, QFt, T)
            ms = cs.cuda_ms(call, reps=5, inner=3, warmup=1)
            line.append(f"{label} {ms:.4f} ms (|Ks - package's| {cs.max_err(Ks, Ks_pkg):.1e})")
        regs = [f"{entry.split('<')[-1]} {text}" for entry, text in cs.ptxas_lines(log)
                if "riccati_wide_kernel<48, 16>" in entry or "riccati_wide_kernel<48, 48>" in entry]
        print(f"variant {name}: " + "; ".join(line) + f" | {regs} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
