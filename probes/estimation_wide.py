#!/usr/bin/env python3
"""The wide K9 and K10 (csrc/kalman_wide.cu) and K11/K12 at p = 5 and 6 on
the card: builds, parity, forms and times, and the nvcc times of the
estimation sources.

    python probes/estimation_wide.py check            (from the repository root)
    python probes/estimation_wide.py tiles
    python probes/estimation_wide.py turns ROOT [ROOT ...]
    python probes/estimation_wide.py compile ROOT [ROOT ...]

``check`` builds the package's library (timed) and prints the ptxas lines
(registers, spills) of every kalman_wide:: instance and of the EKF and UKF
instances at p = 5 and 6; then the wide K9 (with and without inputs) and
the wide K10 against their plain versions on random stable systems at
shapes that take each form (form 0: matrices and tile in shared memory; 1:
the matrices read through L1; 2: the tile in a device workspace), each with
its plan and max|d| against the plain fp32 version and against float64;
K11 and K12 on the planar quadrotor measured by its first 5 and 6
components against theirs; and the own durations (torch.profiler, 20
launches) of the wide K9 and K10 at the four-quadrotor formation (n = 48,
p = 24, N = 4096, T = 50).

``tiles`` builds csrc/kalman_wide.cu with its largest tile 32, 16 and 8
trajectories (kMaxTile, one nvcc each into build/probes/kalman_wide/)
and times each library's wide K9 and K10 at the formation, in two turns,
each against the plain version.

``ablate`` builds csrc/kalman_wide.cu again with one part changed at a
time (ABLATIONS: text substitutions into a copy, one nvcc each, side by
side, into build/probes/kalman_wide/) and times each variant's wide K9 (no
inputs) and K10 at the formation beside the unchanged source's, in two
turns: ``no_stores`` without the stores of x_f, x_p and x_s, ``no_staging``
without the staged copies, ``no_products`` without the tile products (their
results wrong, for the time of what remains only); ``threads128`` and
``threads512`` a block of 128 or 512 threads (256 as it is); and writes
the SASS of the unchanged kernels' form 0 to
build/probes/kalman_wide/kalman_wide.sass.

``turns`` imports the package from each ROOT (a checkout's root) in its own
process and prints the own durations of the narrow K9 and K10 and of K11
and K12 on the pendulum at chip_smoke.py phase 11's shapes, with a checksum
of each output (its float64 sum), which two checkouts whose kernels compute
the same bits print alike.

``compile`` times one nvcc of each ROOT's csrc/ekf.cu, ukf.cu,
kalman_mean.cu, rts_mean.cu and kalman_wide.cu (where it has one), one after
the other, with the package's flags. Every line carries the card's name and
power limit from nvidia-smi.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def stable_lti(n, p, N, T, seed, dev):
    """A stable random system (spectral radius about 0.95), its shared gains
    and time-major data: (A, C, Ws, invLs, logdets, x0s, ys_t, us_t)."""
    import numpy as np
    import torch

    from numpower_tpu_torch.models.estimation import shared_gains

    rng = np.random.default_rng(seed)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
    A = f32(0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n))
    C = f32(rng.standard_normal((p, n)) / np.sqrt(n))
    Ws, _, _, invLs, logdets = shared_gains(A, C, f32(0.01 * np.eye(n)), f32(0.1 * np.eye(p)),
                                            f32(0.5 * np.eye(n)), T)
    return [A, C, Ws.contiguous(), invLs.contiguous(), logdets.contiguous(),
            f32(rng.standard_normal((N, n))), f32(rng.standard_normal((T, N, p))),
            f32(0.1 * rng.standard_normal((T, N, n)))]


def rts_operands(n, N, T, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
    return [f32(0.5 * rng.standard_normal((T - 1, n, n)) / np.sqrt(n)),
            f32(rng.standard_normal((T - 1, N, n))), f32(rng.standard_normal((N, n)))]


def own_us(fn, kernel, calls=20):
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    return cs.profiled_us(fn, [kernel], calls)[kernel]


def check() -> int:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from numpower_tpu_torch.kernels import _build, ekf, kalman_mean, rts_mean, ukf
    from numpower_tpu_torch.models import first_components, planar_quadrotor_step

    card = smi()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    log = _build.library_path().with_suffix(".so.log").read_text()
    for entry, line in cs.ptxas_lines(log):
        if "kalman_wide::" in entry or any(f"<3, 0, {p}>" in entry for p in (5, 6)):
            print(f"ptxas {entry}: {line}", flush=True)
    for (n, p), N, T in (((17, 1), 1003, 13), ((16, 9), 1003, 13), ((48, 24), 4096, 50),
                         ((48, 24), 1003, 50), ((33, 17), 1003, 13), ((64, 8), 1003, 13),
                         ((130, 67), 1003, 13), ((300, 40), 256, 8), ((1500, 2000), 5, 3),
                         ((4000, 3), 9, 3)):
        args = stable_lti(n, p, N, T, seed=n + p, dev=dev)
        for inputs in (False, True):
            a = args if inputs else args[:7]
            plan = kalman_mean.wide_plan(0, n, p, inputs) if (n > 16 or p > 8) else "narrow"
            before = kalman_mean.kalman_mean_pass.launches
            got = kalman_mean.kalman_mean_pass(*a)
            torch.cuda.synchronize()
            launched = kalman_mean.kalman_mean_pass.launches - before
            want = kalman_mean.kalman_mean_pass_reference(*a)
            w64 = kalman_mean.kalman_mean_pass_reference(*[x.double() for x in a])
            dm = max(cs.max_err(got[k], want[k]) for k in range(2))
            dm64 = max(cs.max_err(got[k], w64[k]) for k in range(2))
            pm64 = max(cs.max_err(want[k], w64[k]) for k in range(2))
            rel = ((got[2].double() - want[2].double()).abs()
                   / (2e-3 + 2e-4 * want[2].double().abs())).max().item()
            print(f"K9 (n, p) = ({n}, {p}) N={N} T={T} inputs={inputs} plan {plan} launches "
                  f"{launched}: max|dx| {dm:.3e} vs plain, {dm64:.3e} vs float64 (plain fp32 "
                  f"{pm64:.3e}); ll scaled {rel:.3e}; |x| {want[0].abs().max().item():.3e}",
                  flush=True)
        del args, a, got, want, w64
    for n, N, T in ((17, 1003, 2), (17, 1003, 50), (48, 4096, 50), (130, 1003, 50),
                    (300, 256, 50), (300, 256, 2), (4000, 9, 3)):
        G, es, xl = rts_operands(n, N, T, seed=n + T, dev=dev)
        before = rts_mean.rts_mean_pass.launches
        got = rts_mean.rts_mean_pass(G, es, xl)
        torch.cuda.synchronize()
        launched = rts_mean.rts_mean_pass.launches - before
        want = rts_mean.rts_mean_pass_reference(G, es, xl)
        w64 = rts_mean.rts_mean_pass_reference(G.double(), es.double(), xl.double())
        print(f"K10 n={n} N={N} T={T} plan {rts_mean.wide_plan(0, n)} launches {launched}: "
              f"max|dx| {cs.max_err(got, want):.3e} vs plain, {cs.max_err(got, w64):.3e} vs "
              f"float64 (plain fp32 {cs.max_err(want, w64):.3e})", flush=True)
    import numpy as np

    for p in (5, 6):
        h = functools.partial(first_components, k=p)
        rng = np.random.default_rng(p)
        B, T, n = 1024, 50, 6
        f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
        nl = (f32(np.eye(n) * 1e-3), f32(np.eye(p) * 1e-2), f32(0.3 * rng.standard_normal((B, n))),
              f32(np.eye(n) * 0.1), f32(rng.standard_normal((B, T, p))),
              f32(0.1 * rng.standard_normal((B, T, 2)) + 0.5 * 9.81))
        for name, port, ref in (("K11", ekf.ekf_batched, ekf.ekf_reference),
                                ("K12", ukf.ukf_batched, ukf.ukf_reference)):
            got = port(planar_quadrotor_step, h, *nl)
            torch.cuda.synchronize()
            want = ref(planar_quadrotor_step, h, *nl)
            print(f"{name} planar quadrotor p={p}: max|dx| "
                  f"{max(cs.max_err(got[k], want[k]) for k in (0, 2)):.3e} max|dP| "
                  f"{max(cs.max_err(got[k], want[k]) for k in (1, 3)):.3e} max|dll| "
                  f"{cs.max_err(got[4], want[4]):.3e}", flush=True)
    form = stable_lti(48, 24, 4096, 50, seed=72, dev=dev)
    for what, a in (("without inputs", form[:7]), ("with inputs", form)):
        ms = cs.cuda_ms(lambda: kalman_mean.kalman_mean_pass(*a))
        own = own_us(lambda: kalman_mean.kalman_mean_pass(*a), "kalman_wide_kernel")
        print(f"time K9 wide formation {what}: own {cs.fmt_us(own)}, wrapper {ms:.4f} ms "
              f"[{card}]", flush=True)
    G, es, xl = rts_operands(48, 4096, 50, seed=3, dev=dev)
    ms = cs.cuda_ms(lambda: rts_mean.rts_mean_pass(G, es, xl))
    own = own_us(lambda: rts_mean.rts_mean_pass(G, es, xl), "rts_wide_kernel")
    print(f"time K10 wide formation: own {cs.fmt_us(own)}, wrapper {ms:.4f} ms [{card}]",
          flush=True)
    return 0


def tiles() -> int:
    card = smi()
    libs = wide_variant_libs({f"tile{t}": ([], [("constexpr int kMaxTile = 32;",
                                                 f"constexpr int kMaxTile = {t};")])
                              for t in (32, 16, 8)})
    time_variants(libs, card)
    return 0


ABLATIONS = {
    "no_stores": [("    for (int c = lane; c < n; c += 32) dst[r * n + c] = src[r * ld + c];",
                   "    if (n < 0) dst[r] = src[r];")],
    "no_staging": [("async_copy::copy_run_by_block(", "if (N < 0) async_copy::copy_run_by_block("),
                   ("  if ((cols & 3) == 0 &&", "  if (rows < 0) return;\n  if ((cols & 3) == 0 &&")],
    "no_products": [("  for (int k0 = 0; k0 < K4; k0 += kBlockQuads) {",
                     "  for (int k0 = 0; k0 < K4 - 100000; k0 += kBlockQuads) {")],
}
# the block's threads (kThreads)
THREADS = {f"threads{t}": [("constexpr int kThreads = 256;", f"constexpr int kThreads = {t};")]
           for t in (128, 512)}


def wide_variant_libs(variants: dict) -> dict:
    """{name: ctypes library} of csrc/kalman_wide.cu built with each variant's
    nvcc flags and text substitutions, one nvcc each, side by side."""
    from numpower_tpu_torch.kernels import _build

    out = HERE / "build" / "probes" / "kalman_wide"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "kalman_wide.cu").read_text()
    cmds = {}
    for name, (flags, subs) in variants.items():
        src = text
        for old, new in subs:
            assert old in src, (name, old)
            src = src.replace(old, new)
        path = out / f"{name}.cu"
        path.write_text(src)
        cmds[name] = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *flags, f"-I{_build.CSRC}",
                      "-o", str(out / f"{name}.so"), str(path)]
    codes, log = _build._run_all(list(cmds.values()))
    if any(codes):
        raise RuntimeError(log)
    libs = {}
    for name in cmds:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in ("npt_kalman_mean_wide", "npt_rts_mean_wide"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        libs[name] = lib
    return libs


def time_variants(libs: dict, card: str, turns: int = 2) -> None:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from numpower_tpu_torch.kernels import kalman_mean, rts_mean

    dev = torch.device("cuda", 0)
    a = stable_lti(48, 24, 4096, 50, seed=72, dev=dev)
    cst = kalman_mean._step_constants(a[4], 24).contiguous()
    G, es, xl = rts_operands(48, 4096, 50, seed=3, dev=dev)
    T, N, n = 50, 4096, 48
    outs = [torch.empty((T, N, n), device=dev) for _ in range(3)]
    ll = torch.empty((N,), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = kalman_mean.kalman_mean_pass_reference(*a)
    want_s = rts_mean.rts_mean_pass_reference(G, es, xl)
    for turn in range(turns):
        for name, lib in libs.items():
            for inputs in (False, True):
                def k9(lib=lib, inputs=inputs):
                    return lib.npt_kalman_mean_wide(
                        *(x.data_ptr() for x in a[:4]), cst.data_ptr(), a[5].data_ptr(),
                        a[6].data_ptr(), a[7].data_ptr() if inputs else None,
                        outs[0].data_ptr(), outs[1].data_ptr(), ll.data_ptr(), None, N, T, n, 24,
                        stream)
                outs[0].zero_()
                k9()
                torch.cuda.synchronize()
                err = f" max|dx| {cs.max_err(outs[0], want[0]):.3e}" if inputs else ""
                print(f"turn {turn} {name} K9 wide inputs={inputs}: own "
                      f"{cs.fmt_us(own_us(k9, 'kalman_wide_kernel'))}{err} [{card}]", flush=True)

            def k10(lib=lib):
                return lib.npt_rts_mean_wide(G.data_ptr(), es.data_ptr(), xl.data_ptr(),
                                             outs[2].data_ptr(), None, N, T, n, stream)
            outs[2].zero_()
            k10()
            torch.cuda.synchronize()
            print(f"turn {turn} {name} K10 wide: own "
                  f"{cs.fmt_us(own_us(k10, 'rts_wide_kernel'))} max|dx| "
                  f"{cs.max_err(outs[2], want_s):.3e} [{card}]", flush=True)


def ablate() -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from numpower_tpu_torch.kernels import _build

    card = smi()
    variants = {"base": ([], [])}
    variants.update({name: ([], subs) for name, subs in ABLATIONS.items()})
    variants.update({name: ([], subs) for name, subs in THREADS.items()})
    libs = wide_variant_libs(variants)
    sass = cs.sass_by_kernel(HERE / "build" / "probes" / "kalman_wide" / "base.so")
    dump = HERE / "build" / "probes" / "kalman_wide" / "kalman_wide.sass"
    dump.write_text("".join(f"== {k}\n" + "\n".join(v) + "\n" for k, v in sass.items()
                            if "<0>" in k))
    time_variants(libs, card)
    return 0


def turns(root: str) -> int:
    """The narrow kernels of the checkout at root (run in its own process)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke as cs
    from numpower_tpu_torch.kernels import _build, ekf, kalman_mean, rts_mean, ukf
    from numpower_tpu_torch.models import (
        double_integrator, first_components, kalman_filter_batched, pendulum_step,
    )
    from numpower_tpu_torch.models.estimation import _chol, _chosolve, shared_gains

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    card = smi()
    dev = torch.device("cuda", 0)
    _build.library()
    t32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
    A = t32(double_integrator(0.1).A)
    C, Q, R, P0 = t32([[1.0, 0.0]]), t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2), t32(np.eye(2) * 0.1)
    rng = np.random.default_rng(11)
    yss = t32(rng.standard_normal((4096, 50, 1)))
    x0s = t32(rng.standard_normal((4096, 2)))
    Bu, uss = t32([[0.005], [0.1]]), t32(rng.standard_normal((4096, 50, 1)))
    Ws, _, P_fs, invLs, logdets = shared_gains(A, C, Q, R, P0, 50)
    ys_t = yss.transpose(0, 1).contiguous()
    kf = (A, C, Ws, invLs, logdets, x0s, ys_t)
    kfu = kf + ((uss @ Bu.T).transpose(0, 1).contiguous(),)
    filt = kalman_filter_batched(A, C, Q, R, x0s, P0, yss)
    G_Ts = _chosolve(_chol(filt.pred_covs[0][1:]), A @ P_fs[:-1]).contiguous()
    xf_t, xp_t = filt.means.transpose(0, 1), filt.pred_means.transpose(0, 1)
    es_t = (xf_t[:-1] - torch.einsum("tnj,tjk->tnk", xp_t[1:], G_Ts)).contiguous()
    x_last = xf_t[-1].contiguous()
    r = np.random.default_rng(11)
    nl = (t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2), t32(0.3 * r.standard_normal((1024, 2))),
          t32(np.eye(2) * 0.1), t32(r.standard_normal((1024, 50, 1))),
          t32(0.1 * r.standard_normal((1024, 50, 1))))
    for what, fn, kernel in (
            ("K9 narrow", lambda: kalman_mean.kalman_mean_pass(*kf), "kalman_mean_kernel"),
            ("K9 narrow inputs", lambda: kalman_mean.kalman_mean_pass(*kfu), "kalman_mean_kernel"),
            ("K10 narrow", lambda: rts_mean.rts_mean_pass(G_Ts, es_t, x_last), "rts_mean_kernel"),
            ("K11 pendulum", lambda: ekf.ekf_batched(pendulum_step, first_components, *nl),
             "ekf_kernel"),
            ("K12 pendulum", lambda: ukf.ukf_batched(pendulum_step, first_components, *nl),
             "ukf_kernel")):
        out = fn()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        sums = " ".join(f"{x.double().sum().item():.17g}" for x in outs)
        print(f"{root}: {what} own {cs.fmt_us(cs.profiled_us(fn, [kernel], 50)[kernel])}; "
              f"checksum {sums} [{card}]", flush=True)
    return 0


def compile_times(roots) -> int:
    sys.path.insert(0, str(HERE))
    from numpower_tpu_torch.kernels import _build

    card = smi()
    out = HERE / "build" / "probes" / "objects"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    for root in roots:
        for name in ("ekf.cu", "ukf.cu", "kalman_mean.cu", "rts_mean.cu", "kalman_wide.cu"):
            src = Path(root) / "numpower_tpu_torch" / "csrc" / name
            if not src.is_file():
                continue
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(out / "t.o"),
                                   str(src)], capture_output=True, text=True)
            print(f"nvcc {root} {name}: {time.perf_counter() - t0:.1f} s, exit {proc.returncode} "
                  f"[{card}]", flush=True)
    return 0


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    if mode == "turns":
        for root in sys.argv[2:]:
            code = subprocess.run([sys.executable, __file__, "turn1", root]).returncode
            if code:
                return code
        return 0
    if mode == "turn1":
        return turns(sys.argv[2])
    if mode == "compile":
        return compile_times(sys.argv[2:])
    sys.path.insert(0, str(HERE))
    return {"check": check, "tiles": tiles, "ablate": ablate}[mode]()


if __name__ == "__main__":
    sys.exit(main())
