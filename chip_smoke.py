#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (numpower_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the paths of the port through their entry points and fails unless
every phase passes. The condensed box-QP MPC serving path of BASELINE config
#4 (the 12-state quadrotor linearised about hover, horizon 30, 4096
scenarios, controls boxed to +-1, so d = 120 controls per scenario):

0. device: a CUDA device is required; the kernels are built from
   numpower_tpu_torch/csrc with nvcc (timed); every instance of the box-QP
   templates (K1, K2, K3a, K3b, K1', K2') must hold HGMMA instructions
   (cuobjdump -sass of the library, counted per instance), and they and
   every instance of K7, K8, K6a/K6b, K14, K13, K5, K11, K12, K9 and K10
   compile with no spills (ptxas); the LDS, STS and FFMA counts of each K5 instance are logged;
1. each kernel against its plain PyTorch version on the card at N = 4096:
   cold and warm starts, all-fp32 (max |dU| <= 1e-5) and the default
   bf16 + fp32 schedules (<= 1e-4), residuals within 1e-5;
2. end to end: solve_mpc_boxqp (auto -> FISTA kernel) and
   solve_mpc_boxqp_admm (auto -> ADMM kernel) on 256 scenarios against
   the same algorithm run all-fp32 in float64 by the plain version (<= 1e-4);
3. serving: MPCController (FISTA, then ADMM) for 20 closed-loop ticks of
   4096 scenarios, one kernel launch per tick, finite residuals, u0 in the box;
4. times from CUDA events (median): each kernel and its plain version per
   4096-scenario solve, and one serving tick per solver; K1's and K2's
   device time (direct library calls) at 0 iterations and at 40 all-coarse
   and all-tail, so the fixed cost and the time per iteration of each pass
   count.

The Riccati/LQR family (BASELINE configs #1, #2, #5 and the per-scenario
Riccati of bench.py:341-372):

5. each kernel against its plain PyTorch version on the card: the fused
   Riccati (K5) on the quadrotor recipe of bench.py:345-355 at N = 4096 and
   at a ragged N = 1003, T = 30 (rtol 1e-3, atol 1e-4 on Ks, 1e-3 on P0);
   the batched SPD solve (K6b) at the Riccati inner shape (4096, 4, 4) x
   (4096, 4, 12) and at (4096, 12, 12) x (4096, 12, 4) (rtol 2e-3, atol
   2e-4; residual |AX - B| <= 2e-3); the batched Cholesky (K6a) at
   (4096, 12, 12) against its plain version and torch.linalg.cholesky (1e-4)
   with a strictly upper triangle of exact zeros;
6. the path through its public entry points: riccati_scan_per_scenario at
   N = 4096, T = 30 by "auto" (one K5 launch) and by "psd" (one K6b launch
   per stage), both against the plain route run in float64 on the card; the
   batched Cholesky (the package's kernels API, as bench.py:1246 calls it)
   of the 4096 cost-to-go matrices; config #1 (lqr_solve) and config #2
   (lqr_solve_batched, 256 scenarios) against float64, driving the state to
   the origin; riccati_associative (pivoted and nopivot) against
   riccati_scan at T = 4096; tube_mpc_solve at N = 65,536, T = 30;
7. times from CUDA events (median): each kernel and its plain version, one
   config #1 solve, one config #2 batch, the T = 4096 sequential and
   associative Riccati, one tube sweep and lqr_infinite_gain's share of it;
   one riccati_scan_per_scenario
   by "psd" at N = 4096, T = 30, its K6b launches counted (T a call).

The two-step box-QP kernels (reference tracking and single-x0 solves):

8. K3b fista_boxqp and K3a admm_boxqp against their plain versions at
   N = 4096, d = 120 on the flagship QP with g of an x_ref, cold and warm,
   all-fp32 (<= 1e-5) and the default schedules (<= 1e-4); then the path:
   solve_mpc_boxqp with x_ref and with one x0, solve_mpc_boxqp_admm with
   x_ref, each one K3 launch, against float64 (<= 1e-4), and 20 serving
   ticks of MPCController(x_ref=...), one K3b launch each.

The iLQR / AL-iLQR family (BASELINE config #3, its batched form #3b and the
AL-iLQR bench configuration, bench.py:408-451 and 524-544):

9. K7 ilqr_backward_fused and K8 ilqr_forward_fused against their plain
   versions at config #3b's shape (cartpole, N = 256, T = 50, six alphas)
   and at N = 4096 (K7 rtol 1e-3, atol 1e-4; K8 us/xs 1e-4, costs rtol
   1e-5), K8 also on the pendulum; then the path: config #3 (ilqr_solve,
   finite differences, h = 50, 10 iterations), config #3b
   (ilqr_solve_batched, 256 scenarios, backend="fused": 10 launches each of
   K7 and K8) against the plain backend, and the AL-iLQR configuration
   (pendulum, 256 scenarios, h = 40, 4 x 6 iterations, box +-2, fused: 24
   launches each);
10. times from CUDA events: K3a/K3b at N = 4096, K7 and K8 at N = 256 and
   4096 (wrapper, its host enqueue, the device time of a direct library
   call), each beside its plain version; K7's and K8's device time at
   T = 10, 50 and 200 (N = 256), whence a fixed cost and a time per step;
   K8 with the six alphas and with (0.1, 0.03, 0.01); and the three solves.

The estimators (the estimation bench, bench.py:576-775) and the closed
output-feedback loop:

11. K9 kalman_mean_pass and K10 rts_mean_pass against their plain versions on
   the bench's filter (double integrator, C = [1 0], N = 4096 and a ragged
   1003, T = 50, with and without known inputs; means 2e-5, ll rtol 2e-4 /
   atol 2e-3); K11 ekf_batched and K12 ukf_batched against theirs on the
   pendulum (N = 1024, T = 50, h the first component), the unicycle (p = 2)
   and the planar quadrotor (p = 3) (means 1e-4, covariances 1e-5, ll rtol
   1e-3 / atol 5e-3);
12. the path through its entry points: kalman_filter_batched (one K9 launch)
   against float64 (its default route: the plain one, no launch),
   kalman_filter_sqrt_batched (one K9), kalman_smoother_batched
   (one K10) against the per-trajectory smoother on the batch,
   ekf_filter_batched and ukf_filter_batched (one K11, one K12) against the
   xla route, the associative filter against the sequential one at T = 4096,
   and the closed loop: BASELINE config #4 (MPCController on its default
   device, the card) with kalman_estimator, 4096 scenarios, 100 ticks, noisy
   position and attitude measurements (one K2 launch per tick, controls in
   the box, the unmeasured velocities tracked within 0.1);
13. times from CUDA events: each new kernel's device time (direct library
   calls), wrapper and plain version, each batched entry point and its share
   outside the kernel, the T = 4096 filters, one closed-loop tick.

The sampling family (the MPPI and particle-filter benches, bench.py:546-572
and 644-693), OSQP and MHE:

14. K13 mppi_fused against its plain version on the same perturbations at the
   bench's shape (pendulum, N = 256 scenarios, K = 256 samples, T = 40; two
   rounds max |dus| <= 2e-3 and ess rtol 1e-3, eight rounds median relative
   final cost <= 5e-2), also with the box +-2, sigma 0.7 and lam 0.5, with a
   warm start, and on the unicycle (m = 2, N = 64); then the path:
   mppi_solve_batched (auto -> one K13 launch per call, both eps streams)
   below zero control and near the plain route;
15. K14 resample_systematic against its plain version, element-exact, at
   B = 256, N = 1024 and 1023 with and without a weight spike, and past its
   shared-memory staging (N = 12,289); particle_filter_batched at the bench's
   shape (one K14 launch per step, T = 50) against resample_method="gather"
   (<= 1e-6), and against kalman_filter_batched on 256 linear Gaussian
   trajectories within the Monte Carlo bound of tests/test_estimation.py;
16. solve_mpc_state_constrained on config #4 (4096 scenarios, loose and tight
   state bounds, 60 iterations) against float64 (<= 1e-3), and mhe_solve on
   4096 windows against the RTS smoother; then times from CUDA events: K13
   and K14 (device, wrapper, plain, the eps draw, repeat_interleave, the
   resample constructions), the entry points, rollouts/s and
   particle-steps/s.

The box-QP variants and the data-parallel path (the JAX package's sharded
solvers, which hold the fused kernels against their single-device forms), at
the flagship QP, N = 4096, 40 iterations:

17. K1' admm_mpc and K2' fista_mpc (g formed in the kernel) against their
   plain versions (all-fp32 <= 1e-5, the default schedule <= 1e-4, g <= 1e-5
   relative) and against K3a / K3b on the g they emit; K1's "zy" and "sp"
   loop forms, its c_precision classes and K2's tail_precision / g_precision
   classes against their plain versions (warm; the bf16x3 tail's all-fp32
   bound is 3e-5, see the phase);
18. the path on a one-rank NCCL group (a FileStore in a temporary directory)
   and a (1, 1) mesh: K2' and K1' directly, solve_mpc_boxqp_dp (auto -> one
   K2 launch) equal to the direct K2 within 1e-5 (the verify check
   sharded_solvers_on_mesh), solve_mpc_boxqp_admm_dp (one K1 launch) within
   2e-3 of it, and MPCController(mesh=...) for 20 ticks of 4096 scenarios per
   solver, one launch a tick, equal to the single-device controller within
   1e-5; the group is destroyed at the phase's end;
19. times from CUDA events: K1' and K2' (device, wrapper, plain), the loop
   forms and the precision classes (device, beside their times when the
   products ran on the FMA pipes), the DP solve against the direct
   K2' in turns (the overhead of bench.py's shardmap row), and the mesh tick
   against the single-device tick.

The op surface (numpower_tpu_torch.ops, plain torch calls, no kernel of its
own):

20. every exported op (creation, dtypes, elementwise, logic, reductions,
   statistics, manipulation, linalg, signal, dnn, io, image and the random
   draws) on CUDA tensors: elementwise-style ops, products and filters at
   4096 x 4096 float32 (64 MB an operand), the decompositions at 1024 and
   on 4096 12 x 12 stacks (the MPC state size), conv2d at (32, 64, 128, 128)
   x (64, 64, 3, 3), each against the same op on CPU copies of its inputs
   (exact; transcendentals and sqrt rtol 1e-6, atol 1e-7; reductions rtol
   1e-6, atol 1e-6, on positive data; cumsum, cumprod and prod along 4096
   terms, and every product of K terms, card and CPU each within (K - 1)
   2^-24 of float64; solves, inverses, least squares and spectra of
   well-conditioned operands rtol 1e-4, atol 1e-4 of float64), its dtype
   equal and its result on the card; the factorizations (cholesky, lu, qr,
   svd, eig, eig_complex, eigh) on the card by their reconstruction within
   4 n eps max(1, max |A|) and their invariants; the random draws by their
   moments over 2^24 samples (6 standard errors) and bounds, and the same
   draws after the same seed or key; median and quantile also at 4100 x
   4100, past torch.quantile's 2^24 elements; numpy operands and creation
   with no device land on the card; CUDA-event times of add, exp, sum,
   sort, median, concatenate, matmul (its share of the fp32 peak),
   conv2d_forward, svd and eig at 1024, and the host times of save and load
   of 64 MB;
21. the NDArray on the card: construction from lists and numpy arrays (on
   the card) and from CPU tensors (kept there), gpu()/cpu()/isGPU(), the
   operators and methods against the CPU's, 0-d results as floats, indexing,
   its bounds check and __setitem__, a non-PD cholesky raising, the native
   registry's counts rising and falling with NDArrays, a save/load round
   trip of 64 MB through the native reader, and pickling.

The host-fed stream, the rest of parallel/ and the utilities:

22. the host-fed tube sweep of BASELINE config #5 at its 65,536 scenarios
   (bench.py:779-830's variant, which the bench cuts to 16,384): the native
   ScenarioStream (batch 65,536, shape (20, 12), seed 0, normal, scale
   0.002) on the card feeding tube_mpc_solve on quadrotor12(0.02) (Q = I,
   R = 0.1 I, QF = 5 I, horizon 20, box +-1, x0 = 0.2 N(0, 1) of numpy seed
   2), 8 batches of 63 MB: the stream native, every card batch equal bit for
   bit to a host stream's of the same seed and to a second card stream's,
   the moments within 6 standard errors, finite tube radii; times of the
   production alone (host clock), the pinned host-to-device copy alone and
   the solve alone (CUDA events), and the wall time a batch of the host-fed
   loop, beside the parts' sum and maximum;
23. the rest of parallel/ on a one-rank NCCL group (a FileStore in a
   temporary directory) and a (1, 1) mesh, each path's launch counters
   zeroed just before it and read just after: al_ilqr_solve_dp fused at
   phase 9's AL-iLQR shape (24 launches each of K7 and K8, equal to
   al_ilqr_solve_batched within 1e-6); mhe_solve_dp on phase 16's 4096
   windows, unconstrained and velocity-bounded (equal to mhe_solve within
   1e-6, the replicated residual the blocks' maximum); mppi_solve_dp at the
   MPPI bench's shape against the plain batched route on the same generator
   (two rounds max |dus| <= 1e-4, eight rounds median relative final cost
   <= 5e-2); particle_filter_dp on the PF bench's model and noise with
   65,536 particles, T = 50 (one K14 launch a step; means within 1e-5 and
   ll rtol 1e-5 of particle_filter on the same generator);
   riccati_associative_sharded at T = 4096 on phase 6's system against
   riccati_scan in float64 (Ks rtol 1e-4, atol 1e-5);
   kalman_filter_associative_sharded at T = 4096 on phase 12's filter
   against the sequential filter in float64 (rtol 1e-4, atol 2e-4);
   rollout_lti_pipelined (quadrotor12, N = 4096, T = 30) against
   batched_rollout_lti (rtol 1e-5, atol 1e-6);
24. times from CUDA events (median): each DP, SP and PP entry against its
   single-device counterpart on the one rank, in turns (the collectives'
   cost at D = 1); before phase 23, utils.profiler.trace around one
   annotated K2 solve and four more (the trace names fista_kernel and the
   annotated region; up to three attempts, each logged: the profiler drops a
   short session's GPU records now and then late in this process);
   time_compiled against cuda_ms on K2; save_checkpoint/load_checkpoint of a 4096-scenario
   MPCState on the card (back on the card, equal) through .npz and a
   directory, and the host times of 64 MB.

Every kernel's own duration (torch.profiler's CUDA activity, log_own) is
logged in the times phases (4, 7, 10, 13, 16, 19) beside its wrapper's
CUDA-event time and host enqueue: K1, K2 (4); K5, K6a, K6b (7); K3a, K3b,
K7 and K8 at N = 256 and 4096 (10); K9-K12, K9 also with inputs and K11
also on the unicycle and the planar quadrotor (13); K13 at the bench's shape
and, by a direct call, at N = 4096, K14 (16); K1', K2' (19).

The launch counters of each path are zeroed just before it is driven
(phases 2-3, 6, the path of 8, the path of 9, phase 12, the paths of 14
and 15, phase 18 and the AL-iLQR and particle-filter paths of 23) and read
just after. The last lines are the total wall time, one JSON object listing every
kernel with its bound (bound_ms, bound_by, from this run's shapes) and, where
one PyTorch call computes the same function, that call's time (library_ms),
the card's name and power limit from nvidia-smi, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from numpower_tpu_torch.utils.flops import H100_SXM, boxqp_passes, riccati_fused_cost

T, N, N_E2E, N_TICKS = 30, 4096, 256, 20
LO, HI = -1.0, 1.0
N_RAGGED = 1003  # not a multiple of K5's 8-scenario or K6's 32-matrix blocks
N_CONFIG2, N_TUBE, T_LONG = 256, 65536, 4096
T_ILQR, N_ILQR, T_AL = 50, 256, 40  # configs #3/#3b and the AL-iLQR bench (bench.py:408-451, 524-544)
# the estimation bench (bench.py:576-775) and the closed loop
N_KF, T_KF, N_NL, N_LOOP, T_LOOP = 4096, 50, 1024, 4096, 100
# MPPI (bench.py:546-572; the unicycle case at a smaller N), the particle filter
# (bench.py:644-693) and the MHE windows
N_MPPI, K_MPPI, T_MPPI, IT_MPPI, N_MPPI_SMALL, N_MPPI_BIG = 256, 256, 40, 8, 64, 4096
B_PF, N_PF, T_PF, N_MHE_WINDOWS, M_MHE = 256, 1024, 50, 4096, 20
# the host-fed sweep's batches (bench.py:802) and the sharded particle filter's cloud
N_STREAM_BATCHES, N_PF_DP = 8, 65536
# floating-point operations of one step of each registered plant (csrc/plants.cuh;
# sinf and cosf count one each), for the operation bounds of K8, K11 and K12
PLANT_OPS = {"cartpole_step": 28, "pendulum_step": 8, "unicycle_step": 10,
             "planar_quadrotor_step": 24}


# the kernels whose every instance must compile without spills (phase 0):
# the box-QP templates, K7, K8, K6a/K6b, K14, K13, K5, K11, K12, K9 and K10
CHECKED_FOR_SPILLS = ("boxqp::", "ilqr_bwd::", "ilqr_fwd::", "smallmat::", "pf_resample::",
                      "mppi::", "riccati::", "ekf::", "ukf::", "kalman_mean::", "rts_mean::")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 7, inner: int = 10, warmup: int = 3) -> float:
    """Median over `reps` windows of the CUDA-event time per call, each
    window `inner` calls enqueued back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def enqueue_ms(fn, calls: int = 50) -> float:
    """Mean host time to enqueue one call without waiting for the card: close
    to the call's CUDA-event time when the host bounds it, below it when the
    card does."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def profiled_us(fn, names, calls: int = 50) -> dict:
    """The kernels' own durations on the card: {name: (mean us, launches)} of
    every kernel whose name holds one of `names`, over `calls` calls of fn,
    from torch.profiler's CUDA activity (CUPTI); (None, 0) for a name the
    profiler recorded no kernel of (its duration is then not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {name: [] for name in names}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in ev.name:
                spans[name].append(ev.time_range.elapsed_us())
    return {name: (statistics.fmean(us) if us else None, len(us)) for name, us in spans.items()}


def fmt_us(entry) -> str:
    us, launches = entry
    return "not measured (no kernel in the trace)" if us is None else \
        f"{us:.3f} us (mean of {launches} launches)"


def log_own(what: str, fn, kernel: str, wrapper_ms: float, smi: str, calls: int = 50):
    """Log a kernel's own duration (profiled_us over `calls` calls of fn, the
    kernels whose name holds `kernel`) beside the CUDA-event time of one call
    (`wrapper_ms`) and fn's host enqueue; returns the (mean us, launches)
    entry."""
    own = profiled_us(fn, [kernel], calls)[kernel]
    log(f"profile {what}: {fmt_us(own)}; wrapper {wrapper_ms:.4f} ms, its host enqueue "
        f"{enqueue_ms(fn, calls):.4f} ms [{smi}]")
    return own


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float) -> bool:
    """|a - b| <= atol + rtol |b| everywhere (torch.allclose, in float64)."""
    return torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol)


# H100 SXM peaks (NVIDIA's data sheet, utils/flops.py): HBM bytes/s, fp32
# FLOP/s outside the tensor cores, and the tensor cores' dense bf16 FLOP/s
# (the box-QP kernels' products)
HBM_BYTES_PER_S, FP32_FLOP_PER_S, BF16_TENSOR_FLOP_PER_S = (
    H100_SXM.hbm_gbps * 1e9, H100_SXM.fp32_tflops * 1e12, H100_SXM.bf16_tflops * 1e12)
# the box-QP templates' device times when their products ran on the fp32 FMA
# pipes (PERF.md section 6; H100 80GB HBM3, 700 W; warm start, default
# schedule), logged beside this run's
FMA_DEVICE_MS = {"K1 form s": "0.2041", "K1 form zy": "0.1944", "K1 form sp": "0.1975",
                 "K1 c_precision bf16x4": "0.2021", "K1 c_precision bf16x3": "0.2016",
                 "K2 tail highest": "0.2120-0.2130", "K2 tail bf16x3": "0.3079-0.3105",
                 "fista_g": "0.1936", "admm_g": "0.2574"}


def kernel_entry(name: str, source: str, replaces: str, launches: int, err: float, ms: float,
                 plain_ms: float, n_bytes: float, n_ops: float, library_ms=None,
                 tensor_ops: float = 0.0) -> dict:
    """One kernel's entry of the JSON line. bound_ms is the least time the
    card could take for the call that `ms` timed: the largest of its bytes
    (each input read once, each output written once) over the HBM rate, its
    fp32 operations (`n_ops`) over the fp32 rate and its bf16 tensor-core
    operations (`tensor_ops`) over the tensor cores' rate, all counted from
    this run's shapes."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / FP32_FLOP_PER_S * 1e3,
             "tensor operations": tensor_ops / BF16_TENSOR_FLOP_PER_S * 1e3}
    bound_by = max(times, key=times.get)
    return {"name": name, "route": "cuda", "source": "numpower_tpu_torch/csrc/" + source,
            "replaces": "numpower_tpu/kernels/" + replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": times[bound_by],
            "bound_by": bound_by, "library_ms": library_ms}


def sass_by_kernel(library) -> dict:
    """{demangled kernel: its SASS lines} for the library, from cuobjdump
    -sass (found beside nvcc)."""
    from numpower_tpu_torch.kernels import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    lines, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            lines[fn] = []
        elif fn is not None:
            lines[fn].append(line)
    names = subprocess.run(["c++filt"], input="\n".join(lines), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {name.split("(")[0]: body for name, body in zip(names, lines.values())}


def sass_opcode_counts(library, opcodes) -> dict:
    """{demangled kernel: {opcode: count}} for the library's SASS: an
    instruction counts under its opcode, the mnemonic before its first "."
    (LDS.128 as LDS), a predicate (@P0) skipped."""
    counts = {}
    for fn, body in sass_by_kernel(library).items():
        row = dict.fromkeys(opcodes, 0)
        for line in body:
            code = line.split("*/", 1)[1].split() if line.lstrip().startswith("/*") else []
            if code and code[0].startswith("@"):
                code = code[1:]
            op = code[0].split(".")[0] if code else ""
            if op in row:
                row[op] += 1
        counts[fn] = row
    return counts


def ptxas_lines(build_log: str) -> list:
    """(kernel, line) for each register and spill line of the build log's
    ptxas output, the kernel's name demangled by c++filt where it is found
    and cut before its argument list."""
    pairs, entry = [], "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("Used" in line and "registers" in line) or "spill" in line:
            pairs.append((entry, line.replace("ptxas info    :", "").strip()))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(e for e, _ in pairs),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [e for e, _ in pairs]
    if len(names) != len(pairs):
        names = [e for e, _ in pairs]
    return [(name.split("(")[0], line) for name, (_, line) in zip(names, pairs)]


def spd_batch(N: int, n: int, seed: int, dev) -> torch.Tensor:
    a = np.random.default_rng(seed).standard_normal((N, n, n)).astype(np.float32)
    return torch.as_tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32),
                           device=dev)


def riccati_family(dev, smi: str) -> list:
    """Phases 5-7: the Riccati/LQR family and its three kernels. Returns the
    kernels' entries of the JSON line."""
    from numpower_tpu_torch.kernels import cholesky, riccati
    from numpower_tpu_torch.models import (
        condense, double_integrator, lqr_infinite_gain, lqr_solve, lqr_solve_batched,
        quadrotor12, riccati_associative, riccati_scan, riccati_scan_per_scenario,
        tube_mpc_solve,
    )
    from numpower_tpu_torch.utils.smallmat import cholesky_unrolled, psd_solve_unrolled

    A, B = quadrotor12(0.02)
    n, m = 12, 4
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    rng = np.random.default_rng(4)  # the recipe of bench.py:345-355
    As = torch.as_tensor(np.tile(A, (N, 1, 1))
                         + 0.01 * rng.standard_normal((N, n, n)).astype(np.float32), device=dev)
    Bs = torch.as_tensor(B, device=dev).expand(N, n, m)  # broadcast, as the bench passes it

    # -- phase 5: kernels against their plain versions -------------------------
    err = {"riccati": 0.0, "psd": 0.0, "chol": 0.0}
    for N_k in (N, N_RAGGED):
        Ks, P0 = riccati.riccati_batched_fused(As[:N_k], Bs[:N_k], Q, R, QF, T)
        Ks_p, P0_p = riccati.riccati_batched_reference(As[:N_k], Bs[:N_k], Q, R, QF, T)
        dk, dp = max_err(Ks, Ks_p), max_err(P0, P0_p)
        log(f"K5 riccati N={N_k} T={T}: max|dKs| {dk:.3e} max|dP0| {dp:.3e} "
            f"(|Ks| {Ks.abs().max().item():.3e}, |P0| {P0.abs().max().item():.3e})")
        require(close(Ks, Ks_p, 1e-3, 1e-4) and close(P0, P0_p, 1e-3, 1e-3),
                f"K5 at N={N_k} vs plain")
        err["riccati"] = max(err["riccati"], dk)
    for dim, r, seed in ((m, n, 1), (n, m, 2)):
        a = spd_batch(N, dim, seed, dev)
        b = torch.as_tensor(np.random.default_rng(seed + 10).standard_normal((N, dim, r)),
                            dtype=torch.float32, device=dev)
        X = cholesky.psd_solve_batched(a, b)
        dx, res = max_err(X, psd_solve_unrolled(a, b)), max_err(a @ X, b)
        log(f"K6b psd_solve ({N},{dim},{dim})x({N},{dim},{r}): max|dX| {dx:.3e} "
            f"residual {res:.3e}")
        require(close(X, psd_solve_unrolled(a, b), 2e-3, 2e-4) and res <= 2e-3,
                f"K6b at n={dim} r={r} vs plain")
        err["psd"] = max(err["psd"], dx)
    a = spd_batch(N, n, 3, dev)
    L = cholesky.cholesky_batched(a)
    d_plain, d_lib = max_err(L, cholesky_unrolled(a)), max_err(L, torch.linalg.cholesky(a))
    upper = torch.count_nonzero(torch.triu(L, 1)).item()
    log(f"K6a cholesky ({N},{n},{n}): max|dL| {d_plain:.3e} vs plain, {d_lib:.3e} vs "
        f"torch.linalg.cholesky; nonzeros above the diagonal {upper}")
    require(close(L, cholesky_unrolled(a), 1e-4, 1e-4)
            and close(L, torch.linalg.cholesky(a), 1e-4, 1e-4) and upper == 0,
            "K6a vs plain and torch.linalg.cholesky")
    err["chol"] = d_plain

    # -- phase 6: the Riccati/LQR path, counted --------------------------------
    counters = {"riccati": riccati.riccati_batched_fused, "psd": cholesky.psd_solve_batched,
                "chol": cholesky.cholesky_batched}
    for counter in counters.values():
        counter.launches = 0

    Ks_f, P0_f = riccati_scan_per_scenario(As, Bs, Q, R, QF, T)
    Ks_s, P0_s = riccati_scan_per_scenario(As, Bs, Q, R, QF, T, method="psd")
    Ks_64, P0_64 = riccati_scan_per_scenario(As.double(), Bs.double(), Q, R, QF, T,
                                             method="plain")
    for route, Ks, P0 in (("auto (K5)", Ks_f, P0_f), ("psd (K6b)", Ks_s, P0_s)):
        log(f"riccati_scan_per_scenario {route} N={N} T={T} vs float64: "
            f"max|dKs| {max_err(Ks, Ks_64):.3e} max|dP0| {max_err(P0, P0_64):.3e}")
        require(close(Ks, Ks_64, 1e-3, 1e-4) and close(P0, P0_64, 1e-3, 1e-3),
                f"riccati_scan_per_scenario {route} vs float64")
    L = cholesky.cholesky_batched(P0_f)
    d_rec = max_err(L @ L.transpose(1, 2), P0_f) / P0_f.abs().max().item()
    log(f"cholesky_batched of the {N} cost-to-go matrices: |LL' - P0| / |P0| {d_rec:.3e}")
    require(d_rec <= 1e-5 and torch.count_nonzero(torch.triu(L, 1)).item() == 0,
            "cholesky_batched of P0")

    Ad, Bd = double_integrator(0.1)
    Qd, Rd, QFd = (np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32) * 0.1,
                   np.eye(2, dtype=np.float32) * 100.0)  # bench.py:316-319
    di32 = [torch.as_tensor(x, device=dev) for x in (Ad, Bd, Qd, Rd, QFd)]
    di64 = [x.double() for x in di32]
    x0 = torch.tensor([1.0, 0.0], device=dev)
    us1, xs1 = lqr_solve(*di32, x0, T)
    us1_64, _ = lqr_solve(*di64, x0.double(), T)
    x0s = torch.as_tensor(np.random.default_rng(1).standard_normal((N_CONFIG2, 2)),
                          dtype=torch.float32, device=dev)  # bench.py:330
    us2, xs2 = lqr_solve_batched(*di32, x0s, T)
    us2_64, _ = lqr_solve_batched(*di64, x0s.double(), T)
    shrink = (xs2[:, -1].norm(dim=-1) / xs2[:, 0].norm(dim=-1)).max().item()
    log(f"config #1 lqr_solve T={T}: max|du| vs float64 {max_err(us1, us1_64):.3e}, "
        f"|x_T| {xs1[-1].norm().item():.3e}; config #2 lqr_solve_batched {N_CONFIG2} "
        f"scenarios: max|du| {max_err(us2, us2_64):.3e}, max |x_T|/|x_0| {shrink:.3e}")
    require(close(us1, us1_64, 1e-3, 1e-4) and xs1[-1].norm().item() < 5e-2,
            "config #1 vs float64, driven to the origin")
    require(close(us2, us2_64, 1e-3, 1e-4) and shrink < 5e-2,
            "config #2 vs float64, driven to the origin")

    quad = [torch.as_tensor(x, device=dev) for x in (A, B, Q, R, QF)]
    Ks_seq, Ps_seq = riccati_scan(*quad, T_LONG)
    for nopivot in (False, True):
        Ks_par, Ps_par = riccati_associative(*quad, T_LONG, nopivot=nopivot)
        log(f"riccati_associative T={T_LONG} nopivot={nopivot} vs riccati_scan: "
            f"max|dKs| {max_err(Ks_par, Ks_seq):.3e} max|dPs| {max_err(Ps_par, Ps_seq):.3e}")
        require(close(Ks_par, Ks_seq, 1e-3, 1e-4) and close(Ps_par, Ps_seq, 1e-3, 1e-3),
                f"riccati_associative nopivot={nopivot} vs riccati_scan")

    qp = condense(A, B, Q, R, QF, T, device=dev)
    trng = np.random.default_rng(2)
    w = torch.as_tensor(0.001 * trng.standard_normal((N_TUBE, T, n)), dtype=torch.float32,
                        device=dev)
    x0_nom = torch.as_tensor(0.2 * trng.standard_normal(n), dtype=torch.float32, device=dev)
    tube = tube_mpc_solve(qp, A, B, Q, R, x0_nom, w, LO, HI)
    finite = all(bool(torch.isfinite(f).all()) for f in tube)
    log(f"tube_mpc_solve N={N_TUBE} T={T}: radius[0] {tube.tube_radius[0].item():.3e}, "
        f"max radius {tube.tube_radius.max().item():.3e}, max violation "
        f"{tube.max_violation.item():.3e}, finite {finite}")
    require(tube.xs_scenarios.shape == (N_TUBE, T + 1, n) and finite
            and tube.tube_radius[0].item() == 0.0 and tube.max_violation.item() <= 1e-6,
            "tube sweep statistics")

    launches = {name: counter.launches for name, counter in counters.items()}
    log(f"Riccati-path launches: {launches}")
    require(launches == {"riccati": 1, "psd": T, "chol": 1},
            "the Riccati path went through K5 once, K6b once per stage, K6a once")

    # -- phase 7: times ----------------------------------------------------------
    a4 = spd_batch(N, m, 1, dev)
    b4 = torch.as_tensor(np.random.default_rng(11).standard_normal((N, m, n)),
                         dtype=torch.float32, device=dev)
    a12 = spd_batch(N, n, 3, dev)
    slow = {"reps": 3, "inner": 1, "warmup": 1}
    costs = quad[2:]  # Q, R, QF on the card: numpy ones would add three host copies per call
    ms = {
        "riccati": cuda_ms(lambda: riccati.riccati_batched_fused(As, Bs, *costs, T)),
        "psd": cuda_ms(lambda: cholesky.psd_solve_batched(a4, b4)),
        "chol": cuda_ms(lambda: cholesky.cholesky_batched(a12)),
    }
    plain_ms = {
        "riccati": cuda_ms(lambda: riccati.riccati_batched_reference(As, Bs, *costs, T)),
        "psd": cuda_ms(lambda: psd_solve_unrolled(a4, b4)),
        "chol": cuda_ms(lambda: cholesky_unrolled(a12)),
    }
    lib_chol_ms = cuda_ms(lambda: torch.linalg.cholesky(a12))
    path_ms = {
        "config #1 lqr_solve (T=30)": cuda_ms(lambda: lqr_solve(*di32, x0, T)),
        f"config #2 lqr_solve_batched ({N_CONFIG2} scenarios, T=30)":
            cuda_ms(lambda: lqr_solve_batched(*di32, x0s, T)),
        f"riccati_scan T={T_LONG}": cuda_ms(lambda: riccati_scan(*quad, T_LONG), **slow),
        f"riccati_associative T={T_LONG}":
            cuda_ms(lambda: riccati_associative(*quad, T_LONG), **slow),
        f"riccati_associative T={T_LONG} nopivot":
            cuda_ms(lambda: riccati_associative(*quad, T_LONG, nopivot=True), **slow),
        f"tube_mpc_solve N={N_TUBE} T={T}":
            cuda_ms(lambda: tube_mpc_solve(qp, A, B, Q, R, x0_nom, w, LO, HI), reps=5, inner=2,
                    warmup=1),
        "lqr_infinite_gain (200 iterations)":
            cuda_ms(lambda: lqr_infinite_gain(*quad[:4]), reps=5, inner=2, warmup=1),
    }
    flop = riccati_fused_cost(N, T, n, m).flops
    log(f"time K5 riccati N={N} T={T}: kernel {ms['riccati']:.4f} ms "
        f"({flop / ms['riccati'] / 1e9:.3f} TFLOP/s of 67 fp32), plain {plain_ms['riccati']:.4f} ms "
        f"[{smi}]")
    log(f"time K6b psd_solve ({N},{m},{m})x({N},{m},{n}): kernel {ms['psd']:.4f} ms, plain "
        f"{plain_ms['psd']:.4f} ms [{smi}]")
    log(f"time K6a cholesky ({N},{n},{n}): kernel {ms['chol']:.4f} ms, plain "
        f"{plain_ms['chol']:.4f} ms, torch.linalg.cholesky {lib_chol_ms:.4f} ms [{smi}]")
    for what, t_ms in path_ms.items():
        log(f"time {what}: {t_ms:.4f} ms [{smi}]")

    lib_solve_ms = cuda_ms(lambda: torch.linalg.solve(a4, b4))
    log(f"time torch.linalg.solve ({N},{m},{m})x({N},{m},{n}) (K6b's function): "
        f"{lib_solve_ms:.4f} ms [{smi}]")
    # each kernel's own duration (profiler) beside its wrapper's CUDA-event
    # time and host enqueue; the psd route of the per-scenario Riccati, timed
    # with its launches counted
    log_own(f"K5 riccati N={N} T={T}", lambda: riccati.riccati_batched_fused(As, Bs, *costs, T),
            "riccati_kernel", ms["riccati"], smi)
    log_own(f"K6b psd_solve ({N},{m},{m})x({N},{m},{n})",
            lambda: cholesky.psd_solve_batched(a4, b4), "psd_solve_kernel", ms["psd"], smi)
    log_own(f"K6a cholesky ({N},{n},{n})", lambda: cholesky.cholesky_batched(a12),
            "cholesky_kernel", ms["chol"], smi)
    cholesky.psd_solve_batched.launches = 0
    psd_route_ms = cuda_ms(lambda: riccati_scan_per_scenario(As, Bs, *costs, T, method="psd"),
                           reps=5, inner=1, warmup=1)
    route_launches = cholesky.psd_solve_batched.launches
    log(f"time riccati_scan_per_scenario N={N} T={T} method=psd: {psd_route_ms:.4f} ms "
        f"({route_launches // 6} K6b launches a call) [{smi}]")
    require(route_launches == 6 * T, "the psd route launched K6b once per stage")
    r = n  # K6b's right-hand sides at the timed shape
    return [
        kernel_entry("riccati_batched_fused", "riccati.cu", "riccati.py:172", launches["riccati"],
                     err["riccati"], ms["riccati"], plain_ms["riccati"],
                     4 * (N * n * n + N * n * m + 2 * n * n + m * m + N * T * m * n + N * n * n),
                     flop),
        kernel_entry("cholesky_batched", "cholesky.cu", "cholesky.py:107", launches["chol"],
                     err["chol"], ms["chol"], plain_ms["chol"], 4 * 2 * N * n * n,
                     N * n ** 3 / 3, library_ms=lib_chol_ms),
        kernel_entry("psd_solve_batched", "cholesky.cu", "cholesky.py:135", launches["psd"],
                     err["psd"], ms["psd"], plain_ms["psd"], 4 * (N * m * m + 2 * N * m * r),
                     N * (m ** 3 / 3 + 2 * m * m * r), library_ms=lib_solve_ms),
    ]


def boxqp_iteration_times(qp, x0s, rho, Minv, iters: int, smi: str) -> None:
    """Phase 4's breakdown: K2's and K1's device time (direct library calls,
    cold start) at 0 iterations (staging, fold, residual) and at `iters`
    all-coarse (1 bf16 pass a product) and all-tail (K2: 3 and 6 passes; K1:
    6), whence the time per iteration of each pass count."""
    from numpower_tpu_torch.kernels import _build

    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    Nq, n = x0s.shape
    d = qp.H.shape[0]
    lip = qp.lipschitz.reshape(()).contiguous()
    rho_t = rho.reshape(()).contiguous()
    Ht, W = qp.H.T.contiguous(), (qp.Sx.T @ qp.SuTQ.T).contiguous()
    rMt = (rho_t * Minv.T).contiguous()
    Wc = (qp.Sx.T @ (qp.SuTQ.T @ Minv.T)).contiguous()
    out = torch.empty((Nq, d), device=x0s.device)
    scal = [torch.zeros((), device=x0s.device) for _ in range(2)]
    lo_hi = (ctypes.c_float(LO), ctypes.c_float(HI))

    def k2(it, coarse, tail):
        return cuda_ms(lambda: lib.npt_fista_mpc_res(
            Ht.data_ptr(), W.data_ptr(), x0s.data_ptr(), None, lip.data_ptr(), out.data_ptr(),
            scal[0].data_ptr(), Nq, n, d, it, coarse, *lo_hi, tail, 0, stream))

    def k1(it, coarse):
        return cuda_ms(lambda: lib.npt_admm_mpc_res(
            rMt.data_ptr(), Wc.data_ptr(), x0s.data_ptr(), None, rho_t.data_ptr(),
            out.data_ptr(), scal[0].data_ptr(), scal[1].data_ptr(), Nq, n, d, it, coarse,
            *lo_hi, ctypes.c_float(1.6), 0, 0, stream))

    rows = {"K2": (k2(0, 0, 0), {1: k2(iters, iters, 0), 3: k2(iters, 0, 3), 6: k2(iters, 0, 0)}),
            "K1": (k1(0, 0), {1: k1(iters, iters), 6: k1(iters, 0)})}
    for name, (fixed, by_passes) in rows.items():
        per_it = ", ".join(f"{p} pass{'es' if p > 1 else ''} {1e3 * (t - fixed) / iters:.2f} us "
                           f"({t:.4f} ms in all)" for p, t in by_passes.items())
        log(f"time {name} device ({Nq} scenarios, d={d}, cold): 0 iterations {fixed:.4f} ms; "
            f"per iteration at {per_it} [{smi}]")


def boxqp_two_step(dev, smi: str, qp, x0s, rho) -> list:
    """Phase 8 and its times: K3b/K3a and the x_ref / single-x0 path.
    Returns the kernels' entries of the JSON line."""
    from numpower_tpu_torch.kernels import boxqp_admm, boxqp_fista
    from numpower_tpu_torch.models import (
        MPCController, gradient_offset, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )
    from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters

    iters, n, m = 40, 12, 4
    fista_ci, admm_ci = default_coarse_iters(qp, iters), admm_coarse_iters(qp, iters)
    x_ref = torch.as_tensor(0.2 * np.random.default_rng(5).standard_normal(n),
                            dtype=torch.float32, device=dev)
    g = gradient_offset(qp, x0s, x_ref).contiguous()
    U0 = torch.cat([g[:, m:], g[:, -m:]], dim=1).clamp(LO, HI).contiguous()  # a warm start in the box

    # -- phase 8: kernels against their plain versions ---------------------------
    err = {"fista": 0.0, "admm": 0.0}
    f0, a0 = boxqp_fista.fista_boxqp.launches, boxqp_admm.admm_boxqp.launches
    for coarse_f, coarse_a, tol in ((0, 0, 1e-5), (fista_ci, admm_ci, 1e-4)):
        for start, u0 in (("cold", None), ("warm", U0)):
            Uk = boxqp_fista.fista_boxqp(qp.H, g, LO, HI, qp.lipschitz, iters, coarse_f, u0)
            Up = boxqp_fista.fista_boxqp_reference(qp.H, g, LO, HI, qp.lipschitz, iters,
                                                   coarse_f, u0)
            zk, yk = boxqp_admm.admm_boxqp(qp.H, g, LO, HI, rho, iters, coarse_a, U0=u0)
            zp, yp = boxqp_admm.admm_boxqp_reference(qp.H, g, LO, HI, rho, iters, coarse_a,
                                                     U0=u0)
            du, dz, dy = max_err(Uk, Up), max_err(zk, zp), max_err(yk, yp)
            log(f"K3b fista_boxqp {coarse_f}+{iters - coarse_f} {start}: max|dU| {du:.3e}; "
                f"K3a admm_boxqp {coarse_a}+{iters - coarse_a}: max|dz| {dz:.3e} "
                f"max|dy| {dy:.3e} (tol {tol:g})")
            require(du <= tol and dz <= tol and dy <= tol, f"K3 {start} {coarse_f} vs plain")
            err["fista"], err["admm"] = max(err["fista"], du), max(err["admm"], dz, dy)
    require(boxqp_fista.fista_boxqp.launches - f0 == 4 and boxqp_admm.admm_boxqp.launches - a0 == 4,
            "K3 launched once per call")

    # -- phase 8: the x_ref / single-x0 path, counted ---------------------------
    boxqp_fista.fista_boxqp.launches = 0
    boxqp_admm.admm_boxqp.launches = 0
    xs = x0s[:N_E2E]
    res_r = solve_mpc_boxqp(qp, xs, LO, HI, x_ref=x_ref, iters=iters)
    res_1 = solve_mpc_boxqp(qp, xs[0], LO, HI, iters=iters)
    res_a = solve_mpc_boxqp_admm(qp, xs, LO, HI, x_ref=x_ref, iters=iters)
    require(boxqp_fista.fista_boxqp.launches == 2 and boxqp_admm.admm_boxqp.launches == 1,
            "the x_ref and single-x0 solves went through K3b (twice) and K3a (once)")
    qp64 = type(qp)(H=qp.H.double(), Sx=qp.Sx.double(), Su=qp.Su.double(),
                    SuTQ=qp.SuTQ.double(), lipschitz=qp.lipschitz.double(), mu=qp.mu.double(),
                    T=qp.T, n=qp.n, m=qp.m, kappa=qp.kappa)
    g_r = gradient_offset(qp64, xs.double(), x_ref.double())
    g_1 = gradient_offset(qp64, xs[0].double())[None]
    U_r64 = boxqp_fista.fista_boxqp_reference(qp64.H, g_r, LO, HI, qp64.lipschitz, iters, 0)
    U_164 = boxqp_fista.fista_boxqp_reference(qp64.H, g_1, LO, HI, qp64.lipschitz, iters,
                                                  0)[0]
    rho64 = torch.sqrt(qp64.lipschitz * torch.clamp(qp64.mu, min=1e-12))
    z_r64, _ = boxqp_admm.admm_boxqp_reference(qp64.H, g_r, LO, HI, rho64, iters, 0)
    e_r, e_1, e_a = max_err(res_r.U, U_r64), max_err(res_1.U, U_164), max_err(res_a.U, z_r64)
    log(f"x_ref path vs float64: solve_mpc_boxqp(x_ref) {e_r:.3e} (resid "
        f"{res_r.residual.item():.3e}), one x0 {e_1:.3e} (shape {tuple(res_1.U.shape)}), "
        f"solve_mpc_boxqp_admm(x_ref) {e_a:.3e} (r_prim {res_a.primal_residual.item():.3e}, "
        f"r_dual {res_a.dual_residual.item():.3e}); tol 1e-4")
    require(e_r <= 1e-4 and e_1 <= 1e-4 and e_a <= 1e-4 and res_1.U.shape == (T * m,),
            "the x_ref and single-x0 solves against float64")
    A, B = quadrotor12(0.02)
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, x_ref=x_ref, device=dev)
    A_t, B_t = torch.as_tensor(A, device=dev), torch.as_tensor(B, device=dev)
    state, x = ctrl.init(N), x0s.clone()
    resids = []
    for _ in range(N_TICKS):
        before = boxqp_fista.fista_boxqp.launches
        u0, state, resid = ctrl.step_with_residual(state, x)
        require(boxqp_fista.fista_boxqp.launches == before + 1, "x_ref tick launched K3b once")
        resids.append(resid)
        require(bool(((u0 >= LO) & (u0 <= HI)).all()), "x_ref tick u0 within the box")
        x = x @ A_t.T + u0 @ B_t.T
    resids = torch.stack(resids).cpu()
    dist = (x - x_ref).norm(dim=-1).mean().item()
    log(f"serving fista x_ref: {N_TICKS} ticks x {N} scenarios, residual first "
        f"{resids[0].item():.3e} last {resids[-1].item():.3e}, mean |x - x_ref| "
        f"{(x0s - x_ref).norm(dim=-1).mean().item():.3e} -> {dist:.3e}")
    require(bool(torch.isfinite(resids).all()) and bool(torch.isfinite(x).all())
            and state.tick == N_TICKS, "x_ref serving finite")
    launches = {"fista": boxqp_fista.fista_boxqp.launches,
                "admm": boxqp_admm.admm_boxqp.launches}
    log(f"x_ref-path launches: {launches}")
    require(launches == {"fista": 2 + N_TICKS, "admm": 1}, "the x_ref path went through K3")

    # -- phase 10 (box-QP part): times --------------------------------------------
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_boxqp(qp.H, g, LO, HI, qp.lipschitz, iters,
                                                         fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_boxqp(qp.H, g, LO, HI, rho, iters, admm_ci,
                                                      Minv=Minv)),
    }
    plain_ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_boxqp_reference(qp.H, g, LO, HI, qp.lipschitz,
                                                                   iters, fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_boxqp_reference(qp.H, g, LO, HI, rho, iters,
                                                                admm_ci, Minv=Minv)),
    }
    holder = [ctrl.init(N)]

    def tick():
        _, holder[0] = ctrl.step(holder[0], x0s)

    tick_ms = cuda_ms(tick)
    for solver, name in (("fista", "K3b fista_boxqp"), ("admm", "K3a admm_boxqp (Minv given)")):
        log(f"time {name} {iters} iters, {N} scenarios: kernel {ms[solver]:.4f} ms, plain "
            f"{plain_ms[solver]:.4f} ms [{smi}]")
    log_own(f"K3b fista_boxqp {iters} iters, {N} scenarios", lambda: boxqp_fista.fista_boxqp(
        qp.H, g, LO, HI, qp.lipschitz, iters, fista_ci), "fista_kernel", ms["fista"], smi)
    log_own(f"K3a admm_boxqp {iters} iters, {N} scenarios", lambda: boxqp_admm.admm_boxqp(
        qp.H, g, LO, HI, rho, iters, admm_ci, Minv=Minv), "admm_kernel", ms["admm"], smi)
    log(f"time serving tick with x_ref (FISTA, 30 iters, {N} scenarios): {tick_ms:.4f} ms [{smi}]")
    d = T * m
    return [
        kernel_entry("fista_boxqp", "boxqp_fista.cu", "boxqp_fista.py:119", launches["fista"],
                     err["fista"], ms["fista"], plain_ms["fista"], 4 * (d * d + 2 * N * d + 1),
                     0, tensor_ops=2 * N * d * d * boxqp_passes(fista_ci, iters - fista_ci)),
        kernel_entry("admm_boxqp", "boxqp_admm.cu", "boxqp_admm.py:186", launches["admm"],
                     err["admm"], ms["admm"], plain_ms["admm"], 4 * (2 * d * d + 3 * N * d + 1),
                     0, tensor_ops=2 * N * d * d * boxqp_passes(admm_ci, iters - admm_ci + 1)),
    ]


def ilqr_family(dev, smi: str) -> list:
    """Phase 9 and its times: K7/K8 and configs #3, #3b and the AL-iLQR
    configuration. Returns the kernels' entries of the JSON line."""
    from numpower_tpu_torch.kernels import _build, ilqr_backward, ilqr_forward
    from numpower_tpu_torch.models import (
        al_ilqr_solve_batched, cartpole_step, ilqr_solve, ilqr_solve_batched,
        linearize_trajectory, pendulum_step, rollout_nonlinear,
    )

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    # config #3 (bench.py:408-420)
    Q, R = t32(np.diag([1.0, 10.0, 0.1, 0.1])), t32(np.eye(1) * 0.01)
    QF, goal = t32(np.diag([10.0, 100.0, 1.0, 1.0])), t32(np.zeros(4))
    alphas = t32([1.0, 0.6, 0.3, 0.1, 0.03, 0.01])
    # the AL-iLQR configuration (bench.py:524-544)
    Qp, Rp, QFp = t32(np.diag([1.0, 0.1])), t32(np.eye(1) * 0.01), t32(np.diag([100.0, 10.0]))

    def problem(N, f, n, T_p, seed, draw):
        """The first line search of a solve: x0s from the bench's seed, the
        zero nominal controls, its rollout, FD linearization and affine
        terms, and the gains of one plain backward pass."""
        x0s = t32(draw(np.random.default_rng(seed), N))
        us = torch.zeros((N, T_p, 1), dtype=torch.float32, device=dev)
        xs = rollout_nonlinear(f, x0s, us)
        As, Bs = linearize_trajectory(f, xs, us, use_fd=True)
        Qn, QFn, g = (Q, QF, goal) if n == 4 else (Qp, QFp, goal[:2])
        lxs = 2.0 * (xs[:, :T_p] - g) @ Qn.T
        lus = 2.0 * us @ R.T
        lxT = 2.0 * (xs[:, T_p] - g) @ QFn.T
        bwd = (As, Bs, lxs, lus, 2.0 * Qn, 2.0 * R, lxT, 2.0 * QFn)
        ks, Ks = ilqr_backward.ilqr_backward_reference(*bwd, reg=1e-3)
        fwd = (f, Qn, R, QFn, g, alphas, x0s, xs.contiguous(), us, ks, Ks)
        return bwd, fwd, ks, Ks

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ilqr_direct_calls(bwd, fwd):
        """Direct library calls of K7 and K8 on a problem's operands, laid out
        as their wrappers lay them out (no operand checks, no registry
        lookup), each checked once: (K7 call, K8 call)."""
        from numpower_tpu_torch.models.plants import MAX_PLANT_PARAMS, kernel_plant

        As, Bs, lxs, lus, lxx, luu, lxT, lxxT = (x.contiguous() for x in bwd)
        Nb, Tb, nb, mb = As.shape[0], As.shape[1], As.shape[-1], Bs.shape[-1]
        luu_reg = (luu + 1e-3 * torch.eye(mb, device=dev)).contiguous()
        ks = torch.empty((Nb, Tb, mb), device=dev)
        Ks = torch.empty((Nb, Tb, mb, nb), device=dev)
        bwd_ts = (As, Bs, lxs, lus, lxx, luu_reg, lxT, lxxT, ks, Ks)
        bwd_ptrs = [x.data_ptr() for x in bwd_ts[:4]] + [None] + [x.data_ptr() for x in bwd_ts[4:]]

        def bwd_call(keep=bwd_ts):  # the default holds the operands while the call lives
            return lib.npt_ilqr_backward(*bwd_ptrs, Nb, nb, mb, Tb, stream)

        f, *weights, alphas_f, x0s_f, xs_nom, us_nom, ks_f, Ks_f = fwd
        plant = kernel_plant(f)
        params = [ctypes.c_float(p) for p in
                  list(plant.params) + [0.0] * (MAX_PLANT_PARAMS - len(plant.params))]
        A_n = alphas_f.numel()
        outs = (torch.empty((A_n, Nb, Tb, mb), device=dev),
                torch.empty((A_n, Nb, Tb + 1, nb), device=dev), torch.empty((A_n, Nb), device=dev))
        fwd_ts = [x.contiguous() for x in (*weights, alphas_f, x0s_f, xs_nom, us_nom, ks_f, Ks_f,
                                           *outs)]
        fwd_ptrs = [x.data_ptr() for x in fwd_ts]

        def fwd_call(keep=fwd_ts):
            return lib.npt_ilqr_forward(plant.plant_id, *params, *fwd_ptrs, Nb, Tb, A_n,
                                        xs_nom.shape[1], stream)

        require(bwd_call() == 0 and fwd_call() == 0, "direct K7/K8 library calls launch")
        return bwd_call, fwd_call

    def cart_draw(rng, N):  # bench.py:431-433
        return rng.standard_normal((N, 4)) * 0.3

    def pend_draw(rng, N):  # bench.py:527-529
        return rng.uniform(-np.pi, np.pi, (N, 2))

    # -- phase 9: kernels against their plain versions ---------------------------
    # K8 is compared on the candidates whose plain rollout stays in |x| <= 10:
    # at alpha >= 0.3 the first line search of the cartpole leaves the region
    # of its linearization and diverges (|x| up to 1e18, or inf), in the
    # kernel and the plain version alike, and there fp32 rounding, not the
    # kernel, sets the difference. Bounds: xs 1e-4, costs rtol 1e-5 (the JAX
    # package's, tests/test_kernels.py:577-582); us 5e-4, because the gains
    # reach |K| ~ 100, so a state difference of 5e-6 moves u by 5e-4.
    err = {"bwd": 0.0, "fwd": 0.0}
    probs = {}
    for N_k, f, n, T_p, name, draw, seed in (
            (N_ILQR, cartpole_step, 4, T_ILQR, "cartpole", cart_draw, 3),
            (N, cartpole_step, 4, T_ILQR, "cartpole", cart_draw, 3),
            (N_ILQR, pendulum_step, 2, T_AL, "pendulum", pend_draw, 8)):
        bwd, fwd, ks, Ks = probs[(N_k, name)] = problem(N_k, f, n, T_p, seed, draw)
        ks_k, Ks_k = ilqr_backward.ilqr_backward_fused(*bwd, reg=1e-3)
        dk, dK = max_err(ks_k, ks), max_err(Ks_k, Ks)
        log(f"K7 ilqr_backward {name} N={N_k} T={T_p}: max|dks| {dk:.3e} max|dKs| {dK:.3e} "
            f"(|Ks| {Ks.abs().max().item():.3e})")
        require(close(ks_k, ks, 1e-3, 1e-4) and close(Ks_k, Ks, 1e-3, 1e-4),
                f"K7 {name} at N={N_k} vs plain")
        err["bwd"] = max(err["bwd"], dk, dK)
        u_k, x_k, c_k = ilqr_forward.ilqr_forward_fused(*fwd)
        u_p, x_p, c_p = ilqr_forward.ilqr_forward_reference(*fwd)
        ok = torch.isfinite(c_p) & (x_p.abs().amax(dim=(-2, -1)) <= 10.0)
        du, dx = max_err(u_k[ok], u_p[ok]), max_err(x_k[ok], x_p[ok])
        dc = ((c_k[ok].double() - c_p[ok].double()).abs() / c_p[ok].double().abs()).max().item()
        per_alpha = ok.sum(dim=1).tolist()
        log(f"K8 ilqr_forward {name} N={N_k} T={T_p} A={alphas.numel()}: bounded candidates "
            f"per alpha {per_alpha}; on them max|dus| {du:.3e} max|dxs| {dx:.3e} max rel dcost "
            f"{dc:.3e}")
        require(ok.double().mean().item() >= 0.4 and du <= 5e-4 and dx <= 1e-4 and dc <= 1e-5,
                f"K8 {name} at N={N_k} vs plain")
        err["fwd"] = max(err["fwd"], du, dx)

    # -- phase 9: configs #3, #3b and AL-iLQR, counted ---------------------------
    ilqr_backward.ilqr_backward_fused.launches = 0
    ilqr_forward.ilqr_forward_fused.launches = 0
    x0 = t32([0.0, 0.5, 0.0, 0.0])
    r3 = ilqr_solve(cartpole_step, x0, Q, R, QF, goal, horizon=T_ILQR, iters=10, use_fd=True)
    x0s = t32(cart_draw(np.random.default_rng(3), N_ILQR))
    kw = dict(horizon=T_ILQR, use_fd=True)
    r3b = ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal, backend="fused", iters=10, **kw)
    ilqr_launches = (ilqr_backward.ilqr_backward_fused.launches,
                     ilqr_forward.ilqr_forward_fused.launches)
    x0p = t32(pend_draw(np.random.default_rng(8), N_ILQR))
    al_kw = dict(al_iters=4, ilqr_iters=6)
    ral = al_ilqr_solve_batched(pendulum_step, x0p, Qp, Rp, QFp, goal[:2], T_AL, -2.0, 2.0,
                                backend="fused", **al_kw)
    launches = {"bwd": ilqr_backward.ilqr_backward_fused.launches,
                "fwd": ilqr_forward.ilqr_forward_fused.launches}
    log(f"iLQR-path launches: config #3b {ilqr_launches}, with AL-iLQR {launches}")
    require(ilqr_launches == (10, 10), "config #3b went through K7 and K8 once per iteration")
    require(launches == {"bwd": 34, "fwd": 34}, "AL-iLQR went through K7 and K8 24 times each")

    def consistent(res, f, x0, Qn, Rn, QFn, g, what):
        """The repo's own checks of a solve: finite; xs the plain rollout of
        us and cost the trajectory's cost, to 1e-3 of |xs| and of the cost:
        an open-loop replay on another arithmetic path (K8's rollout against
        the plain one) drifts on the chaotic cartpole (2.2e-3 on |x| ~ 30
        measured on the H100)."""
        from numpower_tpu_torch.models.ilqr import _total_cost

        xs_re = rollout_nonlinear(f, x0, res.us)
        c_re = _total_cost(xs_re, res.us, Qn, Rn, QFn, g)
        d_x, x_max = max_err(xs_re, res.xs), res.xs.abs().max().item()
        d_c = ((c_re.double() - res.cost.double()).abs() / res.cost.double().abs()).max().item()
        log(f"{what}: replay of us max|dxs| {d_x:.3e} (|xs| {x_max:.3e}), rel dcost {d_c:.3e}")
        return (bool(torch.isfinite(res.us).all() and torch.isfinite(res.cost).all())
                and d_x <= 1e-3 * max(1.0, x_max) and d_c <= 1e-3)

    def rel_cost(a, b):
        return ((a.cost.double() - b.cost.double()).abs() / b.cost.double().abs()).sort().values

    c0 = r3.costs
    log(f"config #3 ilqr_solve (fd, h={T_ILQR}, 10 iters): cost {c0[0].item():.6f} -> "
        f"{r3.cost.item():.6f}, |x_T| {r3.xs[-1].norm().item():.3e}")
    require(consistent(r3, cartpole_step, x0, Q, R, QF, goal, "config #3")
            and bool((c0[1:] <= c0[:-1]).all()), "config #3: finite, descending, consistent")
    require(consistent(r3b, cartpole_step, x0s, Q, R, QF, goal, "config #3b")
            and bool((r3b.costs[:, 1:] <= r3b.costs[:, :-1]).all()),
            "config #3b: finite, descending, consistent")
    # Against the plain backend. The per-scenario bound of the JAX package,
    # rtol 1e-2 and atol 1e-3 on the cost, was set on its test problem
    # (tests/test_kernels.py:166-176: Q = I, R = 0.01, QF = 10 I, h = 15, 6
    # iterations); it is held there at config #3b's batch of 256. At config
    # #3 itself (h = 50, theta weighted 10, QF 100) the candidates of large
    # alphas leave the linearization's region and diverge chaotically (phase 9
    # above), so marginal line-search choices part the two backends'
    # trajectories (the JAX package's own backends differ so: ROADMAP.md,
    # queue 3); there the batch's mean cost is held, to 5%.
    Qt, Rt, QFt = t32(np.eye(4)), t32(np.eye(1) * 0.01), t32(np.eye(4) * 10.0)
    x0t = t32(0.3 * np.random.default_rng(1).standard_normal((N_ILQR, 4)))
    pair = [ilqr_solve_batched(cartpole_step, x0t, Qt, Rt, QFt, goal, 15, backend=b, iters=6)
            for b in ("fused", "vmap")]
    d_t = (pair[0].cost - pair[1].cost).abs()
    rel_t = (d_t / pair[1].cost.abs()).max().item()
    out_t = int((d_t > 1e-3 + 1e-2 * pair[1].cost.abs()).sum().item())
    r3b_plain = ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal, backend="vmap", iters=10,
                                   **kw)
    rel10 = ((r3b.cost.double() - r3b_plain.cost.double()).abs()
             / r3b_plain.cost.double().abs()).sort().values
    mean_f, mean_p = r3b.cost.mean().item(), r3b_plain.cost.mean().item()
    log(f"fused vs vmap, the JAX test problem at {N_ILQR} scenarios: max rel dcost {rel_t:.3e} "
        f"({out_t} outside the bound); "
        f"config #3b: per-scenario rel dcost median {rel10[N_ILQR // 2].item():.3e}, 90th pct "
        f"{rel10[int(0.9 * N_ILQR)].item():.3e}, max {rel10[-1].item():.3e}, mean cost "
        f"{mean_f:.4f} vs {mean_p:.4f}")
    require(bool((d_t <= 1e-3 + 1e-2 * pair[1].cost.abs()).all()),
            "fused vs vmap per scenario on the JAX test problem")
    require(abs(mean_f - mean_p) <= 0.05 * mean_p, "config #3b fused vs vmap, mean cost")
    lo_hi_ok = bool(((ral.us >= -2.0) & (ral.us <= 2.0)).all())
    log(f"AL-iLQR pendulum {N_ILQR} scenarios h={T_AL} 4x6 fused: mean cost "
        f"{ral.cost.mean().item():.4f}, max_violation max {ral.max_violation.max().item():.3e} "
        f"median {ral.max_violation.median().item():.3e}, us in the box {lo_hi_ok}")
    require(consistent(ral, pendulum_step, x0p, Qp, Rp, QFp, goal[:2], "AL-iLQR") and lo_hi_ok
            and bool(torch.isfinite(ral.max_violation).all()), "AL-iLQR: finite, feasible")

    # -- phase 10 (iLQR part): times ----------------------------------------------
    # wrapper (CUDA events), its host enqueue, the device time of a direct
    # library call on the same operands, and the plain version
    ms, host_ms, dev_ms, plain_ms = {}, {}, {}, {}
    slow = {"reps": 3, "inner": 1, "warmup": 1}
    for N_k in (N_ILQR, N):
        bwd, fwd, _, _ = probs[(N_k, "cartpole")]
        calls = {"bwd": lambda: ilqr_backward.ilqr_backward_fused(*bwd, reg=1e-3),
                 "fwd": lambda: ilqr_forward.ilqr_forward_fused(*fwd)}
        for k, direct in zip(("bwd", "fwd"), ilqr_direct_calls(bwd, fwd)):
            ms[(k, N_k)] = cuda_ms(calls[k])
            host_ms[(k, N_k)] = enqueue_ms(calls[k])
            dev_ms[(k, N_k)] = cuda_ms(direct)
        plain_ms[("bwd", N_k)] = cuda_ms(
            lambda: ilqr_backward.ilqr_backward_reference(*bwd, reg=1e-3), **slow)
        plain_ms[("fwd", N_k)] = cuda_ms(lambda: ilqr_forward.ilqr_forward_reference(*fwd), **slow)
        for k, name, kern in (("bwd", "K7 ilqr_backward", "backward_"),
                              ("fwd", "K8 ilqr_forward", "ilqr_forward_kernel")):
            log(f"time {name} cartpole N={N_k} T={T_ILQR}: kernel {ms[(k, N_k)]:.4f} ms "
                f"(device {dev_ms[(k, N_k)]:.4f} ms, host enqueue {host_ms[(k, N_k)]:.4f} ms), "
                f"plain {plain_ms[(k, N_k)]:.4f} ms [{smi}]")
            log_own(f"{name} cartpole N={N_k} T={T_ILQR}", calls[k], kern, ms[(k, N_k)], smi)
    # the chain: device time at T = 10, 50 and 200 (N = 256), whence a fixed
    # cost and a time per step from the line through T = 10 and 200
    by_T = {}
    for T_p in (10, T_ILQR, 200):
        bwd, fwd, _, _ = (probs[(N_ILQR, "cartpole")] if T_p == T_ILQR else
                          problem(N_ILQR, cartpole_step, 4, T_p, 3, cart_draw))
        by_T[T_p] = [cuda_ms(direct) for direct in ilqr_direct_calls(bwd, fwd)]
    for i, name in enumerate(("K7 ilqr_backward", "K8 ilqr_forward")):
        per_step = (by_T[200][i] - by_T[10][i]) / 190
        fixed = by_T[10][i] - 10 * per_step
        log(f"time {name} device cartpole N={N_ILQR}: T=10 {by_T[10][i]:.4f} ms, "
            f"T={T_ILQR} {by_T[T_ILQR][i]:.4f} ms, T=200 {by_T[200][i]:.4f} ms; fixed "
            f"{1e3 * fixed:.2f} us, per step {1e3 * per_step:.3f} us [{smi}]")
    # K8 by alpha set: the six alphas of the solve (those >= 0.3 diverge on the
    # first line search, |x| up to 1e18) against the three small ones
    _, fwd, _, _ = probs[(N_ILQR, "cartpole")]
    fwd_small = fwd[:5] + (t32([0.1, 0.03, 0.01]),) + fwd[6:]
    _, direct_small = ilqr_direct_calls(probs[(N_ILQR, "cartpole")][0], fwd_small)
    log(f"time K8 ilqr_forward device cartpole N={N_ILQR} T={T_ILQR}: six alphas "
        f"{dev_ms[('fwd', N_ILQR)]:.4f} ms, alphas (0.1, 0.03, 0.01) "
        f"{cuda_ms(direct_small):.4f} ms [{smi}]")
    solve_ms = {
        f"config #3 ilqr_solve (fd, h={T_ILQR}, 10 iters)":
            cuda_ms(lambda: ilqr_solve(cartpole_step, x0, Q, R, QF, goal, horizon=T_ILQR,
                                       iters=10, use_fd=True), **slow),
        f"config #3b ilqr_solve_batched fused ({N_ILQR} scenarios)":
            cuda_ms(lambda: ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal,
                                               backend="fused", iters=10, **kw),
                    reps=5, inner=2, warmup=1),
        f"config #3b ilqr_solve_batched vmap ({N_ILQR} scenarios)":
            cuda_ms(lambda: ilqr_solve_batched(cartpole_step, x0s, Q, R, QF, goal,
                                               backend="vmap", iters=10, **kw), **slow),
        f"AL-iLQR fused (pendulum, {N_ILQR} scenarios, h={T_AL}, 4x6)":
            cuda_ms(lambda: al_ilqr_solve_batched(pendulum_step, x0p, Qp, Rp, QFp, goal[:2],
                                                  T_AL, -2.0, 2.0, backend="fused", **al_kw),
                    reps=5, inner=1, warmup=1),
    }
    for what, t_ms in solve_ms.items():
        log(f"time {what}: {t_ms:.4f} ms [{smi}]")
    # K7 per stage: the Q-function products, the (m x m) solve for k and K,
    # and the value updates; K8 per (alpha, scenario, step): the feedback, the
    # stage cost's upper-triangle sums and the plant's operations
    n, m, Nk, Tk, A_n = 4, 1, N_ILQR, T_ILQR, alphas.numel()
    bwd_ops = Nk * Tk * (4 * n ** 3 + 6 * n * n * m + 2 * n * m * m + 2 * n * n + 4 * n * m
                         + m ** 3 / 3 + 2 * m * m * (n + 1))
    bwd_bytes = 4 * (Nk * Tk * (n * n + n * m + n + m) + 2 * n * n + m * m + Nk * n
                     + Nk * Tk * (m + m * n))
    fwd_ops = A_n * Nk * Tk * (n + m * (2 + 2 * n) + 3 * (n * (n + 1) // 2 + m * (m + 1) // 2)
                               + PLANT_OPS["cartpole_step"])
    fwd_bytes = 4 * (2 * n * n + m * m + n + A_n + Nk * n + Nk * (Tk + 1) * n
                     + Nk * Tk * (2 * m + m * n) + A_n * Nk * (Tk * m + (Tk + 1) * n + 1))
    return [
        kernel_entry("ilqr_backward_fused", "ilqr_backward.cu", "ilqr_backward.py:134",
                     launches["bwd"], err["bwd"], ms[("bwd", N_ILQR)], plain_ms[("bwd", N_ILQR)],
                     bwd_bytes, bwd_ops),
        kernel_entry("ilqr_forward_fused", "ilqr_forward.cu", "ilqr_forward.py:92",
                     launches["fwd"], err["fwd"], ms[("fwd", N_ILQR)], plain_ms[("fwd", N_ILQR)],
                     fwd_bytes, fwd_ops),
    ]


def estimation_family(dev, smi: str) -> list:
    """Phases 11-13: the estimators' kernels K9-K12, the estimation path
    through its entry points with the closed output-feedback loop, and their
    times. Returns the kernels' entries of the JSON line."""
    import functools

    from numpower_tpu_torch.kernels import _build, boxqp_fista, ekf, kalman_mean, rts_mean, ukf
    from numpower_tpu_torch.models import (
        MPCController, double_integrator, ekf_filter_batched, first_components, kalman_estimator,
        kalman_filter, kalman_filter_associative, kalman_filter_batched,
        kalman_filter_sqrt_batched, kalman_smoother, kalman_smoother_batched, pendulum_step,
        planar_quadrotor_step, quadrotor12, simulate_closed_loop, ukf_filter_batched,
        unicycle_step,
    )
    from numpower_tpu_torch.models.estimation import _chol, _chosolve, shared_gains

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def worst(a, b):
        return max(max_err(x, y) for x, y in zip(a, b))

    # the estimation bench's configuration (bench.py:587-595); known inputs
    # for the "with inputs" case as in tests/test_kernels.py:325-326
    A = t32(double_integrator(0.1).A)
    C, Q, R = t32([[1.0, 0.0]]), t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2)
    P0 = t32(np.eye(2) * 0.1)
    kf = (A, C, Q, R)
    rng = np.random.default_rng(11)
    yss = t32(rng.standard_normal((N_KF, T_KF, 1)))
    x0s = t32(rng.standard_normal((N_KF, 2)))
    Bu, uss = t32([[0.005], [0.1]]), t32(rng.standard_normal((N_KF, T_KF, 1)))
    # the nonlinear filters' (bench.py:700-711: N = 1024, T = 50, the same Q,
    # R, P0) on the registered plants, h the first p components
    nonlinear = {}
    for f, n_, m_, p_ in ((pendulum_step, 2, 1, 1), (unicycle_step, 3, 2, 2),
                          (planar_quadrotor_step, 6, 2, 3)):
        r = np.random.default_rng(11)
        u_nom = 0.5 * 9.81 if f is planar_quadrotor_step else 0.0  # the quadrotor hovers
        nonlinear[f.__name__] = (f, functools.partial(first_components, k=p_), (
            t32(np.eye(n_) * 1e-3), t32(np.eye(p_) * 1e-2),
            t32(0.3 * r.standard_normal((N_NL, n_))),
            t32(np.eye(n_) * 0.1), t32(r.standard_normal((N_NL, T_KF, p_))),
            t32(0.1 * r.standard_normal((N_NL, T_KF, m_)) + u_nom)))

    # -- phase 11: each new kernel against its plain version ------------------
    # Bounds: K9 means 2e-5, ll rtol 2e-4 / atol 2e-3; K10 2e-5; K11/K12 means
    # 1e-4, covariances 1e-5, ll rtol 1e-3 / atol 5e-3 (tests/test_kernels.py:
    # 310-500; the kernels' rsqrtf pivots are within 2 ulp)
    err = {"kf": 0.0, "rts": 0.0, "ekf": 0.0, "ukf": 0.0}
    for N_k in (N_KF, N_RAGGED):
        for kw in ({}, {"B": Bu, "uss": uss[:N_k]}):
            got = kalman_filter_batched(*kf, x0s[:N_k], P0, yss[:N_k], method="pallas", **kw)
            want = kalman_filter_batched(*kf, x0s[:N_k], P0, yss[:N_k], method="xla", **kw)
            dm = max(max_err(got.means, want.means), max_err(got.pred_means, want.pred_means))
            dl = max_err(got.log_likelihood, want.log_likelihood)
            s_k = kalman_smoother_batched(A, got, method="pallas")
            s_p = kalman_smoother_batched(A, got, method="xla")
            ds = max_err(s_k.means, s_p.means)
            log(f"K9 kalman_mean N={N_k} T={T_KF} inputs={bool(kw)}: max|dx| {dm:.3e} "
                f"max|dll| {dl:.3e}; K10 rts_mean: max|dx| {ds:.3e}")
            require(dm <= 2e-5 and close(got.log_likelihood, want.log_likelihood, 2e-4, 2e-3)
                    and ds <= 2e-5, f"K9/K10 at N={N_k} inputs={bool(kw)} vs plain")
            err["kf"], err["rts"] = max(err["kf"], dm), max(err["rts"], ds)
    for name, (f, h, args) in nonlinear.items():
        for key, port, ref in (("ekf", ekf.ekf_batched, ekf.ekf_reference),
                               ("ukf", ukf.ukf_batched, ukf.ukf_reference)):
            got, want = port(f, h, *args), ref(f, h, *args)
            dx, dP = worst(got[0::2][:2], want[0::2][:2]), worst(got[1::2][:2], want[1::2][:2])
            log(f"K{11 if key == 'ekf' else 12} {key} {name} N={N_NL} T={T_KF}: max|dx| {dx:.3e} "
                f"max|dP| {dP:.3e} max|dll| {max_err(got[4], want[4]):.3e}")
            require(dx <= 1e-4 and dP <= 1e-5 and close(got[4], want[4], 1e-3, 5e-3),
                    f"{key} on {name} vs plain")
            err[key] = max(err[key], dx, dP)

    # -- phase 12: the estimation path through its entry points, counted -------
    counters = {"kf": kalman_mean.kalman_mean_pass, "rts": rts_mean.rts_mean_pass,
                "ekf": ekf.ekf_batched, "ukf": ukf.ukf_batched, "fista": boxqp_fista.fista_mpc_res}
    for counter in counters.values():
        counter.launches = 0
    filt = kalman_filter_batched(*kf, x0s, P0, yss)
    seen = {"kf": kalman_mean.kalman_mean_pass.launches}
    f64 = [M.double() for M in kf]
    # float64 on the default route: "auto" takes the plain route (the kernels
    # take float32), so the counted K9 launches stay at one
    filt64 = kalman_filter_batched(*f64, x0s.double(), P0.double(), yss.double())
    d64 = max_err(filt.means, filt64.means)
    rel_ll = ((filt.log_likelihood.double() - filt64.log_likelihood)
              / filt64.log_likelihood).abs().max().item()
    log(f"kalman_filter_batched N={N_KF} T={T_KF} (auto -> K9, {seen['kf']} launch) vs float64 "
        f"(auto -> plain): max|dx| {d64:.3e}, max rel dll {rel_ll:.3e}")
    # test_kalman_filter_matches_fp64's bounds: means rtol 1e-3 atol 1e-4, ll rtol 1e-3
    require(seen["kf"] == 1 and kalman_mean.kalman_mean_pass.launches == 1
            and close(filt.means, filt64.means, 1e-3, 1e-4)
            and close(filt.log_likelihood, filt64.log_likelihood, 1e-3, 0.0),
            "kalman_filter_batched: one K9 launch, against float64")
    sq = kalman_filter_sqrt_batched(*kf, x0s, P0, yss)
    seen["kf_sqrt"] = kalman_mean.kalman_mean_pass.launches - seen["kf"]
    d_sq = max_err(sq.means, filt.means)
    log(f"kalman_filter_sqrt_batched (auto -> K9, {seen['kf_sqrt']} launch) vs the covariance "
        f"form: max|dx| {d_sq:.3e}")
    # test_sqrt_kalman_matches_standard's bounds: means 1e-5, ll rtol 1e-4
    require(seen["kf_sqrt"] == 1 and d_sq <= 1e-5
            and close(sq.log_likelihood, filt.log_likelihood, 1e-4, 0.0),
            "kalman_filter_sqrt_batched: one K9 launch, against kalman_filter_batched")
    sm = kalman_smoother_batched(A, filt)
    seen["rts"] = rts_mean.rts_mean_pass.launches
    sm_v = kalman_smoother(A, filt)  # the vmapped form: the per-trajectory smoother on the batch
    log(f"kalman_smoother_batched (auto -> K10, {seen['rts']} launch) vs kalman_smoother on the "
        f"batch: max|dx| {max_err(sm.means, sm_v.means):.3e} "
        f"max|dP| {max_err(sm.covs, sm_v.covs):.3e}")
    require(seen["rts"] == 1 and close(sm.means, sm_v.means, 1e-5, 1e-4)
            and close(sm.covs, sm_v.covs, 1e-5, 1e-4),
            "kalman_smoother_batched: one K10 launch, against the vmapped form")
    f, h, args = nonlinear["pendulum_step"]
    for key, entry in (("ekf", ekf_filter_batched), ("ukf", ukf_filter_batched)):
        got = entry(f, h, *args)
        want = entry(f, h, *args, method="xla")
        dx, dP = max_err(got.means, want.means), max_err(got.covs, want.covs)
        seen[key] = counters[key].launches
        log(f"{entry.__name__} pendulum N={N_NL} (auto -> K{11 if key == 'ekf' else 12}, "
            f"{seen[key]} launch) vs the xla route: max|dx| {dx:.3e} max|dP| {dP:.3e} max|dll| "
            f"{max_err(got.log_likelihood, want.log_likelihood):.3e}")
        require(seen[key] == 1 and dx <= 1e-4 and dP <= 1e-5
                and close(got.log_likelihood, want.log_likelihood, 1e-3, 5e-3),
                f"{entry.__name__}: one launch, against the xla route")
    ys_long = t32(rng.standard_normal((T_LONG, 1)))
    x0 = t32([1.0, 0.0])
    seq = kalman_filter(*kf, x0, P0, ys_long)
    for nopivot in (False, True):
        par = kalman_filter_associative(*kf, x0, P0, ys_long, nopivot=nopivot)
        log(f"kalman_filter_associative T={T_LONG} nopivot={nopivot} vs kalman_filter: max|dx| "
            f"{max_err(par.means, seq.means):.3e} max|dP| {max_err(par.covs, seq.covs):.3e}")
        # test_kalman_associative_long_horizon's bounds
        require(close(par.means, seq.means, 5e-3, 5e-4) and close(par.covs, seq.covs, 5e-3, 5e-5),
                f"kalman_filter_associative nopivot={nopivot} vs kalman_filter")

    # the closed loop: BASELINE config #4 under output feedback (the noise of
    # tests/test_simulate.py:54-70), position and attitude measured
    Aq, Bq = quadrotor12(0.02)
    nq = Aq.shape[0]
    ctrl = MPCController(Aq, Bq, np.eye(nq, dtype=np.float32), np.eye(4, dtype=np.float32) * 0.1,
                         np.eye(nq, dtype=np.float32) * 5.0, T, LO, HI, iters=30)  # on the card
    require(ctrl.qp.H.device.type == "cuda", "MPCController defaults to the card")
    measured = [0, 1, 2, 6, 7, 8]
    Cq = np.eye(nq, dtype=np.float32)[measured]
    x0q = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((N_LOOP, nq)),
                          dtype=torch.float32, device=dev)
    make, update = kalman_estimator(Aq, Cq, np.eye(nq) * 1e-4, np.eye(6) * 1e-2,
                                    np.eye(nq) * 0.5, B=Bq)
    Aq_t, Bq_t, Cq_t = t32(Aq), t32(Bq), t32(Cq)

    def plant(x, u):
        return x @ Aq_t.T + u @ Bq_t.T

    def sensor(x):
        return x @ Cq_t.T

    loop = dict(w_std=0.01, h=sensor, v_std=0.05, estimator=update)
    res = simulate_closed_loop(plant, ctrl.callback(), ctrl.callback_init(N_LOOP), x0q, T_LOOP,
                               generator=torch.Generator(device=dev).manual_seed(0),
                               est_state0=make(x0q), **loop)
    seen["fista"] = boxqp_fista.fista_mpc_res.launches
    vel_err = (res.xhats[20:, :, 3:6] - res.xs[21:, :, 3:6]).abs().mean().item()
    finite = all(bool(torch.isfinite(t).all()) for t in res)
    in_box = bool(((res.us >= LO) & (res.us <= HI)).all())
    log(f"closed loop: config #4 + kalman_estimator, {N_LOOP} scenarios x {T_LOOP} ticks, "
        f"{seen['fista']} K2 launches; controls in the box {in_box}, finite {finite}; mean "
        f"|velocity estimate error| after tick 20 {vel_err:.4e} (bound 0.1); mean |x| "
        f"{res.xs[0].norm(dim=-1).mean().item():.4e} -> "
        f"{res.xs[-1].norm(dim=-1).mean().item():.4e}")
    require(seen["fista"] == T_LOOP and in_box and finite and vel_err < 0.1,
            "the closed loop: one K2 launch per tick, in the box, finite, velocities tracked")
    launches = {k: c.launches for k, c in counters.items()}
    log(f"estimation-path launches: {launches}")
    require(launches == {"kf": 2, "rts": 1, "ekf": 1, "ukf": 1, "fista": T_LOOP},
            "the estimation path went through K9 twice, K10, K11, K12 once, K2 once per tick")

    # -- phase 13: times --------------------------------------------------------
    slow = {"reps": 3, "inner": 1, "warmup": 1}
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    Ws, _, P_fs, invLs, logdets = shared_gains(A, C, Q, R, P0, T_KF)
    cst = logdets + 0.5 * np.log(2.0 * np.pi)
    ys_t = yss.transpose(0, 1).contiguous()
    kf_args = (A, C, Ws, invLs, logdets, x0s, ys_t)
    P_ps = filt.pred_covs[0]
    G_Ts = _chosolve(_chol(P_ps[1:]), A @ P_fs[:-1]).contiguous()
    xs_f_t, xs_p_t = filt.means.transpose(0, 1), filt.pred_means.transpose(0, 1)
    es_t = (xs_f_t[:-1] - torch.einsum("tnj,tjk->tnk", xs_p_t[1:], G_Ts)).contiguous()
    x_last = xs_f_t[-1].contiguous()
    out_kf = [torch.empty((T_KF, N_KF, 2), device=dev) for _ in range(3)]
    out_ll = torch.empty((N_KF,), device=dev)
    device_ms = {
        "kf": cuda_ms(lambda: lib.npt_kalman_mean(
            A.data_ptr(), C.data_ptr(), Ws.data_ptr(), invLs.data_ptr(), cst.data_ptr(),
            x0s.data_ptr(), ys_t.data_ptr(), None, out_kf[0].data_ptr(), out_kf[1].data_ptr(),
            out_ll.data_ptr(), N_KF, T_KF, 2, 1, stream)),
        "rts": cuda_ms(lambda: lib.npt_rts_mean(G_Ts.data_ptr(), es_t.data_ptr(), x_last.data_ptr(),
                                                out_kf[2].data_ptr(), N_KF, T_KF, 2, stream)),
    }
    # the nonlinear kernels' operands as their wrappers check and lay them out
    pl, me, ins, outs = ekf.kernel_operands(f, h, *args, what="EKF")
    ptrs = [t.data_ptr() for t in ins] + [outs[k].data_ptr() for k in (0, 2, 1, 3, 4)]
    floats = ekf.plant_floats(pl)
    device_ms["ekf"] = cuda_ms(lambda: lib.npt_ekf(pl.plant_id, *floats, me.measure_id, me.p,
                                                   *ptrs, N_NL, T_KF, stream))
    weights = [ctypes.c_float(w) for w in ukf.sigma_weights(2, 1.0, 2.0, 0.0) + (ukf.JITTER,)]
    device_ms["ukf"] = cuda_ms(lambda: lib.npt_ukf(pl.plant_id, *floats, me.measure_id, me.p,
                                                   *weights, *ptrs, N_NL, T_KF, stream))
    ms = {
        "kf": cuda_ms(lambda: kalman_mean.kalman_mean_pass(*kf_args)),
        "rts": cuda_ms(lambda: rts_mean.rts_mean_pass(G_Ts, es_t, x_last)),
        "ekf": cuda_ms(lambda: ekf.ekf_batched(f, h, *args)),
        "ukf": cuda_ms(lambda: ukf.ukf_batched(f, h, *args)),
    }
    plain_ms = {
        "kf": cuda_ms(lambda: kalman_mean.kalman_mean_pass_reference(*kf_args)),
        "rts": cuda_ms(lambda: rts_mean.rts_mean_pass_reference(G_Ts, es_t, x_last)),
        "ekf": cuda_ms(lambda: ekf.ekf_reference(f, h, *args), **slow),
        "ukf": cuda_ms(lambda: ukf.ukf_reference(f, h, *args), **slow),
    }
    entry_ms = {
        "kf": cuda_ms(lambda: kalman_filter_batched(*kf, x0s, P0, yss), **slow),
        "kf_sqrt": cuda_ms(lambda: kalman_filter_sqrt_batched(*kf, x0s, P0, yss), **slow),
        "rts": cuda_ms(lambda: kalman_smoother_batched(A, filt), **slow),
        "ekf": cuda_ms(lambda: ekf_filter_batched(f, h, *args)),
        "ukf": cuda_ms(lambda: ukf_filter_batched(f, h, *args)),
    }
    names = {"kf": "K9 kalman_mean", "rts": "K10 rts_mean", "ekf": "K11 ekf", "ukf": "K12 ukf"}
    shapes = {"kf": f"N={N_KF} T={T_KF} n=2 p=1", "rts": f"N={N_KF} T={T_KF} n=2",
              "ekf": f"pendulum N={N_NL} T={T_KF}", "ukf": f"pendulum N={N_NL} T={T_KF}"}
    for key in names:
        log(f"time {names[key]} {shapes[key]}: device {device_ms[key]:.4f} ms, wrapper "
            f"{ms[key]:.4f} ms, plain {plain_ms[key]:.4f} ms [{smi}]")
    for key, fn in (("kf", lambda: kalman_mean.kalman_mean_pass(*kf_args)),
                    ("rts", lambda: rts_mean.rts_mean_pass(G_Ts, es_t, x_last)),
                    ("ekf", lambda: ekf.ekf_batched(f, h, *args)),
                    ("ukf", lambda: ukf.ukf_batched(f, h, *args))):
        log_own(f"{names[key]} {shapes[key]}", fn, f"{names[key].split()[1]}_kernel", ms[key],
                smi)
    kf_args_u = kf_args + ((uss @ Bu.T).transpose(0, 1).contiguous(),)
    log_own(f"K9 kalman_mean {shapes['kf']} with inputs",
            lambda: kalman_mean.kalman_mean_pass(*kf_args_u), "kalman_mean_kernel",
            cuda_ms(lambda: kalman_mean.kalman_mean_pass(*kf_args_u)), smi)
    for name in ("unicycle_step", "planar_quadrotor_step"):
        f_, h_, args_ = nonlinear[name]
        log_own(f"K11 ekf {name.split('_step')[0]} N={N_NL} T={T_KF}",
                lambda: ekf.ekf_batched(f_, h_, *args_), "ekf_kernel",
                cuda_ms(lambda: ekf.ekf_batched(f_, h_, *args_)), smi)
    for key, entry, kern in (("kf", "kalman_filter_batched", "kf"),
                             ("kf_sqrt", "kalman_filter_sqrt_batched", "kf"),
                             ("rts", "kalman_smoother_batched", "rts"),
                             ("ekf", "ekf_filter_batched", "ekf"),
                             ("ukf", "ukf_filter_batched", "ukf")):
        log(f"time {entry} ({shapes[kern]}): {entry_ms[key]:.4f} ms, of it outside the kernel's "
            f"device time {1.0 - device_ms[kern] / entry_ms[key]:.1%} [{smi}]")
    once = {"reps": 1, "inner": 1, "warmup": 0}
    long_ms = {
        "sequential": cuda_ms(lambda: kalman_filter(*kf, x0, P0, ys_long), **once),
        "associative": cuda_ms(lambda: kalman_filter_associative(*kf, x0, P0, ys_long), **slow),
        "associative nopivot": cuda_ms(
            lambda: kalman_filter_associative(*kf, x0, P0, ys_long, nopivot=True), **slow),
    }
    for what, t_ms in long_ms.items():
        log(f"time kalman_filter {what} T={T_LONG}: {t_ms:.4f} ms [{smi}]")
    holder = [ctrl.callback_init(N_LOOP), make(x0q)]
    x_now = res.xs[-1].contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)

    def tick():
        step = simulate_closed_loop(plant, ctrl.callback(), holder[0], x_now, 1, generator=gen,
                                    est_state0=holder[1], **loop)
        return step

    log(f"time one closed-loop tick ({N_LOOP} scenarios: MPC solve, plant, noise, Kalman "
        f"update): {cuda_ms(tick, reps=5, inner=5, warmup=2):.4f} ms [{smi}]")

    # operations counted from the kernels' loops (per trajectory and step)
    n, p, T_ = 2, 1, T_KF
    kf_bytes = 4 * (n * n + p * n + T_ * (p * n + p * p + 1) + N_KF * n + T_ * N_KF * p
                    + 2 * T_ * N_KF * n + N_KF)
    kf_ops = N_KF * T_ * (2 * n * n + 4 * p * n + 2 * p * p + 2 * p + 3)
    rts_bytes = 4 * ((T_ - 1) * n * n + (T_ - 1) * N_KF * n + N_KF * n + T_ * N_KF * n)
    rts_ops = N_KF * (T_ - 1) * 2 * n * n
    m = 1
    nl_bytes = 4 * (N_NL * n + N_NL * T_ * (p + m) + 2 * n * n + p * p + 2 * N_NL * T_ * n
                    + 2 * N_NL * T_ * n * n + N_NL)
    po = PLANT_OPS["pendulum_step"]
    update_ops = 2 * p * p * n * 2 + 4 * p * n + p * n * (n + 1) + p ** 3 / 3 + p * p + 4 * p + 4
    ekf_ops = N_NL * T_ * (3 * n * po + 2 * n ** 3 + n * n * (n + 1) + 2 * p * n * n
                           + p * (p + 1) * n + update_ops)
    K = 2 * n + 1
    ukf_ops = N_NL * T_ * (2 * (n ** 3 / 3 + 3 * n * n) + K * po + 2 * K * n
                           + 5 * K * n * (n + 1) // 2 + 2 * K * p + 5 * K * p * (p + 1) // 2
                           + 5 * K * n * p + 2 * p * p * n + update_ops)
    return [
        kernel_entry("kalman_mean_pass", "kalman_mean.cu", "kalman_batched.py:93",
                     launches["kf"], err["kf"], ms["kf"], plain_ms["kf"], kf_bytes, kf_ops),
        kernel_entry("rts_mean_pass", "rts_mean.cu", "rts_batched.py:66", launches["rts"],
                     err["rts"], ms["rts"], plain_ms["rts"], rts_bytes, rts_ops),
        kernel_entry("ekf_batched", "ekf.cu", "ekf.py:190", launches["ekf"], err["ekf"],
                     ms["ekf"], plain_ms["ekf"], nl_bytes, ekf_ops),
        kernel_entry("ukf_batched", "ukf.cu", "ukf.py:239", launches["ukf"], err["ukf"],
                     ms["ukf"], plain_ms["ukf"], nl_bytes, ukf_ops),
    ]


def relative_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| / (1 + |b|), the bench's measure of two final MPPI costs
    (bench.py:1616-1619)."""
    return (a.double() - b.double()).abs() / (1.0 + b.double().abs())


def sampling_family(dev, smi: str) -> list:
    """Phases 14-16: MPPI with K13, the particle filter with K14, OSQP and
    MHE, and their times. Returns the kernels' entries of the JSON line."""
    import functools

    from numpower_tpu_torch.kernels import _build, mppi, pf_resample
    from numpower_tpu_torch.models import (
        condense, double_integrator, first_components, kalman_filter, kalman_filter_batched,
        kalman_smoother, mhe_solve, mppi_solve_batched, particle_filter_batched, pendulum_step,
        quadratic_mppi_cost, quadrotor12, rollout_nonlinear, solve_mpc_state_constrained,
        unicycle_step,
    )
    from numpower_tpu_torch.models.condensed import CondensedQP
    from numpower_tpu_torch.models.mppi import _trajectory_cost
    from numpower_tpu_torch.models.particle import _resample_slots, _systematic_resample

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # -- phase 14: MPPI at the bench's shape (bench.py:546-572) ----------------
    cost_p = quadratic_mppi_cost(np.diag([1.0, 0.1]), np.eye(1) * 0.01, np.diag([100.0, 10.0]),
                                 np.zeros(2))
    x0s = t32(np.random.default_rng(8).uniform(-np.pi, np.pi, (N_MPPI, 2)))
    cost_u = quadratic_mppi_cost(np.diag([1.0, 1.0, 0.0]), np.eye(2) * 0.01,
                                 np.diag([50.0, 50.0, 0.0]), np.array([1.0, 1.0, 0.0]))
    x0u = t32(0.3 * np.random.default_rng(9).standard_normal((N_MPPI_SMALL, 3)))
    warm = t32(0.3 * np.random.default_rng(10).standard_normal(T_MPPI))

    def final_cost(f, cost, x, us):
        return _trajectory_cost(cost, rollout_nonlinear(f, x, us), us)

    # (name, plant, cost, x0s, m, options of the solve, warm start)
    cases = [("pendulum", pendulum_step, cost_p, x0s, 1, {}, None),
             ("pendulum box+-2 sigma 0.7 lam 0.5", pendulum_step, cost_p, x0s, 1,
              dict(u_lo=-2.0, u_hi=2.0, sigma=0.7, lam=0.5), None),
             ("pendulum warm start", pendulum_step, cost_p, x0s, 1, {}, warm),
             ("unicycle", unicycle_step, cost_u, x0u, 2,
              dict(sigma=(1.0, 0.5), lam=0.5), None)]
    err = {"mppi": 0.0, "resample": 0.0}
    for name, f, cost, x, m_, opts, us0 in cases:
        lam, sigma = opts.get("lam", 1.0), opts.get("sigma", 1.0)
        box = dict(u_lo=opts.get("u_lo"), u_hi=opts.get("u_hi"))
        us0 = torch.zeros(T_MPPI * m_, device=dev) if us0 is None else us0
        for iters in (2, IT_MPPI):
            eps = mppi.eps_kernel_layout(gen(iters), x.shape[0], iters, T_MPPI, m_, K_MPPI, sigma)
            kw = dict(T=T_MPPI, iters=iters, m=m_, lam=lam, sigma=sigma, **box)
            us, ess = mppi.mppi_fused(f, cost, x, eps, us0, **kw)
            us_p, ess_p = mppi.mppi_fused_reference(f, cost.rows, x, eps, us0, **kw)
            if iters == 2:
                du = max_err(us, us_p)
                d_ess = ((ess.double() - ess_p.double()) / ess_p.double()).abs().max().item()
                log(f"K13 mppi {name} N={x.shape[0]} K={K_MPPI} T={T_MPPI} iters=2 vs plain: "
                    f"max|dus| {du:.3e} (bound 2e-3), max rel dess {d_ess:.3e} (bound 1e-3)")
                require(du <= 2e-3 and d_ess <= 1e-3, f"K13 {name} iters=2 vs plain")
                err["mppi"] = max(err["mppi"], du)
            else:
                rel = relative_cost(final_cost(f, cost, x, us), final_cost(f, cost, x, us_p))
                log(f"K13 mppi {name} iters={iters} vs plain: relative final cost median "
                    f"{rel.median().item():.3e} (bound 5e-2), max {rel.max().item():.3e}")
                require(rel.median().item() <= 5e-2, f"K13 {name} iters={iters} vs plain")

    # the path: mppi_solve_batched, counted
    mppi.mppi_fused.launches = 0
    solves = {}
    for stream in ("exact", "direct"):
        before = mppi.mppi_fused.launches
        solves[stream] = mppi_solve_batched(pendulum_step, x0s, cost_p, T_MPPI, gen(0),
                                            samples=K_MPPI, iters=IT_MPPI, m=1, eps_stream=stream)
        require(mppi.mppi_fused.launches == before + 1,
                f"mppi_solve_batched eps_stream={stream}: one K13 launch")
    launches_mppi = mppi.mppi_fused.launches
    plain = mppi_solve_batched(pendulum_step, x0s, cost_p, T_MPPI, gen(0), method="xla",
                               samples=K_MPPI, iters=IT_MPPI, m=1)
    zero = torch.zeros((N_MPPI, T_MPPI, 1), device=dev)
    cost0 = final_cost(pendulum_step, cost_p, x0s, zero)
    rel = relative_cost(solves["exact"].cost, plain.cost)
    log(f"mppi_solve_batched N={N_MPPI} K={K_MPPI} T={T_MPPI} iters={IT_MPPI} (auto -> K13, "
        f"{launches_mppi} launches for 2 calls): median final cost exact "
        f"{solves['exact'].cost.median().item():.4e}, direct "
        f"{solves['direct'].cost.median().item():.4e}, plain route "
        f"{plain.cost.median().item():.4e}, zero control {cost0.median().item():.4e}; "
        f"exact vs plain route relative cost median {rel.median().item():.3e}")
    require(launches_mppi == 2 and rel.median().item() <= 5e-2
            and all(bool(torch.isfinite(s.cost).all()) for s in solves.values())
            and all(s.cost.median().item() < cost0.median().item() for s in solves.values()),
            "mppi_solve_batched: one K13 launch per call, below zero control, near the plain route")

    # -- phase 15: the particle filter at the bench's shape (bench.py:644-693) --
    for B_k, N_k, n_k, spike in ((B_PF, N_PF, 2, False), (B_PF, N_PF, 2, True),
                                 (B_PF, N_PF - 1, 2, True), (7, 12289, 3, False)):
        r = np.random.default_rng(N_k + n_k)
        parts = t32(r.standard_normal((B_k, N_k, n_k)))
        logw = t32(2.0 * r.standard_normal((B_k, N_k)))
        if spike:
            logw[::3, N_k // 3] = 40.0  # one particle takes (nearly) all the weight
        m_k = _resample_slots(t32(r.uniform(size=B_k)), logw, N_k)
        out = pf_resample.resample_systematic(parts, m_k)
        ref = pf_resample.resample_systematic_reference(parts, m_k)
        d = max_err(out, ref)
        log(f"K14 resample B={B_k} N={N_k} n={n_k} spike={spike} vs plain: max|d| {d:.3e} "
            f"(element-exact: {torch.equal(out, ref)})")
        require(torch.equal(out, ref), f"K14 at B={B_k} N={N_k} vs plain")
        err["resample"] = max(err["resample"], d)
    pf_args = (pendulum_step, functools.partial(first_components, k=1), t32(np.eye(2) * 1e-4),
               t32(np.eye(1) * 2.5e-3))
    r = np.random.default_rng(12)
    x0_pf = t32(0.3 * r.standard_normal((B_PF, 2)))
    ys_pf = t32(r.standard_normal((B_PF, T_PF, 1)))
    us_pf = torch.zeros((B_PF, T_PF, 1), device=dev)
    pf_data = (x0_pf, t32(np.eye(2)), ys_pf, us_pf)
    pf_resample.resample_systematic.launches = 0
    pf = particle_filter_batched(*pf_args, *pf_data, gen(0), n_particles=N_PF)
    launches_pf = pf_resample.resample_systematic.launches
    pf_g = particle_filter_batched(*pf_args, *pf_data, gen(0), n_particles=N_PF,
                                   resample_method="gather")
    dpf = {k: max_err(getattr(pf, k), getattr(pf_g, k)) for k in ("means", "log_likelihood",
                                                                   "ess")}
    log(f"particle_filter_batched B={B_PF} N={N_PF} T={T_PF} (auto -> K14, {launches_pf} "
        f"launches) vs resample_method=gather: max|d| {dpf}; ess min "
        f"{pf.ess.min().item():.1f}, ll median {pf.log_likelihood.median().item():.4e}")
    require(launches_pf == T_PF and all(v <= 1e-6 for v in dpf.values())
            and bool(torch.isfinite(pf.log_likelihood).all()),
            "particle_filter_batched: one K14 launch per step, the same filter as gather")
    # PF against the Kalman filter on a linear Gaussian plant (the bound of
    # tests/test_estimation.py:487-509), with the bench's trajectory count
    A_di = t32(double_integrator(0.1).A)
    Q_di, R_di, P0_di = t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2), t32(np.eye(2) * 0.1)
    x_true = np.tile([1.0, 0.0], (B_PF, 1))
    ys_lin = np.empty((B_PF, T_PF, 1))
    An = np.asarray(double_integrator(0.1).A, np.float64)
    for t in range(T_PF):
        x_true = x_true @ An.T + r.multivariate_normal(np.zeros(2), np.eye(2) * 1e-3, B_PF)
        ys_lin[:, t, 0] = x_true[:, 0] + r.normal(0.0, 0.1, B_PF)
    ys_lin = t32(ys_lin)
    x0_lin = t32(np.tile([1.0, 0.0], (B_PF, 1)))
    kf = kalman_filter_batched(A_di, t32([[1.0, 0.0]]), Q_di, R_di, x0_lin, P0_di, ys_lin)
    pf_lin = particle_filter_batched(lambda x, u: x @ A_di.T, pf_args[1], Q_di, R_di, x0_lin,
                                     P0_di, ys_lin, torch.zeros((B_PF, T_PF, 1), device=dev),
                                     gen(1), n_particles=4 * N_PF)
    mean_err = (pf_lin.means - kf.means).abs().mean(dim=(1, 2))
    scale = kf.means.abs().mean(dim=(1, 2)).clamp(min=1.0)
    ll_err = (pf_lin.log_likelihood - kf.log_likelihood).abs()
    ll_bound = (0.02 * kf.log_likelihood.abs()).clamp(min=2.0)
    log(f"particle filter ({4 * N_PF} particles) vs kalman_filter_batched, {B_PF} linear "
        f"Gaussian trajectories: mean |dx| / scale max {(mean_err / scale).max().item():.3e} "
        f"(bound 5e-2), |dll| / bound max {(ll_err / ll_bound).max().item():.3e} (bound 1)")
    require(bool((mean_err < 0.05 * scale).all()) and bool((ll_err < ll_bound).all()),
            "particle filter within the Monte Carlo bound of the Kalman filter")

    # -- phase 16: OSQP and MHE ---------------------------------------------------
    Aq, Bq = quadrotor12(0.02)
    nq = Aq.shape[0]
    qp = condense(Aq, Bq, np.eye(nq), np.eye(4) * 0.1, np.eye(nq) * 5.0, T, device=dev)
    qp64 = CondensedQP(**{k: getattr(qp, k).double() for k in
                          ("H", "Sx", "Su", "SuTQ", "lipschitz", "mu")},
                       T=qp.T, n=qp.n, m=qp.m, kappa=qp.kappa)
    x0q = t32(0.3 * np.random.default_rng(0).standard_normal((N, nq)))
    osqp_cases = {"loose": (-1e6, 1e6), "tight": (-1.0, 1.0)}
    for name, (lo, hi) in osqp_cases.items():
        res = solve_mpc_state_constrained(qp, x0q, LO, HI, lo, hi, iters=60)
        res64 = solve_mpc_state_constrained(qp64, x0q.double(), LO, HI, lo, hi, iters=60)
        dU = max_err(res.U, res64.U)
        # the states of the solution X = Sx x0 + Su U, and how many scenarios
        # meet a state bound (within 1e-3) somewhere on the horizon
        X = x0q @ qp.Sx.T + res.U @ qp.Su.T
        active = int(((X - lo).abs().min(dim=1).values <= 1e-3).sum()
                     + ((X - hi).abs().min(dim=1).values <= 1e-3).sum())
        log(f"solve_mpc_state_constrained config #4 N={N} states {name} [{lo:g}, {hi:g}], 60 "
            f"iters: max|dU| vs float64 {dU:.3e}; primal residual {res.primal_residual.item():.3e}"
            f" (float64 {res64.primal_residual.item():.3e}), dual {res.dual_residual.item():.3e};"
            f" scenarios at a state bound {active}; max |X| {X.abs().max().item():.3e}")
        controls = res.Z[:, :qp.H.shape[0]]
        require(bool(torch.isfinite(res.U).all()) and dU <= 1e-3
                and bool(((controls >= LO) & (controls <= HI)).all()),
                f"state-constrained MPC ({name}) against float64")
    C_di = t32([[1.0, 0.0]])
    ys_mhe = t32(np.random.default_rng(13).standard_normal((N_MHE_WINDOWS, M_MHE, 1)) * 0.1
                 + np.linspace(1.0, 1.1, M_MHE)[None, :, None])
    x_prior = t32(np.tile([1.0, 0.0], (N_MHE_WINDOWS, 1))
                  + 0.1 * np.random.default_rng(14).standard_normal((N_MHE_WINDOWS, 2)))
    mhe = mhe_solve(A_di, C_di, Q_di, R_di, P0_di, x_prior, ys_mhe)
    sm = kalman_smoother(A_di, kalman_filter(A_di, C_di, Q_di, R_di, x_prior, P0_di, ys_mhe))
    d_mhe = max_err(mhe.xs[:, 1:], sm.means)
    log(f"mhe_solve {N_MHE_WINDOWS} windows M={M_MHE} (double integrator) vs kalman_smoother: "
        f"max|dx| {d_mhe:.3e} (rtol 5e-3, atol 5e-4)")
    require(close(mhe.xs[:, 1:], sm.means, 5e-3, 5e-4), "batched MHE equals the RTS smoother")

    # -- times ------------------------------------------------------------------
    slow = {"reps": 3, "inner": 1, "warmup": 1}
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    eps = mppi.eps_kernel_layout(gen(0), N_MPPI, IT_MPPI, T_MPPI, 1, K_MPPI, 1.0)
    us0 = torch.zeros(T_MPPI, device=dev)
    kw = dict(T=T_MPPI, iters=IT_MPPI, m=1, lam=1.0, sigma=1.0)
    # a direct library call: the wrapper's arguments, made once (the
    # tensors they point to held beside them)
    k13_args, k13_held = mppi.kernel_args(pendulum_step, cost_p, x0s, eps, us0, **kw)
    ms = {"mppi_device": cuda_ms(lambda: lib.npt_mppi(*k13_args, stream)),
          "mppi": cuda_ms(lambda: mppi.mppi_fused(pendulum_step, cost_p, x0s, eps, us0, **kw)),
          "mppi_plain": cuda_ms(lambda: mppi.mppi_fused_reference(
              pendulum_step, cost_p.rows, x0s, eps, us0, **kw), **slow),
          "eps_exact": cuda_ms(lambda: mppi.eps_kernel_layout(gen(0), N_MPPI, IT_MPPI, T_MPPI, 1,
                                                              K_MPPI, 1.0)),
          "eps_direct": cuda_ms(lambda: mppi.eps_direct_layout(gen(0), N_MPPI, IT_MPPI, T_MPPI,
                                                               1, K_MPPI, 1.0)),
          "mppi_solve": cuda_ms(lambda: mppi_solve_batched(
              pendulum_step, x0s, cost_p, T_MPPI, gen(0), samples=K_MPPI, iters=IT_MPPI, m=1)),
          "mppi_solve_direct": cuda_ms(lambda: mppi_solve_batched(
              pendulum_step, x0s, cost_p, T_MPPI, gen(0), samples=K_MPPI, iters=IT_MPPI, m=1,
              eps_stream="direct")),
          "mppi_solve_plain": cuda_ms(lambda: mppi_solve_batched(
              pendulum_step, x0s, cost_p, T_MPPI, gen(0), method="xla", samples=K_MPPI,
              iters=IT_MPPI, m=1), **slow)}
    rollouts = N_MPPI * K_MPPI * IT_MPPI
    inside = ms["eps_exact"] + ms["mppi_device"]
    log(f"time K13 mppi N={N_MPPI} K={K_MPPI} T={T_MPPI} iters={IT_MPPI}: device "
        f"{ms['mppi_device']:.4f} ms, wrapper {ms['mppi']:.4f} ms, plain {ms['mppi_plain']:.4f} "
        f"ms; eps draw exact {ms['eps_exact']:.4f} ms, direct {ms['eps_direct']:.4f} ms [{smi}]")
    log(f"time mppi_solve_batched (auto -> K13): exact {ms['mppi_solve']:.4f} ms "
        f"({rollouts / ms['mppi_solve'] * 1e3:.4e} rollouts/s), direct "
        f"{ms['mppi_solve_direct']:.4f} ms ({rollouts / ms['mppi_solve_direct'] * 1e3:.4e} "
        f"rollouts/s); the plain route {ms['mppi_solve_plain']:.4f} ms; outside the eps draw "
        f"and K13's device time {1.0 - inside / ms['mppi_solve']:.1%} [{smi}]")
    # K13's device time at 16 times the scenarios (eps 1.3 GB, drawn directly
    # in the kernel's layout), where the blocks no longer fit in one wave
    x0_big = x0s.repeat(N_MPPI_BIG // N_MPPI, 1).contiguous()
    eps_big = mppi.eps_direct_layout(gen(1), N_MPPI_BIG, IT_MPPI, T_MPPI, 1, K_MPPI, 1.0)
    big_args, big_held = mppi.kernel_args(pendulum_step, cost_p, x0_big, eps_big, us0, **kw)
    big_ms = cuda_ms(lambda: lib.npt_mppi(*big_args, stream), reps=3, inner=3, warmup=1)
    big_bound = 4 * IT_MPPI * T_MPPI * N_MPPI_BIG * K_MPPI / HBM_BYTES_PER_S * 1e3
    log(f"time K13 mppi device N={N_MPPI_BIG} K={K_MPPI} T={T_MPPI} iters={IT_MPPI}: "
        f"{big_ms:.4f} ms (eps bytes bound {big_bound:.4f} ms) [{smi}]")
    log_own(f"K13 mppi N={N_MPPI} K={K_MPPI} T={T_MPPI} iters={IT_MPPI}",
            lambda: mppi.mppi_fused(pendulum_step, cost_p, x0s, eps, us0, **kw), "mppi_kernel",
            ms["mppi"], smi)
    log_own(f"K13 mppi N={N_MPPI_BIG} K={K_MPPI} T={T_MPPI} iters={IT_MPPI} (direct call)",
            lambda: lib.npt_mppi(*big_args, stream), "mppi_kernel", big_ms, smi, calls=10)
    del eps_big, big_args, big_held

    parts = pf.particles.contiguous()
    logw_t = t32(2.0 * np.random.default_rng(15).standard_normal((B_PF, N_PF)))
    u0_t = t32(np.random.default_rng(16).uniform(size=B_PF))
    m_t = _resample_slots(u0_t, logw_t, N_PF)
    out_t = torch.empty_like(parts)
    counts = torch.diff(m_t, dim=1, prepend=torch.zeros_like(m_t[:, :1])).reshape(-1).long()
    flat = parts.reshape(B_PF * N_PF, 2)
    ms.update({
        "res_device": cuda_ms(lambda: lib.npt_resample_systematic(
            parts.data_ptr(), m_t.data_ptr(), out_t.data_ptr(), B_PF, N_PF, 2, stream)),
        "res": cuda_ms(lambda: pf_resample.resample_systematic(parts, m_t)),
        "res_plain": cuda_ms(lambda: pf_resample.resample_systematic_reference(parts, m_t)),
        "res_library": cuda_ms(lambda: flat.repeat_interleave(counts, dim=0,
                                                              output_size=B_PF * N_PF)),
        "res_step_pallas": cuda_ms(lambda: _systematic_resample(u0_t, parts, logw_t, "pallas")),
        "res_step_gather": cuda_ms(lambda: _systematic_resample(u0_t, parts, logw_t, "gather")),
        "res_step_onehot": cuda_ms(lambda: _systematic_resample(u0_t, parts, logw_t, "onehot"),
                                   **slow),
        "pf": cuda_ms(lambda: particle_filter_batched(*pf_args, *pf_data, gen(0),
                                                      n_particles=N_PF), **slow),
        "pf_gather": cuda_ms(lambda: particle_filter_batched(
            *pf_args, *pf_data, gen(0), n_particles=N_PF, resample_method="gather"), **slow),
    })
    steps = B_PF * N_PF * T_PF
    log_own(f"K14 resample B={B_PF} N={N_PF} n=2",
            lambda: pf_resample.resample_systematic(parts, m_t), "resample_kernel", ms["res"], smi)
    log(f"time K14 resample B={B_PF} N={N_PF} n=2 per step: device {ms['res_device']:.4f} ms, "
        f"wrapper {ms['res']:.4f} ms, plain {ms['res_plain']:.4f} ms, repeat_interleave "
        f"{ms['res_library']:.4f} ms; a whole resample step (slots + cloud) by pallas "
        f"{ms['res_step_pallas']:.4f} ms, gather {ms['res_step_gather']:.4f} ms, onehot "
        f"{ms['res_step_onehot']:.4f} ms [{smi}]")
    log(f"time particle_filter_batched B={B_PF} N={N_PF} T={T_PF}: auto (K14) {ms['pf']:.4f} ms "
        f"({steps / ms['pf'] * 1e3:.4e} particle-steps/s), gather {ms['pf_gather']:.4f} ms "
        f"[{smi}]")
    osqp_ms = {name: cuda_ms(lambda lo=lo, hi=hi: solve_mpc_state_constrained(
        qp, x0q, LO, HI, lo, hi, iters=60), **slow) for name, (lo, hi) in osqp_cases.items()}
    mhe_ms = cuda_ms(lambda: mhe_solve(A_di, C_di, Q_di, R_di, P0_di, x_prior, ys_mhe), **slow)
    log(f"time solve_mpc_state_constrained config #4 N={N} 60 iters: loose "
        f"{osqp_ms['loose']:.4f} ms, tight {osqp_ms['tight']:.4f} ms; mhe_solve "
        f"{N_MHE_WINDOWS} windows M={M_MHE}: {mhe_ms:.4f} ms [{smi}]")

    # K13: eps read once, x0s, us0, us and ess; per (sample, round, step) the
    # candidate and its clip, the quadratic stage cost, the coupling, the
    # plant and the update's weighted term; per (sample, round) the terminal
    # cost and the softmax
    n, m_ = 2, 1
    mppi_bytes = 4 * (IT_MPPI * T_MPPI * m_ * N_MPPI * K_MPPI + N_MPPI * n + T_MPPI * m_
                      + N_MPPI * T_MPPI * m_ + N_MPPI * IT_MPPI)
    per_step = 3 * m_ + n + 3 * n * n + 3 * m_ * m_ + 1 + 4 * m_ + PLANT_OPS["pendulum_step"] \
        + 6 * m_
    mppi_ops = IT_MPPI * N_MPPI * K_MPPI * (T_MPPI * per_step + 3 * n * n + n + 10)
    # K14: the cloud read once and written once, the slot boundaries read
    # once; a binary search of log2(N) comparisons per slot
    res_bytes = 4 * (2 * B_PF * N_PF * 2 + B_PF * N_PF)
    res_ops = B_PF * N_PF * math.ceil(math.log2(N_PF))
    return [
        kernel_entry("mppi_fused", "mppi.cu", "mppi.py:112", launches_mppi, err["mppi"],
                     ms["mppi"], ms["mppi_plain"], mppi_bytes, mppi_ops),
        kernel_entry("resample_systematic", "pf_resample.cu", "pf_resample.py:60", launches_pf,
                     err["resample"], ms["res"], ms["res_plain"], res_bytes, res_ops,
                     library_ms=ms["res_library"]),
    ]


def boxqp_variants_and_mesh(dev, smi: str, qp, x0s, rho) -> list:
    """Phases 17-19: K1' and K2', K1's loop forms and the precision classes
    of K1 and K2 against their plain versions; the data-parallel path on a
    one-rank NCCL group; their times. Returns K1''s and K2''s entries of the
    JSON line."""
    import os
    import tempfile

    import torch.distributed as dist

    from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista
    from numpower_tpu_torch.kernels.precision import PRECISION_CODES
    from numpower_tpu_torch.models import MPCController, quadrotor12
    from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters
    from numpower_tpu_torch.parallel import (
        make_mesh, shard_batch, solve_mpc_boxqp_admm_dp, solve_mpc_boxqp_dp,
    )

    iters, n, m = 40, 12, 4
    d = T * m
    fista_ci, admm_ci = default_coarse_iters(qp, iters), admm_coarse_iters(qp, iters)
    fold, lip = (qp.H, qp.Sx.T, qp.SuTQ.T), qp.lipschitz
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    z_cold, _, _ = boxqp_admm.admm_mpc_res_reference(*fold, x0s, LO, HI, rho, iters, admm_ci,
                                                     Minv=Minv)
    U0 = torch.cat([z_cold[:, m:], z_cold[:, -m:]], dim=1).contiguous()  # a shifted plan

    # -- phase 17: K1', K2', the forms and the precision classes vs plain ---------
    err = {"fista_g": 0.0, "admm_g": 0.0}
    before = (boxqp_fista.fista_mpc.launches, boxqp_admm.admm_mpc.launches)
    for coarse_f, coarse_a, tol in ((0, 0, 1e-5), (fista_ci, admm_ci, 1e-4)):
        U, g = boxqp_fista.fista_mpc(*fold, x0s, LO, HI, lip, iters, coarse_f)
        U_p, g_p = boxqp_fista.fista_mpc_reference(*fold, x0s, LO, HI, lip, iters, coarse_f)
        z, y, g_a = boxqp_admm.admm_mpc(*fold, x0s, LO, HI, rho, iters, coarse_a, Minv=Minv)
        z_p, y_p, _ = boxqp_admm.admm_mpc_reference(*fold, x0s, LO, HI, rho, iters, coarse_a,
                                                    Minv=Minv)
        du, dz, dy = max_err(U, U_p), max_err(z, z_p), max_err(y, y_p)
        dg, dg_a = max_err(g, g_p), max_err(g_a, g_p)
        g_scale = g_p.abs().max().item()
        U_two = boxqp_fista.fista_boxqp(qp.H, g, LO, HI, lip, iters, coarse_f)
        z_two, y_two = boxqp_admm.admm_boxqp(qp.H, g_a, LO, HI, rho, iters, coarse_a, Minv=Minv)
        e_two = (max_err(U, U_two), max(max_err(z, z_two), max_err(y, y_two)))
        log(f"K2' fista_mpc {coarse_f}+{iters - coarse_f}: max|dU| {du:.3e}, max|dg| {dg:.3e} "
            f"(|g| <= {g_scale:.3e}); K1' admm_mpc {coarse_a}+{iters - coarse_a}: max|dz| "
            f"{dz:.3e} max|dy| {dy:.3e} max|dg| {dg_a:.3e} (tol {tol:g}, g 1e-5 relative); "
            f"against K3b / K3a on the g they emit {e_two[0]:.3e} / {e_two[1]:.3e}")
        require(du <= tol and dz <= tol and dy <= tol and max(dg, dg_a) <= 1e-5 * g_scale,
                f"K1'/K2' {coarse_f}/{coarse_a} vs plain")
        require(max(e_two) <= 1e-5, "K2' == K3b and K1' == K3a on their g")
        err["fista_g"] = max(err["fista_g"], du, dg)
        err["admm_g"] = max(err["admm_g"], dz, dy, dg_a)
    require((boxqp_fista.fista_mpc.launches, boxqp_admm.admm_mpc.launches)
            == (before[0] + 2, before[1] + 2), "K1'/K2' launched once per call")

    variants = [("admm", {"form": f}) for f in ("zy", "sp")]
    variants += [("admm", {"c_precision": c}) for c in ("bf16x4", "bf16x3")]
    variants += [("fista", {"tail_precision": t, "g_precision": gp})
                 for t in ("bf16x3", "highest") for gp in ("highest", "bf16x4", "bf16x3")
                 if (t, gp) != ("highest", "highest")]
    # The bf16x3 tail drops lo*lo, which depends on where an operand's hi/lo
    # split falls: operands one ulp apart (two sum orders) can split on either
    # side of a bf16 rounding point, so two correct fp32 implementations of the
    # class part by up to ~1e-5 at this shape, where the classes with an fp32
    # tail part by under 2e-6: its all-fp32 bound is 3e-5.
    for solver, kw in variants:
        fp32_tol = 3e-5 if kw.get("tail_precision") == "bf16x3" else 1e-5
        for coarse, tol in ((0, fp32_tol), (admm_ci if solver == "admm" else fista_ci, 1e-4)):
            if solver == "admm":
                args = (*fold, x0s, LO, HI, rho, iters, coarse)
                out = boxqp_admm.admm_mpc_res(*args, Minv=Minv, U0=U0, **kw)
                ref = boxqp_admm.admm_mpc_res_reference(*args, Minv=Minv, U0=U0, **kw)
            else:
                args = (*fold, x0s, LO, HI, lip, iters, coarse, U0)
                out = boxqp_fista.fista_mpc_res(*args, **kw)
                ref = boxqp_fista.fista_mpc_res_reference(*args, **kw)
            de = max_err(out[0], ref[0])
            dr = max(abs(a.item() - b.item()) for a, b in zip(out[1:], ref[1:]))
            log(f"{'K1' if solver == 'admm' else 'K2'} {kw} {coarse}+{iters - coarse} warm: "
                f"max|d| {de:.3e} (tol {tol:g}), residuals {dr:.3e} (tol 1e-5)")
            require(de <= tol and dr <= 1e-5, f"{solver} {kw} {coarse} vs plain")

    # -- phase 18: the data-parallel path on a one-rank NCCL group ---------------
    A, B = quadrotor12(0.02)
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    A_t, B_t = torch.as_tensor(A, device=dev), torch.as_tensor(B, device=dev)
    U_direct, r_direct = boxqp_fista.fista_mpc_res(*fold, x0s, LO, HI, lip, iters, fista_ci)
    single = {}  # each solver's single-device closed loop: the states and the controls
    for solver in ("fista", "admm"):
        ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, solver=solver, device=dev)
        state, x, xs, us = ctrl.init(N), x0s.clone(), [], []
        for _ in range(N_TICKS):
            xs.append(x)
            u0, state = ctrl.step(state, x)
            us.append(u0.clone())
            x = x @ A_t.T + u0 @ B_t.T
        single[solver] = (ctrl, xs, us)
    counters = {"K2": boxqp_fista.fista_mpc_res, "K1": boxqp_admm.admm_mpc_res,
                "K2'": boxqp_fista.fista_mpc, "K1'": boxqp_admm.admm_mpc}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1))
            log(f"mesh {mesh.shape} {mesh.axis_names} on {mesh.device}, backend "
                f"{dist.get_backend()}")
            for c in counters.values():
                c.launches = 0
            xb = shard_batch(x0s, mesh)
            U_yard, _ = boxqp_fista.fista_mpc(*fold, xb, LO, HI, lip, iters, fista_ci)
            r_dp = solve_mpc_boxqp_dp(qp, xb, LO, HI, mesh, iters)
            z_yard, _, _ = boxqp_admm.admm_mpc(*fold, xb, LO, HI, rho, iters, admm_ci, Minv=Minv)
            r_admm = solve_mpc_boxqp_admm_dp(qp, xb, LO, HI, mesh, iters=iters)
            require({k: c.launches for k, c in counters.items()}
                    == {"K2": 1, "K1": 1, "K2'": 1, "K1'": 1},
                    "each DP solve launched its kernel once (auto on a CUDA mesh)")
            e = {"dp_direct": max_err(r_dp.U, U_direct),
                 "dp_resid": abs(r_dp.residual.item() - r_direct.item()),
                 "dp_k2p": max_err(r_dp.U, U_yard), "admm_k1p": max_err(r_admm.U, z_yard),
                 "admm_fista": max_err(r_admm.U, r_dp.U)}
            log(f"DP path ({N} scenarios): DP vs direct K2 {e['dp_direct']:.3e} (resid "
                f"{e['dp_resid']:.3e}; tol 1e-5), vs K2' {e['dp_k2p']:.3e} (tol 1e-5); ADMM-DP "
                f"vs K1' {e['admm_k1p']:.3e} (tol 1e-4); ADMM-DP vs FISTA-DP "
                f"{e['admm_fista']:.3e} (tol 2e-3)")
            require(e["dp_direct"] <= 1e-5 and e["dp_resid"] <= 1e-5 and e["dp_k2p"] <= 1e-5,
                    "DP equals the direct kernel (sharded_solvers_on_mesh)")
            require(e["admm_k1p"] <= 1e-4 and e["admm_fista"] <= 2e-3, "ADMM-DP")
            mesh_ctrls = {}
            for solver, key in (("fista", "K2"), ("admm", "K1")):
                _, xs, us = single[solver]
                ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, solver=solver,
                                     mesh=mesh)
                state, worst = ctrl.init(N), 0.0
                for t in range(N_TICKS):
                    before = counters[key].launches
                    u0, state = ctrl.step(state, shard_batch(xs[t], mesh))
                    require(counters[key].launches == before + 1,
                            f"mesh {solver} tick launched its kernel once")
                    worst = max(worst, max_err(u0, us[t]))
                log(f"mesh serving {solver}: {N_TICKS} ticks x {N} scenarios, max |u0 - "
                    f"single-device u0| {worst:.3e} (tol 1e-5)")
                require(worst <= 1e-5, f"mesh {solver} ticks equal the single-device ticks")
                mesh_ctrls[solver] = ctrl
            launches = {k: c.launches for k, c in counters.items()}
            log(f"DP-path launches: {launches}")
            require(launches == {"K2": 1 + N_TICKS, "K1": 1 + N_TICKS, "K2'": 1, "K1'": 1},
                    "the DP path went through K1, K2, K1' and K2'")

            # -- phase 19: times ----------------------------------------------------
            lib = _build.library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            Ht = qp.H.T.contiguous()
            W = (qp.Sx.T @ qp.SuTQ.T).contiguous()
            rho_t = rho.reshape(()).contiguous()
            rMt = (rho_t * Minv.T).contiguous()
            Wc = (qp.Sx.T @ (qp.SuTQ.T @ Minv.T)).contiguous()
            outs = [torch.empty((N, d), device=dev) for _ in range(3)]
            scal = [torch.zeros((), device=dev) for _ in range(2)]
            lo_hi = (ctypes.c_float(LO), ctypes.c_float(HI))
            alpha = ctypes.c_float(1.6)
            device_ms = {
                "fista_g": cuda_ms(lambda: lib.npt_fista_mpc(
                    Ht.data_ptr(), W.data_ptr(), x0s.data_ptr(), lip.data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), N, n, d, iters, fista_ci, *lo_hi,
                    stream)),
                "admm_g": cuda_ms(lambda: lib.npt_admm_mpc(
                    rMt.data_ptr(), W.data_ptr(), x0s.data_ptr(), rho_t.data_ptr(),
                    outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), N, n, d, iters,
                    admm_ci, *lo_hi, alpha, stream)),
            }
            codes = boxqp_admm.FORMS
            for form in ("s", "zy", "sp"):
                device_ms[f"K1 form {form}"] = cuda_ms(lambda form=form: lib.npt_admm_mpc_res(
                    rMt.data_ptr(), Wc.data_ptr(), x0s.data_ptr(), U0.data_ptr(),
                    rho_t.data_ptr(), outs[0].data_ptr(), scal[0].data_ptr(), scal[1].data_ptr(),
                    N, n, d, iters, admm_ci, *lo_hi, alpha, codes[form], 0, stream))
            for cp in ("bf16x4", "bf16x3"):
                device_ms[f"K1 c_precision {cp}"] = cuda_ms(lambda cp=cp: lib.npt_admm_mpc_res(
                    rMt.data_ptr(), Wc.data_ptr(), x0s.data_ptr(), U0.data_ptr(),
                    rho_t.data_ptr(), outs[0].data_ptr(), scal[0].data_ptr(), scal[1].data_ptr(),
                    N, n, d, iters, admm_ci, *lo_hi, alpha, 0, PRECISION_CODES[cp], stream))
            for tp in ("highest", "bf16x3"):
                for gp in ("highest", "bf16x4", "bf16x3"):
                    device_ms[f"K2 tail {tp} g {gp}"] = cuda_ms(
                        lambda tp=tp, gp=gp: lib.npt_fista_mpc_res(
                            Ht.data_ptr(), W.data_ptr(), x0s.data_ptr(), U0.data_ptr(),
                            lip.data_ptr(), outs[0].data_ptr(), scal[0].data_ptr(), N, n, d,
                            iters, fista_ci, *lo_hi, PRECISION_CODES[tp], PRECISION_CODES[gp],
                            stream))
            ms = {"fista_g": cuda_ms(lambda: boxqp_fista.fista_mpc(*fold, x0s, LO, HI, lip, iters,
                                                                   fista_ci)),
                  "admm_g": cuda_ms(lambda: boxqp_admm.admm_mpc(*fold, x0s, LO, HI, rho, iters,
                                                                admm_ci, Minv=Minv))}
            plain_ms = {
                "fista_g": cuda_ms(lambda: boxqp_fista.fista_mpc_reference(
                    *fold, x0s, LO, HI, lip, iters, fista_ci)),
                "admm_g": cuda_ms(lambda: boxqp_admm.admm_mpc_reference(
                    *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv))}
            for key, name in (("fista_g", "K2' fista_mpc"), ("admm_g", "K1' admm_mpc")):
                log(f"time {name} ({iters} iters, {N} scenarios): device {device_ms[key]:.4f} "
                    f"ms (FMA version {FMA_DEVICE_MS[key]}), wrapper {ms[key]:.4f} ms, plain "
                    f"{plain_ms[key]:.4f} ms [{smi}]")
            log_own(f"K2' fista_mpc ({iters} iters, {N} scenarios)", lambda: boxqp_fista.fista_mpc(
                *fold, x0s, LO, HI, lip, iters, fista_ci), "fista_kernel", ms["fista_g"], smi)
            log_own(f"K1' admm_mpc ({iters} iters, {N} scenarios)", lambda: boxqp_admm.admm_mpc(
                *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv), "admm_kernel", ms["admm_g"],
                smi)
            for key, t_ms in device_ms.items():
                if key.startswith("K"):
                    log(f"time {key} ({iters} iters, {N} scenarios, warm): device {t_ms:.4f} ms "
                        f"(FMA version {FMA_DEVICE_MS[key.split(' g ')[0]]}) [{smi}]")

            # the DP solve against the direct K2' (bench.py's shardmap overhead), in turns
            def direct():
                boxqp_fista.fista_mpc(*fold, xb, LO, HI, lip, iters, fista_ci)

            def dp():
                solve_mpc_boxqp_dp(qp, xb, LO, HI, mesh, iters)

            turns = [cuda_ms(direct), cuda_ms(dp), cuda_ms(dp), cuda_ms(direct)]
            t_direct, t_dp = statistics.mean(turns[0::3]), statistics.mean(turns[1:3])
            log(f"time DP solve vs direct K2' ({N} scenarios, one rank, in turns "
                f"direct/DP/DP/direct {turns[0]:.4f}/{turns[1]:.4f}/{turns[2]:.4f}/"
                f"{turns[3]:.4f} ms): overhead {100.0 * (t_dp / t_direct - 1.0):.1f}% "
                f"(the JAX package's bar: < 10%) [{smi}]")
            for solver, ctrl in mesh_ctrls.items():
                one = single[solver][0]
                holders = [[ctrl.init(N)], [one.init(N)]]

                def tick_mesh(c=ctrl, h=holders[0]):
                    _, h[0] = c.step(h[0], xb)

                def tick_one(c=one, h=holders[1]):
                    _, h[0] = c.step(h[0], x0s)

                t1, tm = cuda_ms(tick_one), cuda_ms(tick_mesh)
                log(f"time serving tick {solver} (30 iters, {N} scenarios): mesh {tm:.4f} ms, "
                    f"single device {t1:.4f} ms [{smi}]")
        finally:
            dist.destroy_process_group()

    # bf16 tensor-core passes. K1': g at "highest", c's product (tail class)
    # and the iterations' (N, d) x (d, d) products; inputs (rho Minv)', W,
    # x0s; outputs z, y, g. K2': g and the iterations; outputs U, g.
    fold_passes = 2 * N * n * d * boxqp_passes(0, 1)
    return [
        kernel_entry("fista_mpc", "boxqp_fista.cu", "boxqp_fista.py:183", launches["K2'"],
                     err["fista_g"], ms["fista_g"], plain_ms["fista_g"],
                     4 * (d * d + n * d + N * n + 2 * N * d), 0,
                     tensor_ops=fold_passes + 2 * N * d * d * boxqp_passes(
                         fista_ci, iters - fista_ci)),
        kernel_entry("admm_mpc", "boxqp_admm.cu", "boxqp_admm.py:447", launches["K1'"],
                     err["admm_g"], ms["admm_g"], plain_ms["admm_g"],
                     4 * (d * d + n * d + N * n + 3 * N * d), 0,
                     tensor_ops=fold_passes + 2 * N * d * d * boxqp_passes(
                         admm_ci, iters - admm_ci + 1)),
    ]


# The op-surface phase (20): 4096 x 4096 float32 operands, and the 4100 x 4100
# one past torch.quantile's 2^24 elements
N_OPS, N_OPS_BIG = 4096, 4100
# tolerance classes of the op surface (tests/torch_ops_twins.py's): exact, the
# transcendentals, the reductions (on positive data, so that the relative
# bound measures the summation order and not a cancellation)
OPS_EXACT = {"rtol": 0.0, "atol": 0.0}
OPS_TRANSCENDENTAL = {"rtol": 1e-6, "atol": 1e-7}
OPS_REDUCTION = {"rtol": 1e-6, "atol": 1e-6}
# a running sum or product of K = 4096 positive terms (cumsum, cumprod,
# prod along an axis): the card's parallel order and the CPU's sequential
# one sit 1.5e-6 to 1.4e-5 apart (relative), past the reductions' class, so
# each is held to the float64 result within fp32's bound for K-term
# accumulation, (K - 1) 2^-24 relative
OPS_ACCUMULATION = {"rtol": (N_OPS - 1) * 2.0 ** -24, "atol": 0.0, "float64": True}
# the second half of the op surface: the decompositions at N_LINALG (host
# LAPACK takes minutes at 4096), the batched stacks of N_STACK 12 x 12
# matrices (the MPC state size), the random draws over N_DRAWS samples, a
# DNN convolution at a ResNet stage's shape (CONV_X x CONV_W)
N_LINALG, N_STACK, N_DRAWS = 1024, 4096, 1 << 24
CONV_X, CONV_W, CONV_G = (32, 64, 128, 128), (64, 64, 3, 3), (8, 64, 64, 64)
# solves, inverses, determinants, least squares, pseudo-inverses, spectra
# and norms of well-conditioned operands (condition number below ~10)
# against the float64 result, card and CPU alike
OPS_LINALG = {"rtol": 1e-4, "atol": 1e-4, "float64": True}


def ops_product(*terms: int) -> dict:
    """The class of a product (matmul, dot, einsum, the convolutions, ...):
    each output a sum of K terms (one K an output of a tuple), card and CPU
    each within (K - 1) 2^-24 of the float64 result relative to the sum of
    the terms' magnitudes (the op on |operands| in float64), the bound of
    fp32 accumulation."""
    return {"product": terms}


def ops_factorization(check) -> dict:
    """The class of a factorization: check(result, X) holds the card's
    result by its reconstruction and invariants (factor by factor two
    correct implementations differ in signs and order)."""
    return {"check": check}


def _fact_bound(A: torch.Tensor) -> float:
    """4 n eps max(1, max |A|): the backward-error scale of a float32
    factorization of order n."""
    return 4 * A.shape[-1] * 2.0 ** -24 * max(1.0, A.abs().max().item())


def _residual(what: str, got: torch.Tensor, want: torch.Tensor, bound: float) -> str:
    err = (got.double() - want.double()).abs().max().item()
    return "" if err <= bound else f"{what} {err:.3e} > {bound:.3e}"


def _orthonormal(what: str, Q: torch.Tensor) -> str:
    Qd = Q.double()
    eye = torch.eye(Q.shape[-1], dtype=Qd.dtype, device=Q.device)
    return _residual(what, Qd.mT.conj() @ Qd, eye.expand(Qd.shape[:-2] + eye.shape),
                     _fact_bound(eye.expand(Qd.shape[:-2] + eye.shape)) * Q.shape[-2] / Q.shape[-1])


def check_cholesky(got, X) -> str:
    """L lower triangular (zeros above, exactly), L L' = A for the stack and
    the 1024 matrix; a matrix that is not PD gives the CPU's NaN pattern."""
    msgs = []
    for L, A in zip(got[:2], (X["spd12"], X["spd"])):
        Ld = L.double()
        msgs += [_residual("L L' - A", Ld @ Ld.mT, A, _fact_bound(A)),
                 "" if bool((torch.triu(L, 1) == 0).all()) else "L not lower"]
    want = torch.tensor([[float("nan"), 0.0], [float("nan"), float("nan")]])
    same = torch.equal(torch.isnan(got[2]).cpu(), torch.isnan(want))
    msgs.append("" if same and got[2][0, 1].item() == 0 else "non-PD NaN pattern")
    return "; ".join(m for m in msgs if m)


def check_lu(got, X) -> str:
    P, L, U = got
    A = X["wc"]
    msgs = [_residual("P L U - A", P.double() @ L.double() @ U.double(), A, _fact_bound(A)),
            "" if bool((torch.triu(L, 1) == 0).all() and (torch.diagonal(L) == 1).all())
            else "L not unit lower", "" if bool((torch.tril(U, -1) == 0).all()) else "U not upper"]
    return "; ".join(m for m in msgs if m)


def check_qr(got, X) -> str:
    Q, R = got
    A = X["tall"]
    msgs = [_residual("Q R - A", Q.double() @ R.double(), A, _fact_bound(A)),
            _orthonormal("Q'Q - I", Q), "" if bool((torch.tril(R, -1) == 0).all()) else "R"]
    return "; ".join(m for m in msgs if m)


def check_svd(got, X) -> str:
    U, S, Vt = got
    A = X["wc"]
    msgs = [_residual("U S V' - A", (U.double() * S.double()) @ Vt.double(), A, _fact_bound(A)),
            _orthonormal("U'U - I", U), _orthonormal("V'V - I", Vt.mT),
            "" if bool((S[:-1] >= S[1:]).all()) else "S not descending"]
    return "; ".join(m for m in msgs if m)


def check_eig(got, X) -> str:
    """A v = v diag(w) (real: the SPD matrix's spectrum is real)."""
    w, v = got
    A = X["spd"]
    return _residual("A v - v w", A.double() @ v.double(), v.double() * w.double(), _fact_bound(A))


def check_eig_complex(got, X) -> str:
    w, v = got
    A = X["wc"]
    av = A.to(torch.complex128) @ v.to(torch.complex128)
    err = (av - v.to(torch.complex128) * w.to(torch.complex128)).abs().max().item()
    bound = _fact_bound(A)
    ok = w.dtype == torch.complex64 and w.device.type == "cuda" and err <= bound
    return "" if ok else f"A v - v w {err:.3e} > {bound:.3e} ({w.dtype}, {w.device})"


def check_eigh(got, X) -> str:
    msgs = []
    for (w, v), A in zip(got, (X["spd"], X["spd12"])):
        vd = v.double()
        msgs += [_residual("V w V' - A", (vd * w.double()[..., None, :]) @ vd.mT, A,
                           _fact_bound(A)), _orthonormal("V'V - I", v),
                 "" if bool((w[..., :-1] <= w[..., 1:]).all()) else "w not ascending"]
    return "; ".join(m for m in msgs if m)


def ops_draws(mean: float, std: float, lo=-math.inf, hi=math.inf, integer=False) -> dict:
    """The class of a random draw of N_DRAWS samples on the card: its mean
    and standard deviation within 6 standard errors of the distribution's,
    every sample within [lo, hi] (and an integer where `integer`)."""
    def check(x, X):
        xd = x.double()
        n = x.numel()
        m, var = xd.mean().item(), xd.var(unbiased=False).item()
        se_var = math.sqrt(max(((xd - mean) ** 4).mean().item() - std ** 4, 1e-12) / n)
        msgs = ["" if x.device.type == "cuda" and n == N_DRAWS else f"{n} on {x.device}",
                "" if abs(m - mean) <= 6 * std / math.sqrt(n) else f"mean {m:.6f} vs {mean}",
                "" if abs(var - std ** 2) <= 6 * se_var else f"var {var:.6f} vs {std ** 2:.6f}",
                "" if lo <= xd.min().item() and xd.max().item() <= hi else "out of bounds",
                "" if not integer or bool((xd == xd.round()).all()) else "not integers"]
        return "; ".join(msg for msg in msgs if msg)
    return {"check": check}


def check_same_draws(got, X) -> str:
    """The same draws after the same seed (or from the same key), others
    after another."""
    a, b, c = got
    ok = a.device.type == "cuda" and torch.equal(a, b) and not torch.equal(a, c)
    return "" if ok else "the same seed did not give the same draws on the card"


def _tmp_npy() -> str:
    fd, path = tempfile.mkstemp(suffix=".npy")
    os.close(fd)
    return path


def _io_roundtrip(o, x: torch.Tensor, device, how: str):
    """x written and read back: "save" by ops.save then numpy, "load" by
    numpy then ops.load (the native reader past 1 MiB), "serialize" both
    ways in memory."""
    if how == "serialize":
        return o.deserialize(o.serialize(x), device=device)
    path = _tmp_npy()
    try:
        if how == "save":
            o.save(path, x)
            return torch.from_numpy(np.load(path)).to(device)
        np.save(path, x.cpu().numpy())
        return o.load(path, device=device)
    finally:
        os.unlink(path)


def ops_inputs(n: int = N_OPS, seed: int = 0) -> dict:
    """The op phase's operands as CPU tensors, from one numpy generator:
    a, b in [-3, 3] (b kept 0.1 away from 0), rounded copies ra, rb (for the
    comparisons' ties), pos in [0.01, 10], unit in [-0.99, 0.99], ge1 in
    [1, 5], red in [0.5, 1.5], near1 in [0.995, 1.005] (n x n); v in [-3, 3],
    vpos in [0.1, 2], its sorted copy sv, int32 indices idx (n); a 0/1 float
    mask."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape=(n, n)):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    b = u(-3, 3)
    b[np.abs(b) < 0.1] = 0.5
    a = u(-3, 3)
    x = {"a": a, "b": b, "ra": np.round(a), "rb": np.round(b), "pos": u(0.01, 10),
         "unit": u(-0.99, 0.99), "ge1": u(1, 5), "red": u(0.5, 1.5), "near1": u(0.995, 1.005),
         "v": u(-3, 3, (n,)), "vpos": u(0.1, 2, (n,)), "mask": (u(0, 1) > 0.5).astype(np.float32),
         "idx": rng.integers(0, n, n).astype(np.int32)}
    x["sv"] = np.sort(x["v"])
    # the second half: well-conditioned matrices of order N_LINALG (spd, its
    # Cholesky factor chol, wc nonsymmetric, tall N x N/2 and lowrank its
    # rank-N/2 Gram matrix), right-hand sides, N_STACK SPD 12 x 12 stacks, 2-d
    # and 1-d filters, the DNN operands and an RGB image
    m = N_LINALG
    g = rng.standard_normal((m, m))
    spd = g @ g.T / m + np.eye(m)
    tall = rng.standard_normal((m, m // 2)) / np.sqrt(m) + np.eye(m, m // 2)
    s12 = rng.standard_normal((N_STACK, 12, 12))
    x.update({"spd": spd, "chol": np.linalg.cholesky(spd), "tall": tall,
              "wc": rng.standard_normal((m, m)) / np.sqrt(m) + 2 * np.eye(m),
              "lowrank": tall @ tall.T, "rhs": u(-1, 1, (m, 8)),
              "spd12": s12 @ s12.transpose(0, 2, 1) / 12 + np.eye(12),
              "rhs12": u(-1, 1, (N_STACK, 12, 4)), "k5": u(-1, 1, (5, 5)),
              "k64": u(-1, 1, (64,)), "cx": u(-1, 1, CONV_X), "cw": u(-0.1, 0.1, CONV_W),
              "cg": u(-1, 1, CONV_G), "x1": u(-1, 1, (32, 64, n)), "w1": u(-0.2, 0.2, (64, 32, 5)),
              "img": rng.integers(0, 256, (n, n, 3)).astype(np.uint8),
              "half": (rng.integers(-20, 531, (3, n, n)) / 2).astype(np.float32)})
    return {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in x.items()}


def op_cases(n: int = N_OPS) -> list:
    """[(name, fn, tolerance)] covering every name numpower_tpu_torch.ops
    exports from creation, dtypes, elementwise, logic, reductions, statistics
    and manipulation: fn(ops, X, device) runs the op on the operands X (a dict
    of ops_inputs on `device`), creation functions on `device`."""
    E, T, R = OPS_EXACT, OPS_TRANSCENDENTAL, OPS_REDUCTION
    cases = [
        # creation
        ("array", lambda o, X, d: o.array(X["a"]), E),
        ("asarray", lambda o, X, d: o.asarray(X["a"], dtype="float64"), E),
        ("zeros", lambda o, X, d: o.zeros((n, n), device=d), E),
        ("ones", lambda o, X, d: o.ones((n, n), dtype="int32", device=d), E),
        ("full", lambda o, X, d: o.full((n, n), 7.5, device=d), E),
        ("empty", lambda o, X, d: o.empty((n, n), device=d), E),
        ("empty_like", lambda o, X, d: o.empty_like(X["a"]), E),
        ("zeros_like", lambda o, X, d: o.zeros_like(X["a"]), E),
        ("ones_like", lambda o, X, d: o.ones_like(X["idx"]), E),
        ("identity", lambda o, X, d: o.identity(n, device=d), E),
        ("eye", lambda o, X, d: o.eye(n, n + 3, k=2, device=d), E),
        ("arange", lambda o, X, d: o.arange(0, n * n, 1, device=d), E),
        ("linspace", lambda o, X, d: o.linspace(-2.5, 3.7, n * n, device=d), E),
        ("diag", lambda o, X, d: o.diag(X["v"], k=1), E),
        ("diagonal", lambda o, X, d: o.diagonal(X["a"], offset=-3), E),
        ("fill", lambda o, X, d: o.fill(X["a"], 3.0), E),
        ("copy", lambda o, X, d: o.copy(X["a"]), E),
        ("tri", lambda o, X, d: o.tri(n, k=-1, device=d), E),
        # dtypes
        ("resolve_dtype", lambda o, X, d: o.resolve_dtype("double64"), E),
        ("get_type_size", lambda o, X, d: o.get_type_size("float32"), E),
        ("is_type", lambda o, X, d: o.is_type("float32", "double64"), E),
        # elementwise: binary
        ("pow", lambda o, X, d: o.pow(X["a"], 3), E),
        # torch.sqrt on the card is within an ulp of the CPU's correctly
        # rounded one (2.4e-7 at 3.2): the transcendentals' class there
        ("sqrt", lambda o, X, d: o.sqrt(X["pos"]), T),
        ("power", lambda o, X, d: o.power(X["pos"], X["b"]), T),
        ("arctan2", lambda o, X, d: o.arctan2(X["a"], X["b"]), T),
    ]
    cases += [(name, lambda o, X, d, name=name: getattr(o, name)(X["a"], X["b"]), E)
              for name in ("add", "subtract", "multiply", "divide", "mod", "maximum",
                           "minimum")]
    # elementwise: unary, each on its domain
    unary = {"a": ("abs", "absolute", "floor", "ceil", "trunc", "fix", "rint", "negative",
                   "positive", "sign", "square", "round", "degrees", "radians"),
             "pos": ("logb",), "b": ("reciprocal",)}
    cases += [(name, lambda o, X, d, name=name, k=k: getattr(o, name)(X[k]), E)
              for k, names in unary.items() for name in names]
    unary_t = {"a": ("exp", "exp2", "expm1", "sin", "cos", "arctan", "sinh", "cosh", "tanh",
                     "arcsinh", "sinc"),
               "pos": ("log", "log2", "log10", "log1p", "rsqrt"),
               "unit": ("arcsin", "arccos", "arctanh", "tan"), "ge1": ("arccosh",)}
    cases += [(name, lambda o, X, d, name=name, k=k: getattr(o, name)(X[k]), T)
              for k, names in unary_t.items() for name in names]
    cases += [("clip", lambda o, X, d: o.clip(X["a"], -1.0, 1.5), E)]
    # logic
    cases += [(name, lambda o, X, d, name=name: getattr(o, name)(X["ra"], X["rb"]), E)
              for name in ("equal", "not_equal", "greater", "greater_equal", "less",
                           "less_equal")]
    cases += [
        ("all", lambda o, X, d: o.all(X["mask"], axis=0), E),
        ("any", lambda o, X, d: o.any(X["mask"], axis=1), E),
        ("allclose", lambda o, X, d: o.allclose(X["a"], X["a"] + 1e-7), E),
        ("array_equal", lambda o, X, d: o.array_equal(X["ra"], X["rb"]), E),
        ("isnan", lambda o, X, d: o.isnan(o.log(X["a"])), E),
        ("isinf", lambda o, X, d: o.isinf(o.divide(X["ra"], 0.0)), E),
        ("isfinite", lambda o, X, d: o.isfinite(o.log(X["a"])), E),
        ("where", lambda o, X, d: o.where(X["mask"], X["a"], X["b"]), E),
        # reductions
        ("sum", lambda o, X, d: o.sum(X["red"], axis=0), R),
        ("prod", lambda o, X, d: o.prod(X["near1"], axis=1), OPS_ACCUMULATION),
        ("mean", lambda o, X, d: o.mean(X["red"]), R),
        ("median", lambda o, X, d: o.median(X["a"], axis=1), E),
        ("min", lambda o, X, d: o.min(X["a"], axis=0), E),
        ("max", lambda o, X, d: o.max(X["a"]), E),
        ("argmin", lambda o, X, d: o.argmin(X["a"], axis=1), E),
        ("argmax", lambda o, X, d: o.argmax(X["a"]), E),
        ("cumsum", lambda o, X, d: o.cumsum(X["red"], axis=1), OPS_ACCUMULATION),
        ("cumprod", lambda o, X, d: o.cumprod(X["near1"], axis=1), OPS_ACCUMULATION),
        ("sort", lambda o, X, d: o.sort(X["a"], axis=1), E),
        ("argsort", lambda o, X, d: o.argsort(X["a"], axis=0), E),
        ("take", lambda o, X, d: o.take(X["a"], X["idx"], axis=1), E),
        ("searchsorted", lambda o, X, d: o.searchsorted(X["sv"], X["a"]), E),
        # statistics
        ("quantile", lambda o, X, d: o.quantile(X["red"], 0.37, axis=1), R),
        ("percentile", lambda o, X, d: o.percentile(X["red"], [10.0, 90.0], axis=0), R),
        ("std", lambda o, X, d: o.std(X["red"], axis=0), R),
        ("variance", lambda o, X, d: o.variance(X["red"], axis=1), R),
        ("var", lambda o, X, d: o.var(X["red"]), R),
        ("average", lambda o, X, d: o.average(X["red"], axis=1, weights=X["vpos"]), R),
        # manipulation
        ("transpose", lambda o, X, d: o.transpose(X["a"]), E),
        ("reshape", lambda o, X, d: o.reshape(X["a"], (n // 2, 2 * n)), E),
        ("flatten", lambda o, X, d: o.flatten(X["a"]), E),
        ("ravel", lambda o, X, d: o.ravel(X["a"]), E),
        ("flip", lambda o, X, d: o.flip(X["a"], 0), E),
        ("expand_dims", lambda o, X, d: o.expand_dims(X["a"], (0, 3)), E),
        ("squeeze", lambda o, X, d: o.squeeze(X["a"][None]), E),
        ("swapaxes", lambda o, X, d: o.swapaxes(X["a"], 0, 1), E),
        ("rollaxis", lambda o, X, d: o.rollaxis(X["a"][None], 2), E),
        ("moveaxis", lambda o, X, d: o.moveaxis(X["a"][None], 0, -1), E),
        ("concatenate", lambda o, X, d: o.concatenate([X["a"], X["b"]], axis=1), E),
        ("append", lambda o, X, d: o.append(X["a"], X["b"], axis=0), E),
        ("vstack", lambda o, X, d: o.vstack([X["a"], X["v"]]), E),
        ("hstack", lambda o, X, d: o.hstack([X["a"], X["b"]]), E),
        ("dstack", lambda o, X, d: o.dstack([X["a"], X["b"]]), E),
        ("column_stack", lambda o, X, d: o.column_stack([X["a"], X["v"]]), E),
        ("stack", lambda o, X, d: o.stack([X["a"], X["b"]], axis=1), E),
        ("atleast_1d", lambda o, X, d: o.atleast_1d(X["a"]), E),
        ("atleast_2d", lambda o, X, d: o.atleast_2d(X["v"]), E),
        ("atleast_3d", lambda o, X, d: o.atleast_3d(X["a"]), E),
        ("split", lambda o, X, d: o.split(X["a"], 4, axis=1), E),
        ("tile", lambda o, X, d: o.tile(X["v"], (2, 3)), E),
        ("repeat", lambda o, X, d: o.repeat(X["a"], 2, axis=0), E),
        ("roll", lambda o, X, d: o.roll(X["a"], 5, 1), E),
        ("broadcast_to", lambda o, X, d: o.broadcast_to(X["v"], (n, n)), E),
        ("is_broadcastable", lambda o, X, d: o.is_broadcastable(X["a"], X["v"]), E),
        ("slice", lambda o, X, d: o.slice(X["a"], [0, n, 2], [None, None, -1]), E),
    ]
    return cases + second_half_cases(n)


def second_half_cases(n: int = N_OPS) -> list:
    """The cases of linalg, signal, dnn, io, image and random (the names
    `random.<draw>`): products, filters and elementwise-style ops at n x n,
    the decompositions at N_LINALG and on N_STACK 12 x 12 stacks."""
    E, L, P = OPS_EXACT, OPS_LINALG, ops_product
    m = N_LINALG
    nan_pd = [[1.0, 2.0], [2.0, 1.0]]
    cases = [
        # linalg: products
        ("matmul", lambda o, X, d: o.matmul(X["a"], X["b"]), P(n)),
        ("dot", lambda o, X, d: o.dot(X["a"], X["v"]), P(n)),
        ("inner", lambda o, X, d: o.inner(X["b"], X["v"]), P(n)),
        ("outer", lambda o, X, d: o.outer(X["v"], X["vpos"]), E),
        ("trace", lambda o, X, d: o.trace(X["red"]), P(n)),
        ("kron", lambda o, X, d: o.kron(X["a"][:64, :64], X["b"][:64, :64]), E),
        ("einsum", lambda o, X, d: o.einsum("ij,ij->i", X["a"], X["b"]), P(n)),
        ("matrix_power", lambda o, X, d: o.matrix_power(X["wc"], 3), P(2 * m)),
        # linalg: solves and spectra against float64
        ("solve", lambda o, X, d: (o.solve(X["spd"], X["rhs"]), o.solve(X["spd12"], X["rhs12"]),
                                   o.solve(X["spd"], X["rhs"][:, 0])), L),
        ("solve_triangular", lambda o, X, d: (
            o.solve_triangular(X["chol"], X["rhs"]),
            o.solve_triangular(X["chol"], X["rhs"][:, 0], trans=True)), L),
        ("cho_solve", lambda o, X, d: o.cho_solve(X["chol"], X["rhs"]), L),
        ("inv", lambda o, X, d: (o.inv(X["spd"]), o.inv(X["spd12"])), L),
        ("det", lambda o, X, d: o.det(X["spd12"]), L),
        ("svdvals", lambda o, X, d: o.svdvals(X["wc"]), L),
        ("eigvals", lambda o, X, d: o.sort(o.eigvals(X["spd"])), L),
        ("norm", lambda o, X, d: (o.norm(X["wc"], "l2"), o.norm(X["a"], "l1"), o.norm(X["v"])), L),
        ("cond", lambda o, X, d: (o.cond(X["spd"]), o.cond(X["spd"], 1)), L),
        ("lstsq", lambda o, X, d: o.lstsq(X["tall"], X["rhs"]), L),
        ("pinv", lambda o, X, d: o.pinv(X["tall"]), L),
        ("matrix_rank", lambda o, X, d: (o.matrix_rank(X["wc"]), o.matrix_rank(X["lowrank"])), E),
        # linalg: factorizations by reconstruction
        ("cholesky", lambda o, X, d: (o.cholesky(X["spd12"]), o.cholesky(X["spd"]),
                                      o.cholesky(torch.tensor(nan_pd, device=d))),
         ops_factorization(check_cholesky)),
        ("lu", lambda o, X, d: o.lu(X["wc"]), ops_factorization(check_lu)),
        ("qr", lambda o, X, d: o.qr(X["tall"]), ops_factorization(check_qr)),
        ("svd", lambda o, X, d: o.svd(X["wc"], full_matrices=False),
         ops_factorization(check_svd)),
        ("eig", lambda o, X, d: o.eig(X["spd"]), ops_factorization(check_eig)),
        ("eig_complex", lambda o, X, d: o.eig_complex(X["wc"]),
         ops_factorization(check_eig_complex)),
        ("eigh", lambda o, X, d: (o.eigh(X["spd"]), o.eigh(X["spd12"])),
         ops_factorization(check_eigh)),
        # signal
        ("convolve2d", lambda o, X, d: o.convolve2d(X["a"], X["k5"], "same", "symm"), P(25)),
        ("correlate2d", lambda o, X, d: o.correlate2d(X["a"], X["k5"], "full", "wrap"), P(25)),
        ("convolve1d", lambda o, X, d: o.convolve1d(o.flatten(X["a"]), X["k64"], "same"), P(64)),
        # dnn
        ("conv2d_forward", lambda o, X, d: o.conv2d_forward(X["cx"], X["cw"], None, 1, "SAME"),
         P(CONV_W[1] * 9)),
        ("conv2d_backward", lambda o, X, d: o.conv2d_backward(
            X["cx"][:CONV_G[0], :, :CONV_G[2], :CONV_G[3]], X["cw"], X["cg"], 1, "SAME"),
         P(CONV_W[0] * 9, CONV_G[0] * CONV_G[2] * CONV_G[3])),
        ("conv1d_forward", lambda o, X, d: o.conv1d_forward(X["x1"], X["w1"], 1, "same", 2, 2),
         P(32 * 5)),
        # io (64 MB through a file, the native reader past 1 MiB) and image
        ("save", lambda o, X, d: _io_roundtrip(o, X["a"], d, "save"), E),
        ("load", lambda o, X, d: _io_roundtrip(o, X["a"], d, "load"), E),
        ("serialize", lambda o, X, d: _io_roundtrip(o, X["b"], d, "serialize"), E),
        ("deserialize", lambda o, X, d: _io_roundtrip(o, X["idx"], d, "serialize"), E),
        ("to_list", lambda o, X, d: o.to_list(X["a"][:64, :64]), E),
        ("from_image", lambda o, X, d: o.from_image(X["img"].cpu().numpy(), device=d), E),
        ("to_image", lambda o, X, d: o.to_image(X["half"]), E),
        # random: moments over N_DRAWS draws on the card, the same draws again
        ("random.seed", lambda o, X, d: _seeded(o, d), ops_factorization(check_same_draws)),
        ("random.key", lambda o, X, d: tuple(o.random.uniform(N_DRAWS, key=o.random.key(s, d))
                                             for s in (7, 7, 8)),
         ops_factorization(check_same_draws)),
        ("random.uniform", lambda o, X, d: o.random.uniform(N_DRAWS, 2.0, 4.0, device=d),
         ops_draws(3.0, 2 / math.sqrt(12), 2.0, 4.0)),
        ("random.normal", lambda o, X, d: o.random.normal(N_DRAWS, 5.0, 2.0, device=d),
         ops_draws(5.0, 2.0)),
        ("random.standard_normal", lambda o, X, d: o.random.standard_normal(N_DRAWS, device=d),
         ops_draws(0.0, 1.0)),
        ("random.poisson", lambda o, X, d: o.random.poisson(N_DRAWS, 4.0, device=d),
         ops_draws(4.0, 2.0, 0, math.inf, True)),
        ("random.random_binomial", lambda o, X, d: o.random.random_binomial(N_DRAWS, 10, 0.3,
                                                                              device=d),
         ops_draws(3.0, math.sqrt(2.1), 0, 10, True)),
        ("random.randint", lambda o, X, d: o.random.randint(N_DRAWS, -3, 7, device=d),
         ops_draws(1.5, math.sqrt(99 / 12), -3, 6, True)),
        ("random.truncated_normal", lambda o, X, d: o.random.truncated_normal(N_DRAWS, device=d),
         ops_draws(0.0, math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                                  / math.erf(math.sqrt(2))), -2.0, 2.0)),
    ]
    return cases


def _seeded(o, d) -> tuple:
    draws = []
    for s in (123, 123, 124):
        o.random.seed(s)
        draws.append(o.random.normal(N_DRAWS, device=d))
    return tuple(draws)


def ops_agree(got, want, tol, on: str, want64=None) -> str:
    """'' where the card's result `got` matches the CPU's `want` (values at
    `tol`, shape, dtype, got on the card), else what differs. Under a
    float64 class (OPS_ACCUMULATION, OPS_LINALG) both are held to `want64`,
    the float64 result."""
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return "not the same sequence"
        w64 = want64 if want64 is not None else [None] * len(want)
        return next((m for g, w, w6 in zip(got, want, w64)
                     if (m := ops_agree(g, w, tol, on, w6))), "")
    if isinstance(want, np.ndarray):  # to_image's host image
        same = isinstance(got, np.ndarray) and got.dtype == want.dtype and \
            np.array_equal(got, want)
        return "" if same else "not the CPU's image"
    if not isinstance(want, torch.Tensor):
        return "" if got == want else f"{got!r} != {want!r}"
    if got.device.type != on:
        return f"on {got.device}"
    if got.dtype != want.dtype or got.shape != want.shape:
        return f"{got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}"
    g, w = got.cpu(), want
    if tol is OPS_EXACT:
        same = torch.equal(g, w) or bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
        return "" if same else f"max |d| {max_err(g, w):.3e} (exact)"
    if tol.get("float64"):
        ok = all(torch.allclose(x.double(), want64, rtol=tol["rtol"], atol=tol["atol"])
                 for x in (g, w))
        return "" if ok else (f"card {max_err(g, want64):.3e}, CPU {max_err(w, want64):.3e} "
                              f"from float64 (rtol {tol['rtol']:.3e}, atol {tol['atol']:.3e})")
    ok = torch.allclose(g.double(), w.double(), equal_nan=True, **tol)
    return "" if ok else f"max |d| {max_err(g, w):.3e} ({tol})"


class _Converted(dict):
    """The operands X, each converted by `conv` when a case first reads it."""

    def __init__(self, X: dict, conv):
        super().__init__()
        self._X, self._conv = X, conv

    def __missing__(self, key):
        value = self[key] = self._conv(self._X[key])
        return value


def ops_product_agree(fn, terms, got, want, X: dict, on: str = "cuda") -> str:
    """Under ops_product: the card's and the CPU's results each within
    (K - 1) 2^-24 of the float64 result, relative to the op on the operands'
    magnitudes (both in float64 on the card), K each output's terms."""
    from numpower_tpu_torch import ops

    dev = next(iter(X.values())).device
    X64 = _Converted(X, lambda t: t.double() if t.is_floating_point() else t)
    mags = _Converted(X, lambda t: t.double().abs() if t.is_floating_point() else t)
    outs = lambda r: r if isinstance(r, (list, tuple)) else (r,)  # noqa: E731
    for g, w, w64, mag, k in zip(outs(got), outs(want), outs(fn(ops, X64, dev)),
                                 outs(fn(ops, mags, dev)), terms):
        if g.device.type != on or g.dtype != w.dtype or g.shape != w.shape:
            return f"{g.dtype} {tuple(g.shape)} on {g.device} against {w.dtype} {tuple(w.shape)}"
        bound = (k - 1) * 2.0 ** -24 * mag
        for where, x in (("card", g), ("CPU", w.to(dev))):
            excess = ((x.double() - w64).abs() - bound).max().item()
            if excess > 0:
                return f"{where} past (K - 1) 2^-24 of float64 by {excess:.3e} (K {k})"
    return ""


def ops_check(fn, tol, X: dict, host: dict) -> str:
    """Run one op case on the card's operands X and on their CPU copies
    `host` (and, under a float64 class, on float64 copies); ops_agree's
    verdict. A product is held to float64 (ops_product_agree); a
    factorization or a draw by its own check on the card's result alone."""
    from numpower_tpu_torch import ops

    cpu = torch.device("cpu")
    got = fn(ops, X, next(iter(X.values())).device)
    torch.cuda.synchronize()
    if "check" in tol:
        return tol["check"](got, X)
    want = fn(ops, host, cpu)
    if "product" in tol:
        return ops_product_agree(fn, tol["product"], got, want, X)
    want64 = None
    if tol.get("float64"):
        want64 = fn(ops, _Converted(host, lambda t: t.double() if t.is_floating_point() else t),
                    cpu)
    return ops_agree(got, want, tol, "cuda", want64)


def exported_ops() -> set:
    """Every op the port's ops namespace exports (its random draws as
    `random.<name>`), as phase 20 must cover them."""
    from numpower_tpu_torch import ops

    exported = {n for n in dir(ops) if not n.startswith("_") and callable(getattr(ops, n))
                and getattr(getattr(ops, n), "__module__", "").startswith("numpower_tpu_torch")}
    return exported | {f"random.{n}" for n in dir(ops.random) if not n.startswith("_")
                       and getattr(getattr(ops.random, n), "__module__", "") == ops.random.__name__}


def ops_family(dev, smi: str) -> None:
    """Phase 20: every op of the ported op surface on the card against the CPU."""
    from numpower_tpu_torch import ops

    host = ops_inputs()
    X = {k: v.to(dev) for k, v in host.items()}
    failed, slow = [], []
    cases = op_cases()
    t_cases = time.perf_counter()
    for name, fn, tol in cases:
        t_case = time.perf_counter()
        try:
            msg = ops_check(fn, tol, X, host)
        except Exception as e:  # noqa: BLE001 - report every case, then fail
            msg = f"raised {type(e).__name__}: {e}"
        if msg:
            failed.append(f"{name}: {msg}")
        if (took := time.perf_counter() - t_case) > 2.0:
            slow.append(f"{name} {took:.1f} s")
    missing = sorted(exported_ops() - {name for name, _, _ in cases})
    log(f"ops: {len(cases)} ops (elementwise-style at {N_OPS}x{N_OPS} float32, decompositions "
        f"at {N_LINALG} and on {N_STACK} 12 x 12 stacks) on the card against the CPU: "
        f"{len(cases) - len(failed)} agree; not run: {missing or 'none'} "
        f"({time.perf_counter() - t_cases:.1f} s; over 2 s: {', '.join(slow) or 'none'})")
    for line in failed:
        log(f"ops mismatch {line}")
    require(not failed and not missing, "every op of the ported surface agrees with the CPU")

    big = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N_OPS_BIG, N_OPS_BIG)).astype(np.float32))
    big_d = big.to(dev)
    for name, fn in (("median", lambda t: ops.median(t)),
                     ("quantile", lambda t: ops.quantile(t, [0.3, 0.99])),
                     ("median axis=0", lambda t: ops.median(t, axis=0))):
        msg = ops_agree(fn(big_d), fn(big), OPS_EXACT if "median" in name else OPS_REDUCTION,
                        "cuda")
        log(f"ops {name} at {N_OPS_BIG}x{N_OPS_BIG} ({N_OPS_BIG ** 2} elements, past "
            f"torch.quantile's 2^24): {msg or 'agrees with the CPU'}")
        require(not msg, f"{name} past 2^24 elements")
    on_card = {"numpy operands": ops.add(host["a"].numpy(), host["b"].numpy()),
               "list operand": ops.asarray([1.0, 2.0]), "zeros()": ops.zeros(3),
               "arange()": ops.arange(4), "numpy + tensor": ops.multiply(host["v"].numpy(),
                                                                         X["v"])}
    log("ops default device: " + ", ".join(f"{k} -> {v.device}" for k, v in on_card.items()))
    require(all(v.device.type == "cuda" for v in on_card.values()),
            "numpy operands and creation with no device land on the card")

    times = {"add": lambda: ops.add(X["a"], X["b"]), "exp": lambda: ops.exp(X["a"]),
             "sum": lambda: ops.sum(X["red"]), "sort": lambda: ops.sort(X["a"], axis=1),
             "median": lambda: ops.median(X["a"]),
             "concatenate": lambda: ops.concatenate([X["a"], X["b"]], axis=1)}
    for name, fn in times.items():
        log(f"time ops.{name} {N_OPS}x{N_OPS} float32: "
            f"{cuda_ms(fn, reps=5, inner=5, warmup=2):.4f} ms [{smi}]")
    second_half_times(X, smi)


def second_half_times(X: dict, smi: str) -> None:
    """CUDA-event times of matmul at 4096 x 4096 (its share of the card's
    67 TFLOP/s fp32 peak, TF32 off), conv2d_forward at CONV_X x CONV_W, svd
    and eig at N_LINALG; host times of save and load of a 64 MB array (the
    native writer and reader)."""
    from numpower_tpu_torch import ops

    n, m = N_OPS, N_LINALG
    t = cuda_ms(lambda: ops.matmul(X["a"], X["b"]), reps=5, inner=5, warmup=2)
    log(f"time ops.matmul {n}x{n} float32: {t:.4f} ms, {2 * n ** 3 / t / 1e9:.2f} TFLOP/s, "
        f"{2 * n ** 3 / t / 1e9 / (FP32_FLOP_PER_S / 1e12):.1%} of the fp32 peak [{smi}]")
    flops = 2 * math.prod(CONV_X) * CONV_W[0] * 9
    t = cuda_ms(lambda: ops.conv2d_forward(X["cx"], X["cw"]), reps=5, inner=3, warmup=2)
    log(f"time ops.conv2d_forward {CONV_X} x {CONV_W} SAME float32: {t:.4f} ms, "
        f"{flops / t / 1e9:.2f} TFLOP/s [{smi}]")
    for name, fn in (("svd", lambda: ops.svd(X["wc"], full_matrices=False)),
                     ("svd by torch's default driver (gesvdj, not the port's)",
                      lambda: torch.linalg.svd(X["wc"], full_matrices=False)),
                     ("eig", lambda: ops.eig(X["wc"]))):
        log(f"time ops.{name} {m}x{m} float32: "
            f"{cuda_ms(fn, reps=3, inner=1, warmup=1):.4f} ms [{smi}]")
    path = _tmp_npy()
    try:
        for name, fn in (("save", lambda: ops.save(path, X["a"])),
                         ("load", lambda: ops.load(path, device=X["a"].device))):
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            log(f"time ops.{name} {n}x{n} float32 (64 MB, card <-> file, host clock): "
                f"{statistics.median(walls):.2f} ms median of 5 ({min(walls):.2f}-"
                f"{max(walls):.2f}) [{smi}]")
    finally:
        os.unlink(path)


def ndarray_family(dev, smi: str) -> None:
    """Phase 21: the NDArray object API on the card."""
    import gc
    import pickle

    from numpower_tpu_torch import NDArray, runtime

    require(runtime.native_available(), "the native runtime builds (g++) and loads")
    host = np.random.default_rng(5).uniform(-2, 2, (N_OPS, N_OPS)).astype(np.float32)
    a = NDArray(host.tolist()[:4])  # a list lands on the card
    b = NDArray(host)  # a numpy array too
    c = NDArray(torch.from_numpy(host))  # a CPU tensor keeps its device
    require(a.isGPU() and b.isGPU() and not c.isGPU() and b.value.device.type == "cuda",
            "NDArrays from lists and numpy arrays land on the card, from CPU tensors stay")
    g, back = c.gpu(), b.cpu()
    require(g.isGPU() and not back.isGPU() and g == c.value.to(dev) and back == b,
            "gpu() and cpu() move the array and keep its values")
    ref = torch.from_numpy(host)
    checks = {
        "+": ((b + b).value, ref + ref), "-": ((2 - b).value, 2 - ref),
        "*": ((b * 3).value, ref * 3), "/": ((b / 4).value, ref / 4),
        "@": ((b @ b).value, None), "sqrt": (abs(b).sqrt().value, ref.abs().sqrt()),
        "T": (b.T.value, ref.T), "sum axis 0": (b.sum(0).value, None),
    }
    for name, (got, want) in checks.items():
        require(isinstance(got, torch.Tensor) and got.device.type == "cuda", f"NDArray {name}")
        if want is not None:  # exact; sqrt in the transcendentals' class (torch's CUDA sqrt)
            tol = OPS_TRANSCENDENTAL if name == "sqrt" else OPS_EXACT
            require(torch.allclose(got.cpu(), want, **tol), f"NDArray {name} equals the CPU's")
    total = b.sum()
    require(isinstance(total, float) and math.isfinite(total), "a 0-d result is a float")
    row, elem = b[5], b[1, 2]
    require(isinstance(row, NDArray) and row.isGPU() and elem == float(host[1, 2]),
            "indexing gives rows on the card and floats")
    for bad in (N_OPS, (0, -N_OPS - 1)):
        try:
            b[bad]
            require(False, f"index {bad} raises IndexError")
        except IndexError:
            pass
    b[3] = 7.0
    b[0, 1] = -1.0
    require(b[3].value.eq(7.0).all().item() and b[0, 1] == -1.0 and b.isGPU(),
            "__setitem__ rebinds on the card")
    try:
        NDArray([[1.0, 5.0], [5.0, 1.0]]).cholesky()
        require(False, "cholesky of a non-PD matrix raises")
    except ValueError:
        pass

    gc.collect()
    before = runtime.stats()
    arrays = [NDArray.zeros((256, 256)) for _ in range(10)]
    mid = runtime.stats()
    del arrays
    gc.collect()
    after = runtime.stats()
    require(mid["live_count"] == before["live_count"] + 10
            and mid["live_bytes"] == before["live_bytes"] + 10 * 256 * 256 * 4
            and after["live_count"] == before["live_count"],
            "the registry counts rise and fall with the NDArrays")

    reads = []
    real = runtime.npy_read_fast
    runtime.npy_read_fast = lambda path: reads.append(path) or real(path)
    path = _tmp_npy()
    try:
        b.save(path)
        loaded = NDArray.load(path)
    finally:
        runtime.npy_read_fast = real
        os.unlink(path)
    require(loaded.isGPU() and loaded == b and reads == [path],
            "save / load of 64 MB through the native reader, back on the card")
    clone = pickle.loads(pickle.dumps(b))
    require(clone.isGPU() and clone == b, "pickling keeps the values and the device")
    log(f"ndarray: lists and numpy arrays on the card, CPU tensors kept, gpu()/cpu()/isGPU(), "
        f"{len(checks)} operators and methods, indexing and bounds, __setitem__, the registry "
        f"({before['live_count']} -> {mid['live_count']} -> {after['live_count']} live), "
        f"save/load of {N_OPS}x{N_OPS} through npy_read_fast, pickling: all pass [{smi}]")


def in_turns(fns: dict, rounds: int = 2, **kw) -> dict:
    """{name: median CUDA-event ms} of each function, timed in turns: every
    round times them in order and then in reverse, so that a drift of the
    card's clock falls on all of them alike."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(cuda_ms(fns[name], **kw))
    return {name: statistics.median(ts) for name, ts in times.items()}


def stream_family(dev, smi: str) -> None:
    """Phase 22: the host-fed tube sweep of BASELINE config #5 at its
    published 65,536 scenarios: the native ScenarioStream on the card feeding
    tube_mpc_solve, its batches against a host stream of the same seed, its
    moments, and the times of its parts and of the loop."""
    from numpower_tpu_torch.models import condense, quadrotor12, tube_mpc_solve
    from numpower_tpu_torch.runtime.stream import ScenarioStream

    A, B = quadrotor12(0.02)
    n, m, T_s = 12, 4, 20
    Q, R, QF = (np.eye(n, dtype=np.float32), np.eye(m, dtype=np.float32) * 0.1,
                np.eye(n, dtype=np.float32) * 5.0)
    qp = condense(A, B, Q, R, QF, T_s, device=dev)
    x0 = torch.as_tensor(0.2 * np.random.default_rng(2).standard_normal(n), dtype=torch.float32,
                         device=dev)
    kw = dict(batch=N_TUBE, shape=(T_s, n), seed=0, dist="normal", scale=0.002)
    mb = N_TUBE * T_s * n * 4 / 1e6

    def solve(w):
        return tube_mpc_solve(qp, A, B, Q, R, x0, w, LO, HI)

    radii, total, total_sq, count = [], 0.0, 0.0, 0
    with ScenarioStream(**kw) as card, ScenarioStream(device="cpu", **kw) as host, \
            ScenarioStream(**kw) as again:
        require(card.native and host.native, "the native stream serves the sweep")
        for b in range(N_STREAM_BATCHES):
            w, w_host, w_again = next(card), next(host), next(again)
            require(w.device == dev and w.shape == (N_TUBE, T_s, n) and w.dtype == torch.float32,
                    "a stream batch is a float32 tensor on the card")
            require(torch.equal(w.cpu(), w_host), f"batch {b} on the card equals the host copy")
            require(torch.equal(w, w_again), f"batch {b}: two streams of seed 0 agree")
            w64 = w.double()
            total += w64.sum().item()
            total_sq += (w64 * w64).sum().item()
            count += w.numel()
            radii.append(solve(w).tube_radius)
    mean, var = total / count, total_sq / count - (total / count) ** 2
    sigma = kw["scale"]
    se_mean, se_var = sigma / math.sqrt(count), sigma ** 2 * math.sqrt(2.0 / count)
    radii = torch.stack(radii)
    log(f"stream {N_STREAM_BATCHES} batches of ({N_TUBE}, {T_s}, {n}) ({mb:.1f} MB each): "
        f"mean {mean:.3e} ({abs(mean) / se_mean:.2f} standard errors), std "
        f"{math.sqrt(var):.6e} (variance {abs(var - sigma ** 2) / se_var:.2f} standard errors "
        f"from {sigma ** 2:.1e}); every card batch equal to the host stream's, bit for bit; "
        f"tube radius[1] {radii[0, 1].item():.3e}, max {radii.max().item():.3e}")
    require(abs(mean) <= 6 * se_mean and abs(var - sigma ** 2) <= 6 * se_var,
            "the stream's moments within 6 standard errors")
    require(bool(torch.isfinite(radii).all()), "finite tube radii")

    # times: production alone (host stream), the pinned copy alone, the solve
    # alone, then the host-fed loop
    with ScenarioStream(device="cpu", **kw) as host:
        next(host)
        t0 = time.perf_counter()
        for _ in range(N_STREAM_BATCHES):
            next(host)
        produce_ms = (time.perf_counter() - t0) / N_STREAM_BATCHES * 1e3
    pinned = torch.empty(N_TUBE * T_s * n, dtype=torch.float32, pin_memory=True)
    on_card = torch.empty(N_TUBE * T_s * n, dtype=torch.float32, device=dev)
    copy_ms = cuda_ms(lambda: on_card.copy_(pinned, non_blocking=True), reps=5, inner=4)
    w_card = on_card.view(N_TUBE, T_s, n).normal_(0.0, 0.002)
    solve_ms = cuda_ms(lambda: solve(w_card), reps=5, inner=2, warmup=1)
    with ScenarioStream(**kw) as card:
        solve(next(card)).tube_radius[0].item()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [solve(w).tube_radius[0] for _, w in zip(range(N_STREAM_BATCHES), card)]
        torch.stack(outs).cpu()
        loop_ms = (time.perf_counter() - t0) / N_STREAM_BATCHES * 1e3
    parts = (produce_ms, copy_ms, solve_ms)
    log(f"time host-fed sweep N={N_TUBE} T={T_s} ({mb:.1f} MB a batch): production alone "
        f"{produce_ms:.3f} ms ({mb / produce_ms:.3f} GB/s, 2 threads, host clock), pinned H2D "
        f"copy {copy_ms:.3f} ms ({mb / copy_ms:.3f} GB/s), solve {solve_ms:.3f} ms; host-fed "
        f"loop {loop_ms:.3f} ms a batch (wall) against the parts' sum {sum(parts):.3f} ms and "
        f"maximum {max(parts):.3f} ms -> {N_TUBE / loop_ms * 1e3:,.0f} scenario-rollouts/s "
        f"[{smi}]")


def parallel_rest_family(dev, smi: str) -> None:
    """Phases 23-24: the rest of parallel/ on a one-rank NCCL group and a
    (1, 1) mesh, each against its single-device counterpart, with its launch
    counts; then the times of each sharded entry against its counterpart,
    in turns."""
    import functools
    import tempfile

    import torch.distributed as dist

    from numpower_tpu_torch.kernels import ilqr_backward, ilqr_forward, pf_resample
    from numpower_tpu_torch.models import (
        al_ilqr_solve_batched, batched_rollout_lti, double_integrator, first_components,
        kalman_filter, kalman_filter_associative, mhe_solve, mppi_solve_batched, particle_filter,
        pendulum_step, quadratic_mppi_cost, quadrotor12, riccati_associative, riccati_scan,
    )
    from numpower_tpu_torch.parallel import (
        al_ilqr_solve_dp, kalman_filter_associative_sharded, make_mesh, mhe_solve_dp,
        mppi_solve_dp, particle_filter_dp, riccati_associative_sharded, rollout_lti_pipelined,
    )

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # the problems: phase 9's AL-iLQR, phase 16's MHE windows, the MPPI and PF
    # benches, phase 6's Riccati, phase 12's filter, config #4's plant
    Qp, Rp, QFp = t32(np.diag([1.0, 0.1])), t32(np.eye(1) * 0.01), t32(np.diag([100.0, 10.0]))
    goal = torch.zeros(2, device=dev)
    x0p = t32(np.random.default_rng(8).uniform(-np.pi, np.pi, (N_ILQR, 2)))
    al_kw = dict(al_iters=4, ilqr_iters=6)
    A_di = t32(double_integrator(0.1).A)
    C_di, Q_di, R_di, P0_di = (t32([[1.0, 0.0]]), t32(np.eye(2) * 1e-3), t32(np.eye(1) * 1e-2),
                               t32(np.eye(2) * 0.1))
    ys_mhe = t32(np.random.default_rng(13).standard_normal((N_MHE_WINDOWS, M_MHE, 1)) * 0.1
                 + np.linspace(1.0, 1.1, M_MHE)[None, :, None])
    x_prior = t32(np.tile([1.0, 0.0], (N_MHE_WINDOWS, 1))
                  + 0.1 * np.random.default_rng(14).standard_normal((N_MHE_WINDOWS, 2)))
    mhe_args = (A_di, C_di, Q_di, R_di, P0_di)
    bounds = dict(x_lo=t32([-10.0, -0.2]), x_hi=t32([10.0, 0.2]))
    cost_p = quadratic_mppi_cost(np.diag([1.0, 0.1]), np.eye(1) * 0.01, np.diag([100.0, 10.0]),
                                 np.zeros(2))
    x0m = t32(np.random.default_rng(8).uniform(-np.pi, np.pi, (N_MPPI, 2)))
    mppi_kw = dict(samples=K_MPPI, m=1)
    r = np.random.default_rng(12)
    pf_args = (pendulum_step, functools.partial(first_components, k=1), t32(np.eye(2) * 1e-4),
               t32(np.eye(1) * 2.5e-3), t32(0.3 * r.standard_normal(2)), t32(np.eye(2)),
               t32(r.standard_normal((T_PF, 1))), torch.zeros((T_PF, 1), device=dev))
    Aq, Bq = quadrotor12(0.02)
    quad = [t32(M) for M in (Aq, Bq, np.eye(12), np.eye(4) * 0.1, np.eye(12) * 5.0)]
    quad64 = [M.double() for M in quad]
    kf = (A_di, C_di, Q_di, R_di)
    ys_long = t32(np.random.default_rng(11).standard_normal((T_LONG, 1)))
    x0_kf = t32([1.0, 0.0])
    x0_pp = t32(0.3 * np.random.default_rng(15).standard_normal((N, 12)))
    us_pp = t32(0.1 * np.random.default_rng(16).standard_normal((N, T, 4)))

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1))
            log(f"phase 23: mesh {mesh.shape} on {mesh.device}, backend {dist.get_backend()}")

            # -- AL-iLQR DP, fused: K7 and K8 counted ------------------------------
            ilqr_backward.ilqr_backward_fused.launches = 0
            ilqr_forward.ilqr_forward_fused.launches = 0
            al, worst = al_ilqr_solve_dp(pendulum_step, x0p, Qp, Rp, QFp, goal, T_AL, -2.0, 2.0,
                                         mesh, backend="fused", **al_kw)
            launches = (ilqr_backward.ilqr_backward_fused.launches,
                        ilqr_forward.ilqr_forward_fused.launches)
            ref = al_ilqr_solve_batched(pendulum_step, x0p, Qp, Rp, QFp, goal, T_AL, -2.0, 2.0,
                                        backend="fused", **al_kw)
            d_al = max_err(al.us, ref.us)
            log(f"al_ilqr_solve_dp fused (pendulum, {N_ILQR} scenarios, h={T_AL}, 4x6): K7/K8 "
                f"launches {launches}; vs al_ilqr_solve_batched max|dus| {d_al:.3e} (tol 1e-6); "
                f"worst violation {worst.item():.3e} (the batch's max "
                f"{ref.max_violation.max().item():.3e})")
            require(launches == (24, 24), "AL-iLQR DP went through K7 and K8 24 times each")
            require(d_al <= 1e-6 and abs(worst.item() - ref.max_violation.max().item()) <= 1e-6,
                    "AL-iLQR DP equals the batched solver")

            # -- MHE DP: unconstrained and bounded windows -------------------------
            for name, kw_b in (("unconstrained", {}), ("velocity bounded", bounds)):
                res, worst = mhe_solve_dp(*mhe_args, x_prior, ys_mhe, mesh, **kw_b)
                ref = mhe_solve(*mhe_args, x_prior, ys_mhe, **kw_b)
                d_mhe = max_err(res.xs, ref.xs)
                log(f"mhe_solve_dp {N_MHE_WINDOWS} windows M={M_MHE} {name}: max|dxs| vs "
                    f"mhe_solve {d_mhe:.3e} (tol 1e-6); worst residual {worst.item():.3e}, the "
                    f"block's max {res.primal_residual.max().item():.3e}")
                require(d_mhe <= 1e-6 and worst.item() == res.primal_residual.max().item(),
                        f"MHE DP ({name}) equals mhe_solve, its residual the blocks' maximum")

            # -- MPPI DP against the plain batched route on the same generator -----
            for iters in (2, IT_MPPI):
                dp = mppi_solve_dp(pendulum_step, x0m, cost_p, T_MPPI, gen(iters), mesh,
                                   iters=iters, **mppi_kw)
                ref = mppi_solve_batched(pendulum_step, x0m, cost_p, T_MPPI, gen(iters),
                                         method="xla", iters=iters, **mppi_kw)
                if iters == 2:
                    du = max_err(dp.us, ref.us)
                    log(f"mppi_solve_dp N={N_MPPI} K={K_MPPI} T={T_MPPI} iters=2 vs the plain "
                        f"batched route: max|dus| {du:.3e} (bound 1e-4)")
                    require(du <= 1e-4, "MPPI DP at two rounds equals the plain route")
                else:
                    rel = relative_cost(dp.cost, ref.cost)
                    log(f"mppi_solve_dp iters={iters}: relative final cost median "
                        f"{rel.median().item():.3e} (bound 5e-2), max {rel.max().item():.3e}")
                    require(rel.median().item() <= 5e-2, "MPPI DP at eight rounds")

            # -- particle-filter DP: K14 once a step --------------------------------
            pf_resample.resample_systematic.launches = 0
            pf = particle_filter_dp(*pf_args, gen(0), mesh, n_particles=N_PF_DP)
            launches_pf = pf_resample.resample_systematic.launches
            ref = particle_filter(*pf_args, gen(0), n_particles=N_PF_DP)
            d_mean = max_err(pf.means, ref.means)
            d_ll = abs(pf.log_likelihood.item() - ref.log_likelihood.item())
            log(f"particle_filter_dp pendulum N={N_PF_DP} T={T_PF}: {launches_pf} K14 launches; "
                f"vs particle_filter max|dmean| {d_mean:.3e} (tol 1e-5), ll "
                f"{pf.log_likelihood.item():.4f} vs {ref.log_likelihood.item():.4f} (rtol 1e-5), "
                f"min ESS {pf.ess.min().item():.1f}")
            require(launches_pf == T_PF, "the PF DP launched K14 once a step")
            require(d_mean <= 1e-5 and d_ll <= 1e-5 * abs(ref.log_likelihood.item()),
                    "the PF DP equals the single-device filter")

            # -- horizon-sharded Riccati and Kalman filter, the pipeline ------------
            Ks, Ps = riccati_associative_sharded(*quad, T_LONG, mesh)
            Ks64, Ps64 = riccati_scan(*quad64, T_LONG)
            log(f"riccati_associative_sharded T={T_LONG} vs riccati_scan in float64: max|dKs| "
                f"{max_err(Ks, Ks64):.3e} max|dPs| {max_err(Ps, Ps64):.3e}")
            require(Ks.shape == Ks64.shape and Ps.shape == Ps64.shape
                    and close(Ks, Ks64, 1e-4, 1e-5), "the sharded Riccati against float64")
            sp = kalman_filter_associative_sharded(*kf, x0_kf, P0_di, ys_long, mesh)
            seq = kalman_filter(*(M.double() for M in kf), x0_kf.double(), P0_di.double(),
                                ys_long.double())
            d_kf = {f: max_err(getattr(sp, f), getattr(seq, f))
                    for f in ("means", "covs", "pred_means", "pred_covs")}
            log(f"kalman_filter_associative_sharded T={T_LONG} vs the sequential filter in "
                f"float64: {', '.join(f'{k} {v:.3e}' for k, v in d_kf.items())}; ll "
                f"{sp.log_likelihood.item():.3f} vs {seq.log_likelihood.item():.3f}")
            require(all(close(getattr(sp, f), getattr(seq, f), 1e-4, 2e-4) for f in d_kf)
                    and abs(sp.log_likelihood.item() - seq.log_likelihood.item())
                    <= 1e-4 * max(1.0, abs(seq.log_likelihood.item())),
                    "the sharded Kalman filter against float64")
            xs_pp = rollout_lti_pipelined(quad[0], quad[1], x0_pp, us_pp, mesh)
            ref_pp = batched_rollout_lti(quad[0], quad[1], x0_pp, us_pp)
            log(f"rollout_lti_pipelined quadrotor12 N={N} T={T} vs batched_rollout_lti: "
                f"max|dxs| {max_err(xs_pp, ref_pp):.3e}")
            require(xs_pp.shape == ref_pp.shape and close(xs_pp, ref_pp, 1e-5, 1e-6),
                    "the pipelined rollout")

            # -- phase 24: each sharded entry against its counterpart, in turns ----
            slow = dict(reps=3, inner=1, warmup=1)
            pairs = {
                "al_ilqr (fused, 256 scenarios)": (
                    lambda: al_ilqr_solve_dp(pendulum_step, x0p, Qp, Rp, QFp, goal, T_AL, -2.0,
                                             2.0, mesh, backend="fused", **al_kw),
                    lambda: al_ilqr_solve_batched(pendulum_step, x0p, Qp, Rp, QFp, goal, T_AL,
                                                  -2.0, 2.0, backend="fused", **al_kw)),
                f"mhe ({N_MHE_WINDOWS} windows, bounded)": (
                    lambda: mhe_solve_dp(*mhe_args, x_prior, ys_mhe, mesh, **bounds),
                    lambda: mhe_solve(*mhe_args, x_prior, ys_mhe, **bounds)),
                f"mppi ({N_MPPI} x {K_MPPI}, 8 rounds, plain)": (
                    lambda: mppi_solve_dp(pendulum_step, x0m, cost_p, T_MPPI, gen(0), mesh,
                                          iters=IT_MPPI, **mppi_kw),
                    lambda: mppi_solve_batched(pendulum_step, x0m, cost_p, T_MPPI, gen(0),
                                               method="xla", iters=IT_MPPI, **mppi_kw)),
                f"particle filter ({N_PF_DP} particles, T={T_PF})": (
                    lambda: particle_filter_dp(*pf_args, gen(0), mesh, n_particles=N_PF_DP),
                    lambda: particle_filter(*pf_args, gen(0), n_particles=N_PF_DP)),
                f"riccati associative (T={T_LONG})": (
                    lambda: riccati_associative_sharded(*quad, T_LONG, mesh),
                    lambda: riccati_associative(*quad, T_LONG)),
                f"kalman associative (T={T_LONG})": (
                    lambda: kalman_filter_associative_sharded(*kf, x0_kf, P0_di, ys_long, mesh),
                    lambda: kalman_filter_associative(*kf, x0_kf, P0_di, ys_long)),
                f"pipelined rollout (N={N}, T={T})": (
                    lambda: rollout_lti_pipelined(quad[0], quad[1], x0_pp, us_pp, mesh),
                    lambda: batched_rollout_lti(quad[0], quad[1], x0_pp, us_pp)),
            }
            for what, (sharded, single) in pairs.items():
                ms = in_turns({"sharded": sharded, "single": single}, **slow)
                log(f"time {what}: sharded on a (1, 1) mesh {ms['sharded']:.4f} ms, "
                    f"single device {ms['single']:.4f} ms, overhead "
                    f"{ms['sharded'] - ms['single']:+.4f} ms [{smi}]")
        finally:
            dist.destroy_process_group()


def utils_family(dev, smi: str) -> None:
    """Phase 24's utilities on the card (run before phase 23's NCCL group):
    utils.profiler.trace around one K2 solve, time_compiled against cuda_ms,
    and save/load_checkpoint of a 4096-scenario MPCState and of 64 MB."""
    import json as json_
    import tempfile

    from numpower_tpu_torch.kernels import boxqp_fista
    from numpower_tpu_torch.models import MPCController, MPCState, condense, quadrotor12
    from numpower_tpu_torch.models.condensed import default_coarse_iters
    from numpower_tpu_torch.utils import checkpoint, profiler

    def t32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    A, B = quadrotor12(0.02)
    n, m = 12, 4
    Q, R, QF = np.eye(n, dtype=np.float32), np.eye(m, dtype=np.float32) * 0.1, \
        np.eye(n, dtype=np.float32) * 5.0
    qp = condense(A, B, Q, R, QF, T, device=dev)
    x0s = t32(0.3 * np.random.default_rng(0).standard_normal((N, n)))
    ci = default_coarse_iters(qp, 40)
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T)

    def k2():
        return boxqp_fista.fista_mpc_res(*fold, x0s, LO, HI, qp.lipschitz, 40, ci)

    # torch.profiler, late in this process, now and then returns a short
    # session without any of its GPU records (5 of 6 sessions of one solve
    # came back without a kernel, the one of five solves with all of them; a
    # fresh process lost none), so the trace holds four more solves after
    # the annotated one and is taken up to three times, each attempt logged
    k2()
    for attempt in range(1, 4):
        with tempfile.TemporaryDirectory() as tmp:
            with profiler.trace(tmp):
                with profiler.annotate("chip_smoke_k2_solve"):
                    k2()
                for _ in range(4):
                    k2()
            files = [f for f in os.listdir(tmp) if f.endswith(".json")]
            require(len(files) == 1, "utils.profiler.trace wrote one trace")
            with open(os.path.join(tmp, files[0])) as f:
                events = json_.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernels = sum(e.get("cat") == "kernel" and "fista_kernel" in e.get("name", "")
                      for e in events)
        log(f"utils.profiler.trace around one annotated K2 solve and four more, attempt "
            f"{attempt}: {len(events)} events, {kernels} fista_kernel records, annotate region "
            f"{'chip_smoke_k2_solve' in names}")
        if kernels:
            break
    require(kernels >= 1 and "chip_smoke_k2_solve" in names,
            "the trace names the K2 kernel and the annotated region")
    tc_s, tc_iqr = profiler.time_compiled(k2, reps=5, inner=(5, 55), return_stats=True)
    log(f"time K2 ({N} scenarios, 40 iters): utils.profiler.time_compiled {tc_s * 1e3:.4f} ms "
        f"(IQR {tc_iqr * 1e3:.4f} ms, host clock, slope method), cuda_ms {cuda_ms(k2):.4f} ms "
        f"(CUDA events) [{smi}]")

    ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, device=dev)
    state = ctrl.init(N)
    for _ in range(3):
        _, state = ctrl.step(state, x0s)
    with tempfile.TemporaryDirectory() as tmp:
        for path in (os.path.join(tmp, "state.npz"), os.path.join(tmp, "state_dir")):
            checkpoint.save_checkpoint(path, state, {"tick": state.tick})
            back = checkpoint.load_checkpoint(path, like=ctrl.init(N))
            require(isinstance(back, MPCState) and back.U_prev.device == dev
                    and torch.equal(back.U_prev, state.U_prev) and back.tick == state.tick,
                    f"the MPCState comes back on the card, equal ({os.path.basename(path)})")
        log(f"checkpoint of a {N}-scenario MPCState (U_prev {tuple(state.U_prev.shape)}, tick "
            f"{state.tick}) through .npz and a directory: back on {back.U_prev.device}, equal")
        big = {"U": torch.randn((4096, 4096), device=dev), "tick": torch.tensor(3)}
        like = {"U": torch.empty((4096, 4096), device=dev), "tick": torch.tensor(0)}
        for path in (os.path.join(tmp, "big.npz"), os.path.join(tmp, "big_dir")):
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(path, big)
            t1 = time.perf_counter()
            back = checkpoint.load_checkpoint(path, like=like)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            require(torch.equal(back["U"], big["U"]), "the 64 MB checkpoint round trip")
            log(f"time checkpoint of 64 MB on the card ({os.path.basename(path)}): save "
                f"{(t1 - t0) * 1e3:.1f} ms, load {(t2 - t1) * 1e3:.1f} ms (host clock) [{smi}]")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this run needs a GPU",
              file=sys.stderr)
        return 1

    from numpower_tpu_torch.kernels import _build, boxqp_admm, boxqp_fista
    from numpower_tpu_torch.models import (
        MPCController, condense, quadrotor12, solve_mpc_boxqp, solve_mpc_boxqp_admm,
    )
    from numpower_tpu_torch.models.condensed import admm_coarse_iters, default_coarse_iters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 0: build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build/load {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    build_log = _build.library_path().with_suffix(".so.log")
    if build_log.is_file():
        for entry, line in ptxas_lines(build_log.read_text()):
            log(f"ptxas {entry}: {line}")
            if any(ns in entry for ns in CHECKED_FOR_SPILLS) and "spill" in line:
                require("0 bytes spill stores, 0 bytes spill loads" in line,
                        f"{entry} compiles without spills")
    sass = sass_opcode_counts(_build.library_path(), ("HGMMA", "LDS", "STS", "FFMA"))
    # the box-QP templates' products on the tensor cores: every instance (K2 in
    # 2 x 3 classes, K3b, K2'; K1 in 3 forms x 3 classes, K3a, K1') holds wgmma
    hgmma = {k: row["HGMMA"] for k, row in sass.items()
             if "boxqp::fista_kernel" in k or "boxqp::admm_kernel" in k}
    for name, count in sorted(hgmma.items()):
        log(f"HGMMA {count:4d} {name}")
    require(sum("fista_kernel" in k for k in hgmma) == 8
            and sum("admm_kernel" in k for k in hgmma) == 11
            and all(hgmma.values()), "every box-QP kernel instance runs its products as wgmma")
    # K5's shared-memory accesses and FMAs per (NB, MB) bucket: static counts
    # of each instance, whose step is unrolled (at (12, 4) its step loop
    # holds 96 of the 120 LDS and 16 of the 31 STS)
    for name, row in sorted(sass.items()):
        if "riccati::riccati_kernel" in name:
            log(f"SASS {name}: LDS {row['LDS']} STS {row['STS']} FFMA {row['FFMA']}")

    A, B = quadrotor12(0.02)
    n, m = 12, 4
    Q = np.eye(n, dtype=np.float32)
    R = np.eye(m, dtype=np.float32) * 0.1
    QF = np.eye(n, dtype=np.float32) * 5.0
    qp = condense(A, B, Q, R, QF, T, device=dev)
    d = T * m
    x0s = torch.as_tensor(0.3 * np.random.default_rng(0).standard_normal((N, n)),
                          dtype=torch.float32, device=dev)
    iters = 40
    fista_ci, admm_ci = default_coarse_iters(qp, iters), admm_coarse_iters(qp, iters)
    rho = torch.sqrt(qp.lipschitz * torch.clamp(qp.mu, min=1e-12))
    log(f"flagship: N={N} n={n} d={d} kappa={qp.kappa:.4f} schedules "
        f"FISTA {fista_ci}+{iters - fista_ci}, ADMM {admm_ci}+{iters - admm_ci}")
    fold = (qp.H, qp.Sx.T, qp.SuTQ.T)

    # -- phase 1: kernels against their plain versions ------------------------
    def shift(U):
        return torch.cat([U[:, m:], U[:, -m:]], dim=1).contiguous()

    err = {"fista": 0.0, "admm": 0.0}
    f0, a0 = boxqp_fista.fista_mpc_res.launches, boxqp_admm.admm_mpc_res.launches
    U_cold, _ = boxqp_fista.fista_mpc_res_reference(*fold, x0s, LO, HI, qp.lipschitz,
                                                    iters, fista_ci)
    z_cold, _, _ = boxqp_admm.admm_mpc_res_reference(*fold, x0s, LO, HI, rho, iters,
                                                     admm_ci)
    warm = {"fista": shift(U_cold), "admm": shift(z_cold)}
    for coarse_f, coarse_a, tol in ((0, 0, 1e-5), (fista_ci, admm_ci, 1e-4)):
        for start in ("cold", "warm"):
            U0 = None if start == "cold" else warm["fista"]
            Uk, rk = boxqp_fista.fista_mpc_res(*fold, x0s, LO, HI, qp.lipschitz, iters,
                                               coarse_f, U0)
            Up, rpl = boxqp_fista.fista_mpc_res_reference(*fold, x0s, LO, HI, qp.lipschitz,
                                                          iters, coarse_f, U0)
            du, dr = (Uk - Up).abs().max().item(), abs(rk.item() - rpl.item())
            log(f"K2 fista {coarse_f}+{iters - coarse_f} {start}: max|dU| {du:.3e} "
                f"(tol {tol:g}) resid {rk.item():.3e} vs {rpl.item():.3e}")
            require(du <= tol and dr <= 1e-5, f"K2 fista {coarse_f} {start} vs plain")
            err["fista"] = max(err["fista"], du)

            U0 = None if start == "cold" else warm["admm"]
            zk, rpk, rdk = boxqp_admm.admm_mpc_res(*fold, x0s, LO, HI, rho, iters, coarse_a,
                                                   U0=U0)
            zp, rpp, rdp = boxqp_admm.admm_mpc_res_reference(*fold, x0s, LO, HI, rho, iters,
                                                             coarse_a, U0=U0)
            dz = (zk - zp).abs().max().item()
            drp, drd = abs(rpk.item() - rpp.item()), abs(rdk.item() - rdp.item())
            log(f"K1 admm {coarse_a}+{iters - coarse_a} {start}: max|dz| {dz:.3e} "
                f"(tol {tol:g}) r_prim {rpk.item():.3e} vs {rpp.item():.3e} "
                f"r_dual {rdk.item():.3e} vs {rdp.item():.3e}")
            require(dz <= tol and drp <= 1e-5 and drd <= 1e-5,
                    f"K1 admm {coarse_a} {start} vs plain")
            err["admm"] = max(err["admm"], dz)
    require(boxqp_fista.fista_mpc_res.launches - f0 == 4, "K2 launched once per call")
    require(boxqp_admm.admm_mpc_res.launches - a0 == 4, "K1 launched once per call")

    # -- phases 2-3: the main path, counted -----------------------------------
    boxqp_fista.fista_mpc_res.launches = 0
    boxqp_admm.admm_mpc_res.launches = 0

    xs = x0s[:N_E2E]
    res_f = solve_mpc_boxqp(qp, xs, LO, HI, iters=iters)
    res_a = solve_mpc_boxqp_admm(qp, xs, LO, HI, iters=iters)
    require(boxqp_fista.fista_mpc_res.launches == 1, "solve_mpc_boxqp went through K2")
    require(boxqp_admm.admm_mpc_res.launches == 1, "solve_mpc_boxqp_admm went through K1")
    f64 = [t.double() for t in fold]
    U64, _ = boxqp_fista.fista_mpc_res_reference(*f64, xs.double(), LO, HI,
                                                 qp.lipschitz.double(), iters, 0)
    rho64 = torch.sqrt(qp.lipschitz.double() * torch.clamp(qp.mu.double(), min=1e-12))
    z64, _, _ = boxqp_admm.admm_mpc_res_reference(*f64, xs.double(), LO, HI, rho64, iters, 0)
    e2e_f = (res_f.U.double() - U64).abs().max().item()
    e2e_a = (res_a.U.double() - z64).abs().max().item()
    log(f"e2e {N_E2E} scenarios vs float64: FISTA {e2e_f:.3e}, ADMM {e2e_a:.3e} (tol 1e-4)")
    require(e2e_f <= 1e-4 and e2e_a <= 1e-4, "end-to-end deviation from float64")

    A_t = torch.as_tensor(A, device=dev)
    B_t = torch.as_tensor(B, device=dev)
    ctrls = {}
    for solver, counter in (("fista", boxqp_fista.fista_mpc_res),
                            ("admm", boxqp_admm.admm_mpc_res)):
        ctrl = MPCController(A, B, Q, R, QF, T, LO, HI, iters=30, solver=solver, device=dev)
        ctrls[solver] = ctrl
        state, x = ctrl.init(N), x0s.clone()
        resids, in_box = [], []
        for _ in range(N_TICKS):
            before = counter.launches
            u0, state, resid = ctrl.step_with_residual(state, x)
            require(counter.launches == before + 1, f"{solver} tick launched its kernel once")
            resids.append(resid)
            in_box.append(((u0 >= LO) & (u0 <= HI)).all())
            x = x @ A_t.T + u0 @ B_t.T
        resids = torch.stack(resids).cpu()
        require(bool(torch.isfinite(resids).all()), f"{solver} serving residuals finite")
        require(bool(torch.stack(in_box).all()), f"{solver} serving u0 within the box")
        require(state.tick == N_TICKS and bool(torch.isfinite(x).all()),
                f"{solver} closed loop finite")
        log(f"serving {solver}: {N_TICKS} ticks x {N} scenarios, iters 30 "
            f"({ctrl.coarse_iters} bf16), residual first {resids[0].item():.3e} "
            f"last {resids[-1].item():.3e}, |x| {x.abs().max().item():.3e}")
    launches = {"fista": boxqp_fista.fista_mpc_res.launches,
                "admm": boxqp_admm.admm_mpc_res.launches}
    log(f"main-path launches: {launches}")
    require(launches == {"fista": 1 + N_TICKS, "admm": 1 + N_TICKS},
            "every main-path solve and tick went through the kernels")

    # -- phase 4: times ------------------------------------------------------
    Minv = boxqp_admm.minv_factor(qp.H, rho)
    ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_mpc_res(
            *fold, x0s, LO, HI, qp.lipschitz, iters, fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_mpc_res(
            *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv)),
    }
    plain_ms = {
        "fista": cuda_ms(lambda: boxqp_fista.fista_mpc_res_reference(
            *fold, x0s, LO, HI, qp.lipschitz, iters, fista_ci)),
        "admm": cuda_ms(lambda: boxqp_admm.admm_mpc_res_reference(
            *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv)),
    }
    tick_ms, tick_host_ms = {}, {}
    for solver, ctrl in ctrls.items():
        holder = [ctrl.init(N)]

        def tick(ctrl=ctrl, holder=holder):
            _, holder[0] = ctrl.step(holder[0], x0s)

        tick_ms[solver], tick_host_ms[solver] = cuda_ms(tick), enqueue_ms(tick)
    for solver in ("fista", "admm"):
        log(f"time {solver} ({iters} iters) per {N}-scenario solve: kernel {ms[solver]:.4f} ms, "
            f"plain {plain_ms[solver]:.4f} ms; serving tick (30 iters) {tick_ms[solver]:.4f} ms, "
            f"its host enqueue {tick_host_ms[solver]:.4f} ms [{smi}]")
    log_own(f"K2 fista_mpc_res ({iters} iters, {N} scenarios)", lambda: boxqp_fista.fista_mpc_res(
        *fold, x0s, LO, HI, qp.lipschitz, iters, fista_ci), "fista_kernel", ms["fista"], smi)
    log_own(f"K1 admm_mpc_res ({iters} iters, {N} scenarios)", lambda: boxqp_admm.admm_mpc_res(
        *fold, x0s, LO, HI, rho, iters, admm_ci, Minv=Minv), "admm_kernel", ms["admm"], smi)
    boxqp_iteration_times(qp, x0s, rho, Minv, iters, smi)

    # fp32 on the host: the fold W = Sx'(Su'Q)' (K1 also its product with
    # Minv'). bf16 tensor-core passes in the kernel: the fold of g (or c) from
    # x0 at its class's count ("highest", 6), one per coarse product, six per
    # tail and residual product. Inputs H (and Minv), Sx', (Su'Q)', x0s.
    host_ops = 2 * n * (T * n) * d
    fold_passes = 2 * N * n * d * boxqp_passes(0, 1)
    fold_bytes = 4 * (d * d + n * T * n + T * n * d + N * n + 1)
    kernels = [
        kernel_entry("fista_mpc_res", "boxqp_fista.cu", "boxqp_fista.py:299", launches["fista"],
                     err["fista"], ms["fista"], plain_ms["fista"], fold_bytes + 4 * (N * d + 1),
                     host_ops, tensor_ops=fold_passes + 2 * N * d * d * boxqp_passes(
                         fista_ci, iters - fista_ci + 1)),
        kernel_entry("admm_mpc_res", "boxqp_admm.cu", "boxqp_admm.py:353", launches["admm"],
                     err["admm"], ms["admm"], plain_ms["admm"],
                     fold_bytes + 4 * (d * d + N * d + 2), host_ops + 2 * n * d * d,
                     tensor_ops=fold_passes + 2 * N * d * d * boxqp_passes(
                         admm_ci, iters - admm_ci + 1)),
    ]
    kernels += riccati_family(dev, smi)
    kernels += boxqp_two_step(dev, smi, qp, x0s, rho)
    kernels += ilqr_family(dev, smi)
    kernels += estimation_family(dev, smi)
    kernels += sampling_family(dev, smi)
    kernels += boxqp_variants_and_mesh(dev, smi, qp, x0s, rho)
    ops_family(dev, smi)
    ndarray_family(dev, smi)
    stream_family(dev, smi)
    utils_family(dev, smi)
    parallel_rest_family(dev, smi)
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
