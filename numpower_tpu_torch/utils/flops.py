"""FLOP and byte accounting for the port's kernels on the NVIDIA H100 (port of
numpower_tpu/utils/flops.py).

The cost functions keep the JAX package's names and signatures, and their
LOGICAL operations and bytes are the JAX package's: they count the same
algorithmic work. What differs is the machine under them.

Box-QP kernels (K1-K3, K1', K2'). Every iteration product runs on the tensor
cores as bf16 ``wgmma`` passes (csrc/boxqp_tile.cuh): one block solves a tile
of 32 scenarios, and the (32, d) x (d, d) product is padded to M = K = 128
(kernels/_build.MAX_D), so the padded count rounds the scenarios up to 32
and d up to 128. A product costs :data:`PASSES` passes of its class: "bf16"
1 (the coarse phase), "bf16x3" 3, "bf16x4" 4, "highest" 6 (README
"Precision"). The weighted counts follow the port's default schedule: the
coarse phase 1 pass, the tail, the residual product and the g/c folds
"highest", where the JAX package runs a bf16x3 tail. Speed of light =
weighted operations / the bf16 tensor-core peak.

Everything else (the Riccati, iLQR, estimation and sampling kernels) runs on
the CUDA cores in fp32: speed of light = max(bytes / HBM rate, operations /
fp32 rate), the bytes an algorithmic lower bound (each input read once, each
output written once).

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at its
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
outside them, 3.35 TB/s of HBM. They are returned only for a device whose
name is the H100 SXM's ("NVIDIA H100 80GB HBM3"); any other device, and the
CPU, gets None.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from numpower_tpu_torch.kernels.precision import TENSOR_PASSES


class PeakRates(NamedTuple):
    bf16_tflops: float  # dense bf16 on the tensor cores
    fp32_tflops: float  # fp32 outside the tensor cores
    hbm_gbps: float     # HBM bandwidth, GB/s


# NVIDIA H100 SXM data sheet (dense rates, 700 W)
H100_SXM = PeakRates(bf16_tflops=989.0, fp32_tflops=67.0, hbm_gbps=3350.0)
_PEAKS = (("H100 80GB HBM3", H100_SXM), ("H100 SXM", H100_SXM))

# the JAX package's class names; the counts are the kernels' (kernels/precision.py)
PASSES = {"bf16": TENSOR_PASSES["coarse"],
          **{name: TENSOR_PASSES[name] for name in ("bf16x3", "bf16x4", "highest")}}

# the box-QP tile (csrc/boxqp_tile.cuh): 32 scenarios a block, d padded to 128
TILE_SCENARIOS, TILE_D = 32, 128


def boxqp_passes(coarse: int, tail: int, tail_class: str = "highest") -> int:
    """bf16 tensor-core passes of `coarse` coarse products and `tail` products
    in the class `tail_class`."""
    return coarse * PASSES["bf16"] + tail * PASSES[tail_class]


def _peaks(device) -> Optional[PeakRates]:
    """The data-sheet rates of ``device`` (a torch.device, an index, a device
    name such as torch.cuda.get_device_name gives; default the current CUDA
    device), None where its name is not one of the table's."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.cuda.current_device()
        device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(device)
    for tag, peaks in _PEAKS:
        if tag in name:
            return peaks
    return None


def peak_tflops(device=None) -> Optional[float]:
    """Dense bf16 tensor-core peak (TFLOP/s) of the device, or None."""
    peaks = _peaks(device)
    return None if peaks is None else peaks.bf16_tflops


def peak_hbm_gbps(device=None) -> Optional[float]:
    """HBM bandwidth peak (GB/s) of the device, or None."""
    peaks = _peaks(device)
    return None if peaks is None else peaks.hbm_gbps


def vpu_peak_tflops(device=None) -> Optional[float]:
    """fp32 peak outside the tensor cores (TFLOP/s), the role the JAX
    package's VPU peak plays; None off the H100."""
    peaks = _peaks(device)
    return None if peaks is None else peaks.fp32_tflops


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class KernelCost(NamedTuple):
    flops_logical: float   # useful FLOPs at the real problem dims
    flops_padded: float    # FLOPs the tensor cores execute (tile padding)
    flops_weighted: float  # padded FLOPs x precision passes (tensor-core work)

    def sol_seconds(self, peak_tf: float) -> float:
        """Speed-of-light time at the single-pass (bf16) peak."""
        return self.flops_weighted / (peak_tf * 1e12)

    def mfu(self, measured_seconds: float, peak_tf: float) -> float:
        return self.sol_seconds(peak_tf) / measured_seconds

    @property
    def padding_waste(self) -> float:
        return 1.0 - self.flops_logical / self.flops_padded


def _qp_kernel_cost(N: int, n: int, d: int, iters: int, coarse_iters: int,
                    extra_gemms, form_precision: str = "highest") -> KernelCost:
    """Inventory of the fused FISTA/ADMM MPC kernels: one (N, n) @ (n, d) g/c
    formation at `form_precision` (the kernels' fp32 fold, charged as the
    class's passes; no tile padding), iters (N, d) @ (d, d) iteration
    products (coarse 1 pass, tail "highest", the port's default), plus
    solver-specific extra products given as (logical_flops, padded_flops,
    passes) tuples."""
    N_pad = _round_up(N, TILE_SCENARIOS)
    d_pad = _round_up(d, TILE_D)
    tail = iters - coarse_iters

    logical = padded = weighted = 0.0

    def add(fl, fp, passes):
        nonlocal logical, padded, weighted
        logical += fl
        padded += fp
        weighted += fp * passes

    add(2 * N * n * d, 2 * N_pad * n * d, PASSES[form_precision])
    it_l, it_p = 2 * N * d * d, 2 * N_pad * d_pad * d_pad
    add(coarse_iters * it_l, coarse_iters * it_p, PASSES["bf16"])
    add(tail * it_l, tail * it_p, PASSES["highest"])
    for fl, fp, passes in extra_gemms:
        add(fl, fp, passes)
    return KernelCost(logical, padded, weighted)


def _residual_gemm(N: int, d: int):
    return (2 * N * d * d, 2 * _round_up(N, TILE_SCENARIOS) * _round_up(d, TILE_D) ** 2,
            PASSES["highest"])


def fista_mpc_cost(N: int, n: int, d: int, iters: int, coarse_iters: int) -> KernelCost:
    """kernels/boxqp_fista.fista_mpc_res (K2): iteration products + the g
    formation + one residual product."""
    return _qp_kernel_cost(N, n, d, iters, coarse_iters, [_residual_gemm(N, d)])


def admm_mpc_cost(N: int, n: int, d: int, iters: int, coarse_iters: int) -> KernelCost:
    """kernels/boxqp_admm.admm_mpc_res (K1): iteration products + the c
    formation (c_precision "highest", the port's default) + one residual
    x-update."""
    return _qp_kernel_cost(N, n, d, iters, coarse_iters, [_residual_gemm(N, d)])


class RooflineCost(NamedTuple):
    """Lower-bound work inventory of an fp32 kernel."""
    flops: float        # fp32 FLOPs
    bytes_moved: float  # algorithmic minimum HBM reads + writes

    def sol_seconds(self, hbm_gbps: float, fp32_tf: float) -> float:
        return max(self.bytes_moved / (hbm_gbps * 1e9), self.flops / (fp32_tf * 1e12))

    def bound(self, hbm_gbps: float, fp32_tf: float) -> str:
        """"bytes" or "operations": which of the two times is the larger."""
        mem = self.bytes_moved / (hbm_gbps * 1e9)
        ops = self.flops / (fp32_tf * 1e12)
        return "bytes" if mem >= ops else "operations"


def kalman_batched_cost(N: int, T: int, n: int, p: int) -> RooflineCost:
    """models/estimation.kalman_filter_batched (shared-covariance route, K9):
    one small covariance/gain recursion and the batched mean recurrence.
    Bytes: yss read once, filtered and predicted means written."""
    mean_flops = N * T * (2 * n * n + 4 * n * p + 2 * p * p + n + 4 * p)
    cov_flops = T * (8 * n ** 3 + 6 * n * n * p + 4 * n * p * p + p ** 3)
    bytes_moved = 4.0 * (N * T * p + 2 * N * T * n + N * n)
    return RooflineCost(float(mean_flops + cov_flops), float(bytes_moved))


def mppi_batched_cost(N: int, K: int, iters: int, T: int, m: int,
                      plant_flops: int = 12, cost_flops: int = 14) -> RooflineCost:
    """models/mppi.mppi_solve_batched (K13 or the plain route): iters full
    K-sample rollouts per scenario, per step a plant evaluation, a stage
    cost and the candidate (~4 ops an input), plus the per-round coupling,
    weights and update (~8 ops per (t, m) entry). Bytes: the perturbations
    read once plus x0/us."""
    per_step = plant_flops + cost_flops + 4 * m
    flops = (N * K * iters * (T * per_step + 8 * T * m + 6) + N * T * m * iters * 4)
    bytes_moved = 4.0 * (iters * T * m * N * K + N * T * m + N * 2)
    return RooflineCost(float(flops), float(bytes_moved))


def rts_batched_cost(N: int, T: int, n: int) -> RooflineCost:
    """models/estimation.kalman_smoother_batched (shared-gain route, K10):
    the gains once on (n, n) matrices, the batched backward mean recurrence.
    Bytes: filtered and predicted means read, smoothed means written."""
    mean_flops = N * T * 4 * n * n
    cov_flops = T * (10 * n ** 3)
    bytes_moved = 4.0 * (3 * N * T * n)
    return RooflineCost(float(mean_flops + cov_flops), float(bytes_moved))


def _associative_cost(T: int, elem_floats: int, combine_flops: float) -> RooflineCost:
    """The odd/even associative scan (utils/associative_scan.py): ~2T
    combines, each reading 2 elements and writing 1."""
    combines = 2.0 * T
    return RooflineCost(combines * combine_flops, combines * 3.0 * elem_floats * 4.0)


def riccati_associative_cost(T: int, n: int) -> RooflineCost:
    """models/lqr.riccati_associative: element (F, C, J) of 3n^2 floats, a
    combine ~18 n^3 FLOPs."""
    return _associative_cost(T, 3 * n * n, 18.0 * n ** 3)


def kalman_associative_cost(T: int, n: int) -> RooflineCost:
    """models/estimation.kalman_filter_associative: element (A, b, C, eta, J)
    of 3n^2 + 2n floats, a combine ~22 n^3 FLOPs."""
    return _associative_cost(T, 3 * n * n + 2 * n, 22.0 * n ** 3)


def riccati_fused_cost(N: int, T: int, n: int, m: int) -> RooflineCost:
    """kernels/riccati.riccati_batched_fused (K5): per scenario-step one
    Riccati update (4n^3 + 4mn^2 + 4m^2n + m^3); As/Bs read once, the
    (N, T, m, n) gains written."""
    step = 4 * n ** 3 + 4 * m * n * n + 4 * m * m * n + m ** 3
    bytes_moved = 4.0 * (N * (n * n + n * m) + N * T * m * n + N * n * n)
    return RooflineCost(float(N * T * step), float(bytes_moved))


def ilqr_backward_cost(N: int, T: int, n: int, m: int) -> RooflineCost:
    """kernels/ilqr_backward.ilqr_backward_fused (K7): per scenario-step one
    LQ backward update; the linearization and cost gradients read, the
    (N, T, m(n+1)) gains written."""
    step = 4 * n ** 3 + 6 * m * n * n + 4 * m * m * n + m ** 3 + 4 * n * n
    bytes_moved = 4.0 * N * T * (n * n + n * m + n + m + m * n + m)
    return RooflineCost(float(N * T * step), float(bytes_moved))


def particle_filter_cost(B: int, Np: int, T: int, n: int, p: int,
                         plant_flops: int = 40) -> RooflineCost:
    """models/particle.particle_filter_batched, propagation and weighting
    only: per particle-step a plant evaluation, the noise product (2n^2) and
    the weighting (2np + p^2); bytes: the cloud read and written per step
    and once more for the resampler (pf_resample_cost counts that)."""
    step = plant_flops + 2 * n * n + 2 * n * p + p * p
    bytes_moved = 4.0 * B * Np * T * n * 4.0
    return RooflineCost(float(B * Np * T * step), float(bytes_moved))


def ekf_batched_cost(B: int, T: int, n: int, p: int, plant_flops: int = 40) -> RooflineCost:
    """kernels/ekf.py (K11): per step n tangents of f and of h, A P A'
    (2n^3), the C-side terms, the p-solve and the mean/ll updates. Bytes:
    ys/us read, filtered/predicted means and covariances written."""
    step = (2 * n * plant_flops + 2 * n * 2 * n * p + 2 * n ** 3
            + 3 * p * n * n + 2 * p * p * n + 4 * n * p + 6 * p)
    bytes_moved = 4.0 * B * T * (p + 1 + 2 * n + 2 * n * n)
    return RooflineCost(float(B * T * step), float(bytes_moved))


def ukf_batched_cost(B: int, T: int, n: int, p: int, plant_flops: int = 40) -> RooflineCost:
    """kernels/ukf.py (K12): per step two small Cholesky factorizations,
    2n+1 plant and measurement evaluations, the weighted moments and the
    p-solve/update."""
    K = 2 * n + 1
    step = (2 * (n ** 3) // 3 + K * (plant_flops + n * p)
            + 3 * K * n * n + 2 * K * n + 2 * K * p * p
            + 2 * p * p * n + 4 * n * p + 6 * p)
    bytes_moved = 4.0 * B * T * (p + 1 + 2 * n + 2 * n * n)
    return RooflineCost(float(B * T * step), float(bytes_moved))


def pf_resample_cost(B: int, Np: int, T: int, n: int) -> KernelCost:
    """models/particle._systematic_resample: the JAX package's one-hot
    contraction, 2 B Np^2 n FLOPs a step, charged every step (the resample
    runs every step and is chosen by a select). The port's K14 runs no
    product (a binary search and a gather per slot), so nothing is padded
    and one pass is charged: the count is the JAX construction's work, kept
    for comparison."""
    logical = 2.0 * B * Np * Np * n * T
    return KernelCost(logical, logical, logical * PASSES["bf16"])


def roofline_report(label: str, cost: RooflineCost, measured_seconds: float,
                    device=None) -> str:
    """One-line bytes/operations roofline report."""
    hbm = peak_hbm_gbps(device)
    fp32 = vpu_peak_tflops(device)
    gbs = cost.bytes_moved / measured_seconds / 1e9
    tf = cost.flops / measured_seconds / 1e12
    if hbm is None or fp32 is None:
        return (f"[roofline] {label}: {gbs:.1f} GB/s, {tf:.2f} TFLOP/s achieved; "
                f"no H100 peak known for this device, utilization n/a")
    sol = cost.sol_seconds(hbm, fp32)
    util = sol / measured_seconds
    return (f"[roofline] {label}: {gbs:.1f} GB/s + {tf:.2f} TFLOP/s achieved; "
            f"{cost.bound(hbm, fp32)}-bound speed of light {sol * 1e6:.1f} us vs measured "
            f"{measured_seconds * 1e6:.1f} us -> {100 * util:.0f}% of roofline "
            f"(peaks {hbm:.0f} GB/s, {fp32:.1f} fp32 TFLOP/s)")


def mfu_report(label: str, cost: KernelCost, measured_seconds: float,
               peak_tf: Optional[float]) -> str:
    """One-line tensor-core utilization report."""
    ach_padded = cost.flops_padded / measured_seconds / 1e12
    ach_logical = cost.flops_logical / measured_seconds / 1e12
    if peak_tf is None:
        return (f"[mfu] {label}: {ach_logical:.1f} TFLOP/s logical ({ach_padded:.1f} padded); "
                f"no H100 peak known, MFU n/a")
    sol = cost.sol_seconds(peak_tf)
    return (f"[mfu] {label}: {ach_logical:.1f} TFLOP/s logical / {ach_padded:.1f} padded; "
            f"tensor-core pass speed of light {sol * 1e6:.1f} us vs measured "
            f"{measured_seconds * 1e6:.1f} us -> MFU "
            f"{100 * cost.mfu(measured_seconds, peak_tf):.0f}% of {peak_tf:.0f} TFLOP/s bf16 "
            f"peak (padding waste {100 * cost.padding_waste:.1f}%)")
