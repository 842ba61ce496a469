"""Batched small-matrix Cholesky (K6a) and SPD solve (K6b) kernels (port of
numpower_tpu/kernels/cholesky.py ``cholesky_batched`` and
``psd_solve_batched``).

The kernels are CUDA C++ in two forms, each with a note on what bounds it on
the H100 and how the design answers that. ``csrc/cholesky.cu`` for n <= 16
(and, for K6b, r <= 16 right-hand-side columns): K6a a group of lanes per
matrix, lane i holding row i in registers, the pivots and columns passed by
shuffles; K6b one thread per (column, matrix), the block's tile factored in
shared memory with its diagonal held inverted. ``csrc/cholesky_wide.cu``
past that, up to n = r = 48: K6a one warp a matrix, lane i holding rows i
and i + 32; K6b one block a matrix, factored by one warp as K6a's wide form
into shared memory, then a thread a column. All stage the block's tile by
16-byte copies and write it back as 16-byte pieces. Their plain PyTorch
versions are the unrolled recurrences of utils/smallmat.py, which compute the
same function the same way: ``cholesky_batched_reference`` is
``cholesky_unrolled`` and ``psd_solve_batched_reference`` is
``psd_solve_unrolled``. Each wrapper takes its plain version for a tensor on
the CPU only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand
from numpower_tpu_torch.utils.smallmat import cholesky_unrolled, psd_solve_unrolled

# The narrow forms' envelope (csrc/cholesky.cu: one template instance per n,
# K6b's block (r, tile) threads) and the wide forms' (csrc/cholesky_wide.cu,
# buckets of n to 48): the JAX package documents its factor as the drop-in
# "where n <= ~48", and its Riccati's "pallas" route solves against n
# columns, so both reach n = 48.
NARROW_DIM = 16
NARROW_RHS = 16
MAX_DIM = 48  # matrix dimension
MAX_RHS = 48  # right-hand-side columns of the solve

cholesky_batched_reference = cholesky_unrolled
psd_solve_batched_reference = psd_solve_unrolled


def _batch_shape(a: torch.Tensor) -> tuple[int, int]:
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be a batch (N, n, n) of square matrices, got {tuple(a.shape)}")
    N, n = a.shape[0], a.shape[1]
    if not (N >= 1 and 1 <= n <= MAX_DIM):
        raise ValueError(f"(N, n) = ({N}, {n}) is outside the kernel's envelope: "
                         f"N >= 1, n <= {MAX_DIM}")
    return N, n


def cholesky_batched(a: torch.Tensor, tile_b: int = 1024, interpret: bool = False) -> torch.Tensor:
    """Lower Cholesky of a batch of small SPD matrices: (N, n, n) -> (N, n, n).

    Reads the lower triangle only; the strictly upper triangle of the result
    is exactly 0. Envelope n <= MAX_DIM (ValueError beyond); the narrow form
    runs n <= NARROW_DIM, the wide form the rest. No check: a non-PD matrix
    gives NaN from its failing column on. On a CPU tensor this is :func:`cholesky_batched_reference`. Each
    kernel launch adds one to ``cholesky_batched.launches``. tile_b and
    interpret are the JAX package's arguments and have no effect: the
    operand's device chooses the route."""
    del tile_b, interpret
    if a.device.type == "cpu":
        return cholesky_batched_reference(a)
    N, n = _batch_shape(a)
    a = a.contiguous()  # a strided or broadcast view is copied
    _check_operand("a", a, a.device, (N, n, n))
    L = torch.empty_like(a)
    entry = "npt_cholesky_batched" if n <= NARROW_DIM else "npt_cholesky_batched_wide"
    code = _build.launch(entry, a.device, a.data_ptr(), L.data_ptr(), N, n)
    _build.check(code, "cholesky_batched kernel launch")
    cholesky_batched.launches += 1
    return L


def psd_solve_batched(a: torch.Tensor, b: torch.Tensor, tile_b: int = 1024,
                      interpret: bool = False) -> torch.Tensor:
    """Batched SPD solve A X = B: a (N, n, n), b (N, n, r) -> X (N, n, r).

    One fused kernel: factor (lower triangle of a only, diagonal held
    inverted) and forward/back substitution; the factor never leaves the
    block. Envelope n <= MAX_DIM, r <= MAX_RHS (ValueError beyond); the
    narrow form runs n <= NARROW_DIM with r <= NARROW_RHS, the wide form the
    rest. No check: a non-PD matrix gives NaN. The Riccati inner solve
    K = (R + B'PB)^{-1} (B'PA) is this with n = controls, r = states. On a
    CPU tensor this is :func:`psd_solve_batched_reference`. Each kernel
    launch adds one to ``psd_solve_batched.launches``. tile_b and interpret
    as in :func:`cholesky_batched`."""
    del tile_b, interpret
    if a.device.type == "cpu":
        return psd_solve_batched_reference(a, b)
    N, n = _batch_shape(a)
    if b.ndim != 3 or not 1 <= b.shape[-1] <= MAX_RHS:
        raise ValueError(f"b must be (N, n, r) with 1 <= r <= {MAX_RHS} (the kernel's "
                         f"envelope), got {tuple(b.shape)}")
    r = b.shape[-1]
    a, b = a.contiguous(), b.contiguous()  # strided or broadcast views are copied
    _check_operand("a", a, a.device, (N, n, n))
    _check_operand("b", b, a.device, (N, n, r))
    x = torch.empty_like(b)
    narrow = n <= NARROW_DIM and r <= NARROW_RHS
    code = _build.launch("npt_psd_solve_batched" if narrow else "npt_psd_solve_batched_wide",
                         a.device, a.data_ptr(), b.data_ptr(), x.data_ptr(), N, n, r)
    _build.check(code, "psd_solve_batched kernel launch")
    psd_solve_batched.launches += 1
    return x


cholesky_batched.launches = 0
psd_solve_batched.launches = 0
