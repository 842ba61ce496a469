"""Mixed-precision matmul schemes (port of numpower_tpu/kernels/precision.py).

The TPU kernels contract their coarse iterations with a single bf16 pass of
the matrix unit and their tail with hand-built hi/lo splits:

    x = x_hi + x_lo,  hi = bf16(x) upcast to fp32 (exactly representable),
    x @ y ~= hi@hi + hi@lo + lo@hi        ["bf16x3": drops only lo@lo]

These are the same schemes as plain PyTorch. The plain versions of the fused
kernels use :func:`bf16_round` for their coarse phase and
:func:`make_tail_dot` for the products of their precision classes (K1's
``c_precision``, K2's ``tail_precision`` and ``g_precision``), the class
passed to the CUDA kernels as :data:`PRECISION_CODES`.

On the card the box-QP kernels form every iteration product as bf16 passes
on the tensor cores (csrc/boxqp_tile.cuh), :data:`TENSOR_PASSES` a class,
over the exact three-way split x = hi + mid + lo (:func:`bf16_split3`):
the coarse phase is hi@hi, "bf16x3" adds hi@mid + mid@hi, "bf16x4" also
mid@mid, and "highest" hi@hi, hi@mid, mid@hi, hi@lo, lo@hi and mid@mid, as
accurate as fp32. The hi@hi pass is summed apart from the corrections.
:func:`bf16_pass_product` computes that sum in plain PyTorch for the tests;
nothing on the card's path calls it. The (n, d) folds of g and c stay fp32
FMAs in the kernels, in the two-way split of :func:`make_tail_dot`.
"""

from __future__ import annotations

import torch

# A precision class's name and its code in the kernels' C interface
# (csrc/boxqp_tile.cuh, enum Precision).
PRECISION_CODES = {"highest": 0, "bf16x3": 3, "bf16x4": 4}

# bf16 tensor-core passes of a product in each class, and of a coarse one
# (csrc/boxqp_tile.cuh, passes()).
TENSOR_PASSES = {"coarse": 1, "bf16x3": 3, "bf16x4": 4, "highest": 6}

# The passes of each count as (left part, right part) of the split (0 hi,
# 1 mid, 2 lo): hi@hi first, then the corrections in the kernel's order.
_PASS_PARTS = {
    1: ((0, 0),),
    3: ((0, 0), (0, 1), (1, 0)),
    4: ((0, 0), (0, 1), (1, 0), (1, 1)),
    6: ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)),
}


def precision_code(name: str, allowed: tuple, what: str) -> int:
    """The C code of precision class ``name``, or a ValueError when the
    option ``what`` does not take it (``allowed``: the JAX package's set)."""
    if name not in allowed:
        raise ValueError(f"unknown {what} {name!r} ({'|'.join(allowed)})")
    return PRECISION_CODES[name]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and held in x's dtype again: what a
    single-pass bf16 matmul does to each operand."""
    return x.to(torch.bfloat16).to(x.dtype)


def bf16_split(x: torch.Tensor):
    """Exact split x = hi + lo with both parts bf16-representable but stored
    as fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, x - hi


def bf16_split3(x: torch.Tensor):
    """Exact split x = hi + mid + lo of fp32 x, each part a bf16 (round to
    nearest even) held as fp32: hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid). Exact for fp32 normals whose lo stays normal."""
    hi = x.to(torch.bfloat16).float()
    rest = x - hi
    mid = rest.to(torch.bfloat16).float()
    return hi, mid, (rest - mid).to(torch.bfloat16).float()


def bf16_pass_product(x: torch.Tensor, y: torch.Tensor, passes: int) -> torch.Tensor:
    """x @ y (fp32) as the box-QP kernels form it on the tensor cores: the
    bf16 passes of the class with ``passes`` passes (1, 3, 4 or 6) over the
    three-way splits of both operands, each pass an fp32 sum of exact
    products, the hi@hi pass in one sum and the corrections in another,
    added last. Plain PyTorch, for the tests."""
    if passes not in _PASS_PARTS:
        raise ValueError(f"a class is 1, 3, 4 or 6 passes, got {passes}")
    xs, ys = bf16_split3(x), bf16_split3(y)
    (i, j), *corrections = _PASS_PARTS[passes]
    out = xs[i] @ ys[j]
    if not corrections:
        return out
    corr = sum(xs[a] @ ys[b] for a, b in corrections)
    return out + corr


def make_tail_dot(Ht: torch.Tensor, tail_precision: str):
    """Returns dot(Y) -> Y @ Ht at the requested tail precision.

    "bf16x3": 3-pass hi/lo scheme with Ht split once. "bf16x4": all four
    terms (keeps lo@lo), for iteration-invariant operands. "highest": fp32.
    """
    if tail_precision in ("bf16x3", "bf16x4"):
        Ht_hi, Ht_lo = bf16_split(Ht)
        full = tail_precision == "bf16x4"

        def tail_dot(Y):
            Y_hi, Y_lo = bf16_split(Y)
            out = Y_hi @ Ht_hi + Y_hi @ Ht_lo + Y_lo @ Ht_hi
            return out + Y_lo @ Ht_lo if full else out

        return tail_dot
    if tail_precision == "highest":
        def tail_dot(Y):
            return Y @ Ht

        return tail_dot
    raise ValueError(f"unknown tail_precision {tail_precision!r}")
