"""Mixed-precision matmul schemes (port of numpower_tpu/kernels/precision.py).

The TPU kernels contract their coarse iterations with a single bf16 pass of
the matrix unit and their tail with hand-built hi/lo splits:

    x = x_hi + x_lo,  hi = bf16(x) upcast to fp32 (exactly representable),
    x @ y ~= hi@hi + hi@lo + lo@hi        ["bf16x3": drops only lo@lo]

These are the same schemes as plain PyTorch. The plain versions of the fused
kernels use :func:`bf16_round` for their coarse phase and
:func:`make_tail_dot` for the products of their precision classes (K1's
``c_precision``, K2's ``tail_precision`` and ``g_precision``); the CUDA
kernels compute the same split sums with fp32 FMAs (csrc/boxqp_tile.cuh),
the class passed as :data:`PRECISION_CODES`. The port's default class is
"highest": on the card's FMA pipes a split costs 3-4 products where fp32
costs one, and fp32 is at least as accurate.
"""

from __future__ import annotations

import torch

# A precision class's name and its code in the kernels' C interface
# (csrc/boxqp_tile.cuh, enum Precision).
PRECISION_CODES = {"highest": 0, "bf16x3": 3, "bf16x4": 4}


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
