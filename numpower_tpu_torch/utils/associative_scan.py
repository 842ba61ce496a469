"""Parallel prefix scan over the leading axis of a tuple of tensors (the
counterpart of jax.lax.associative_scan, which torch lacks).

The recursion is JAX's odd/even one: combine adjacent pairs, scan the pairs
recursively, then combine the scanned pairs with the remaining even elements
and interleave. The combine tree, and with it the fp32 rounding, is therefore
the one the JAX package's associative engines see; depth is O(log T) batched
calls of ``fn``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Elems = Sequence[torch.Tensor]


def _interleave(even: Elems, odd: Elems) -> list[torch.Tensor]:
    """x[0::2] = even, x[1::2] = odd along axis 0 (len(even) is len(odd) or
    len(odd) + 1)."""
    out = []
    for a, b in zip(even, odd):
        x = torch.empty((a.shape[0] + b.shape[0],) + a.shape[1:], dtype=a.dtype,
                        device=a.device)
        x[0::2] = a
        x[1::2] = b
        out.append(x)
    return out


def associative_scan(fn: Callable[[Elems, Elems], Elems], elems: Elems,
                     reverse: bool = False) -> tuple[torch.Tensor, ...]:
    """Inclusive scan of ``fn`` over axis 0 of every tensor of ``elems``.

    fn(a, b) takes two tuples of tensors whose leading axes are batches of
    elements (a earlier, b later) and returns their combination as a tuple.
    With reverse=True the scan runs from the end, and, as in JAX, fn is then
    called as fn(later, earlier): result[t] combines elements t..T-1."""
    elems = [torch.flip(e, dims=(0,)) for e in elems] if reverse else list(elems)

    def combine(a, b):
        return list(fn(tuple(a), tuple(b)))

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        reduced = combine([x[0:n - 1:2] for x in xs], [x[1::2] for x in xs])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([o[:-1] for o in odd], [x[2::2] for x in xs])
        else:
            even = combine(odd, [x[2::2] for x in xs])
        even = [torch.cat([x[:1], e], dim=0) for x, e in zip(xs, even)]
        return _interleave(even, odd)

    out = scan(elems)
    if reverse:
        out = [torch.flip(o, dims=(0,)) for o in out]
    return tuple(out)
