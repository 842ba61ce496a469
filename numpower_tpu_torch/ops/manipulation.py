"""Shape and layout manipulation (the port's counterpart of
numpower_tpu/ops/manipulation.py): each op one torch call with NumPy's
semantics. Concatenations promote their operands to one dtype; ``slice``
takes Python's slice semantics, negative steps included (torch indexing has
none: such an axis is gathered).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from numpower_tpu_torch.ops.creation import as_operands, asarray, promoted


def transpose(a, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    a = asarray(a)
    return a.permute(tuple(reversed(range(a.ndim))) if axes is None else tuple(axes))


def reshape(a, shape) -> torch.Tensor:
    if isinstance(shape, int):
        shape = (shape,)
    a, shape = asarray(a), tuple(shape)
    try:
        return torch.reshape(a, shape)
    except RuntimeError:  # the JAX op's TypeError
        raise TypeError(f"cannot reshape array of shape {tuple(a.shape)} (size {a.numel()}) "
                        f"into shape {shape}") from None


def flatten(a) -> torch.Tensor:
    return torch.ravel(asarray(a))


ravel = flatten


def flip(a, axis=None) -> torch.Tensor:
    a = asarray(a)
    if axis is None:
        axis = tuple(range(a.ndim))
    return torch.flip(a, (axis,) if isinstance(axis, int) else tuple(axis))


def expand_dims(a, axis) -> torch.Tensor:
    a = asarray(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    ndim = a.ndim + len(axes)
    for ax in sorted(ax % ndim for ax in axes):
        a = a.unsqueeze(ax)
    return a


def squeeze(a, axis=None) -> torch.Tensor:
    a = asarray(a)
    if axis is None:
        return torch.squeeze(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for ax in axes:
        if a.shape[ax] != 1:
            raise ValueError("cannot select an axis to squeeze out which has size not equal "
                             f"to one, got shape={tuple(a.shape)} and dimensions={axes}")
    return torch.squeeze(a, axes)


def swapaxes(a, axis1: int, axis2: int) -> torch.Tensor:
    return torch.swapaxes(asarray(a), axis1, axis2)


def rollaxis(a, axis: int, start: int = 0) -> torch.Tensor:
    """NumPy's rollaxis: `axis` moved to before position `start`."""
    a = asarray(a)
    axis %= a.ndim
    if not -a.ndim <= start <= a.ndim:
        raise ValueError(f"start={start} must satisfy {-a.ndim} <= start <= {a.ndim}")
    if start < 0:
        start += a.ndim
    if start > axis:
        start -= 1
    return torch.movedim(a, axis, start)


def moveaxis(a, source, destination) -> torch.Tensor:
    return torch.movedim(asarray(a), source, destination)


def concatenate(arrays: Sequence, axis: Optional[int] = 0) -> torch.Tensor:
    """Along `axis`; axis=None flattens each array first."""
    arrays = promoted(*arrays)
    if axis is None:
        return torch.cat([torch.ravel(a) for a in arrays])
    return torch.cat(arrays, dim=axis)


def append(a, values, axis: Optional[int] = None) -> torch.Tensor:
    """`values` after `a` along `axis`, both flattened where it is None."""
    return concatenate([a, values], axis=axis)


def vstack(arrays: Sequence) -> torch.Tensor:
    return torch.vstack(promoted(*arrays))


def hstack(arrays: Sequence) -> torch.Tensor:
    return torch.hstack(promoted(*arrays))


def dstack(arrays: Sequence) -> torch.Tensor:
    return torch.dstack(promoted(*arrays))


def column_stack(arrays: Sequence) -> torch.Tensor:
    return torch.column_stack(promoted(*arrays))


def stack(arrays: Sequence, axis: int = 0) -> torch.Tensor:
    return torch.stack(promoted(*arrays), dim=axis)


def atleast_1d(a) -> torch.Tensor:
    return torch.atleast_1d(asarray(a))


def atleast_2d(a) -> torch.Tensor:
    return torch.atleast_2d(asarray(a))


def atleast_3d(a) -> torch.Tensor:
    return torch.atleast_3d(asarray(a))


def split(a, indices_or_sections, axis: int = 0) -> list:
    """`a` cut along `axis` into equal sections (an int that must divide the
    axis) or at the given indices."""
    a = asarray(a)
    n = a.shape[axis]
    if isinstance(indices_or_sections, int):
        if n % indices_or_sections:
            raise ValueError("array split does not result in an equal division")
        return list(torch.tensor_split(a, indices_or_sections, dim=axis))
    cuts = [int(i) for i in indices_or_sections]
    if any(b < a_ for a_, b in zip([0, *cuts], [*cuts, n])):
        # jnp.split's rule: numpy would return empty pieces, or count a
        # negative cut from the end
        raise ValueError(f"Sizes passed to split must be nonnegative, got cuts {cuts} of {n}")
    return list(torch.tensor_split(a, cuts, dim=axis))


def tile(a, reps) -> torch.Tensor:
    return torch.tile(asarray(a), (reps,) if isinstance(reps, int) else tuple(reps))


def repeat(a, repeats, axis=None) -> torch.Tensor:
    """Each element repeated `repeats` times along `axis` (of the flattened
    array where it is None)."""
    a = asarray(a)
    if not isinstance(repeats, int):
        repeats = asarray(repeats, device=a.device).to(torch.int64)
    return torch.repeat_interleave(a, repeats, dim=axis)


def roll(a, shift, axis=None) -> torch.Tensor:
    return torch.roll(asarray(a), shift, dims=axis)


def broadcast_to(a, shape) -> torch.Tensor:
    return torch.broadcast_to(asarray(a), tuple(shape))


def is_broadcastable(a, b) -> bool:
    """NumPy's broadcasting rules."""
    a, b = as_operands(a, b)
    try:
        torch.broadcast_shapes(a.shape, b.shape)
        return True
    except RuntimeError:
        return False


_pyslice = slice  # the builtin, before the op below shadows it


def slice(a, *specs) -> torch.Tensor:  # noqa: A001 - mirrors the NumPower name
    """NumPower's NDArray_Slice with Python's slice semantics. Each spec is an
    int index, [start], [start, stop], [start, stop, step] or a slice
    object; a negative step is taken by gathering that axis."""
    a = asarray(a)
    indexer, gathers = [], []
    for spec in specs:
        if isinstance(spec, (list, tuple)):
            parts = list(spec) + [None] * (3 - len(spec))
            spec = _pyslice(*parts[:3])
        if isinstance(spec, _pyslice) and spec.step is not None and spec.step < 0:
            gathers.append((len(indexer), spec))
            spec = _pyslice(None)
        indexer.append(spec)
    out = a[tuple(indexer)]
    for position, spec in gathers:
        # the result's axis: the specs before it that are not int indices
        dim = sum(not isinstance(s, int) for s in indexer[:position])
        index = torch.arange(*spec.indices(out.shape[dim]), device=out.device)
        out = torch.index_select(out, dim, index)
    return out
