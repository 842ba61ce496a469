"""Array creation (the port's counterpart of numpower_tpu/ops/creation.py).

The JAX functions under the same names and signatures, as plain torch calls,
with one argument more on the functions that build an array from nothing:
``device``, where None means the card (``utils.default_device``). The device
rule of every op of the port:

- a tensor operand keeps its device;
- numpy arrays, lists and Python scalars follow the first tensor operand, and
  go to the card where there is none.

Results hold the JAX package's dtypes: it runs with 64-bit types off, so a
numpy float64 or int64 operand and a named "float64" or "int64" dtype give
float32 and int32 (``dtypes.canonical``; a torch tensor keeps its dtype), and
Python natives become float32, the default type (``utils.config``). ``empty``
gives zeros, as the JAX function does (XLA has no uninitialised allocation).
This module also holds the operand steps every op module shares
(``as_operands``, ``promoted``, ``binary``, ``accumulation_dtype``,
``dims``).
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from numpower_tpu_torch.ops.dtypes import canonical, numpy_dtype, resolve_dtype
from numpower_tpu_torch.utils.config import default_dtype
from numpower_tpu_torch.utils.device import default_device

Shape = Union[int, Sequence[int]]


def _normalize_shape(shape: Shape) -> tuple:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dtype_or_default(dtype) -> torch.dtype:
    return canonical(resolve_dtype(dtype) or default_dtype())


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def asarray(obj: Any, dtype=None, device=None) -> torch.Tensor:
    """Coerce scalars, nested sequences, numpy arrays and tensors to a tensor.

    A tensor keeps its dtype and device (unless `dtype` or `device` is
    named); a numpy array keeps its dtype (float64 and int64 held as float32
    and int32, as in the JAX package); Python natives become float32. Others
    go to `device`, the card where it is None."""
    dt = None if dtype is None else canonical(resolve_dtype(dtype))
    if isinstance(obj, torch.Tensor):
        out = obj if device is None else obj.to(device)
        return out if dt is None else out.to(dt)
    dev = _device(device)
    if isinstance(obj, np.ndarray) or (hasattr(obj, "__array__")
                                       and not isinstance(obj, np.generic)):
        host = torch.as_tensor(np.asarray(obj))
        return host.to(device=dev, dtype=canonical(host.dtype) if dt is None else dt, copy=True)
    return torch.as_tensor(obj, dtype=default_dtype() if dt is None else dt, device=dev)


def as_operands(*xs) -> tuple:
    """The operands of one op as tensors: each tensor keeps its device, and
    the others follow the first tensor (the card where there is none)."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(asarray(x, device=dev) for x in xs)


def promoted(*xs) -> tuple:
    """:func:`as_operands` cast to their common dtype (the JAX package's
    promotion of its arrays: every operand, Python scalars too, is a
    concrete array there, so none is weakly typed)."""
    ts = as_operands(*xs)
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)


def binary(fn, name: str, a, b) -> torch.Tensor:
    """fn on :func:`promoted` operands; where their shapes do not broadcast,
    the error the JAX op raises in place of torch's RuntimeError: TypeError
    ("add got incompatible shapes for broadcasting: ...") for operands of
    one rank, ValueError ("Incompatible shapes for broadcasting: ...") for
    operands of two."""
    a, b = promoted(a, b)
    try:
        return fn(a, b)
    except RuntimeError:
        try:
            torch.broadcast_shapes(a.shape, b.shape)
        except RuntimeError:
            shapes = (tuple(a.shape), tuple(b.shape))
            if a.ndim != b.ndim:
                raise ValueError(f"Incompatible shapes for broadcasting: shapes={list(shapes)}"
                                 ) from None
            raise TypeError(f"{name} got incompatible shapes for broadcasting: "
                            f"{shapes[0]}, {shapes[1]}.") from None
        raise


def accumulation_dtype(dt: torch.dtype) -> torch.dtype:
    """What a product or convolution of `dt` operands accumulates in:
    float32, the JAX ops' preferred element type (float64 and complex
    tensors keep their own)."""
    return dt if dt in (torch.float64, torch.complex64, torch.complex128) else torch.float32


def dims(axis):
    """An axis argument (None, an int, or a list or tuple of ints) as torch's
    dim argument."""
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def array(obj: Any, dtype=None, device=None) -> torch.Tensor:
    """nd::array."""
    return asarray(obj, dtype=dtype, device=device)


def zeros(shape: Shape, dtype=None, device=None) -> torch.Tensor:
    """nd::zeros."""
    return torch.zeros(_normalize_shape(shape), dtype=_dtype_or_default(dtype),
                       device=_device(device))


def ones(shape: Shape, dtype=None, device=None) -> torch.Tensor:
    """nd::ones."""
    return torch.ones(_normalize_shape(shape), dtype=_dtype_or_default(dtype),
                      device=_device(device))


def full(shape: Shape, fill_value, dtype=None, device=None) -> torch.Tensor:
    """nd::full; `fill_value` may be an array that broadcasts to `shape`."""
    shape, dt = _normalize_shape(shape), _dtype_or_default(dtype)
    if isinstance(fill_value, (bool, int, float, np.number)):
        return torch.full(shape, fill_value, dtype=dt, device=_device(device))
    value = asarray(fill_value, device=device)
    return torch.broadcast_to(value.to(dt), shape).clone()


def empty(shape: Shape, dtype=None, device=None) -> torch.Tensor:
    """NumPower's NDArray_Empty: zeros here, as in the JAX package."""
    return zeros(shape, dtype=dtype, device=device)


def _like(a, dtype, fill: float) -> torch.Tensor:
    a = asarray(a)
    dt = a.dtype if dtype is None else canonical(resolve_dtype(dtype))
    return torch.full(a.shape, fill, dtype=dt, device=a.device)


def empty_like(a, dtype=None) -> torch.Tensor:
    """Zeros of `a`'s shape, dtype (unless named) and device."""
    return _like(a, dtype, 0)


def zeros_like(a, dtype=None) -> torch.Tensor:
    return _like(a, dtype, 0)


def ones_like(a, dtype=None) -> torch.Tensor:
    return _like(a, dtype, 1)


def identity(n: int, dtype=None, device=None) -> torch.Tensor:
    """nd::identity."""
    return torch.eye(int(n), dtype=_dtype_or_default(dtype), device=_device(device))


def eye(n: int, m: Optional[int] = None, k: int = 0, dtype=None, device=None) -> torch.Tensor:
    """Ones on the k-th diagonal of an (n, m) matrix."""
    n = int(n)
    m = n if m is None else int(m)
    dev = _device(device)
    rows = torch.arange(n, device=dev)[:, None]
    return (torch.arange(m, device=dev) - rows == k).to(_dtype_or_default(dtype))


def arange(start, stop=None, step=1, dtype=None, device=None) -> torch.Tensor:
    """nd::arange in NumPy's argument order (start, stop, step), float32 by
    default. The values are numpy's, as in the JAX package (jnp.arange with a
    step computes them with numpy)."""
    if stop is None:
        start, stop = 0, start
    dt = _dtype_or_default(dtype)
    np_dt = numpy_dtype(dt) or np.dtype(np.float32)  # numpy has no bfloat16
    values = torch.as_tensor(np.arange(start, stop, step, dtype=np_dt))
    return values.to(device=_device(device), dtype=dt, copy=True)


def linspace(start, stop, num: int = 50, endpoint: bool = True, dtype=None,
             device=None) -> torch.Tensor:
    """`num` values from start to stop, as jnp.linspace forms them:
    start (1 - s) + stop s with s = i / div in float32 (div = num - 1 with the
    endpoint, which is then stop itself, else num)."""
    if num < 0:
        raise ValueError(f"Number of samples, {num}, must be non-negative.")
    dt = _dtype_or_default(dtype)
    work = dt if dt.is_floating_point else torch.float32
    dev = _device(device)
    lo = torch.as_tensor(start, dtype=work, device=dev)
    hi = torch.as_tensor(stop, dtype=work, device=dev)
    div = num - 1 if endpoint else num
    if num > 1:
        s = torch.arange(div, dtype=torch.float32, device=dev) / torch.tensor(
            div, dtype=torch.float32, device=dev)
        s = s.to(work)
        out = lo * (1 - s) + hi * s
        if endpoint:
            out = torch.cat([out, hi.reshape(1)])
    elif num == 1:
        out = lo.reshape(1)
    else:
        out = torch.zeros((0,), dtype=work, device=dev)
    if not dt.is_floating_point:
        out = torch.floor(out)
    return out.to(dt)


def diag(v, k: int = 0) -> torch.Tensor:
    """nd::diag: the diagonal matrix of a 1-d array, or a 2-d array's k-th
    diagonal."""
    return torch.diag(asarray(v), k)


def diagonal(a, offset: int = 0, axis1: int = 0, axis2: int = 1) -> torch.Tensor:
    """NumPower's NDArray_Diagonal, batched over the other axes like NumPy."""
    return torch.diagonal(asarray(a), offset=offset, dim1=axis1, dim2=axis2)


def fill(a, value) -> torch.Tensor:
    """NumPower's in-place fill: a new array of `a`'s shape, dtype and device
    holding `value`."""
    a = asarray(a)
    return torch.full(a.shape, value, dtype=a.dtype, device=a.device)


def copy(a) -> torch.Tensor:
    """NumPower's NDArray_Copy."""
    return asarray(a).clone()


def tri(n: int, m: Optional[int] = None, k: int = 0, dtype=None, device=None) -> torch.Tensor:
    """Ones at and below the k-th diagonal of an (n, m) matrix."""
    n = int(n)
    m = n if m is None else int(m)
    dev = _device(device)
    rows = torch.arange(n, device=dev)[:, None]
    return (torch.arange(m, device=dev) <= rows + k).to(_dtype_or_default(dtype))
