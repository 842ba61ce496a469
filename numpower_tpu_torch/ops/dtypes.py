"""Type registry: the NumPower names ("float32", "double64", ...), numpy
names and numpy or torch dtypes, mapped to torch dtypes (the port's
counterpart of numpower_tpu/ops/dtypes.py).

The JAX package runs with 64-bit types off: an array it creates as float64
or int64 holds float32 or int32. :func:`canonical` applies the same rule to
the dtypes of the port's results, so each op returns the JAX op's dtype;
:func:`resolve_dtype`, :func:`get_type_size` and :func:`is_type` describe the
named type itself, as the JAX functions do ("float64" is 8 bytes).
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPE_MAP = {
    "float32": torch.float32,
    "double64": torch.float64,  # NumPower's alias for double
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}

# numpy dtypes by name (numpy has no bfloat16)
_NUMPY = {name: np.dtype(name) for name in _DTYPE_MAP if name not in ("double64", "bfloat16")}
_TO_NUMPY = {torch_dtype: _NUMPY[name] for name, torch_dtype in _DTYPE_MAP.items()
             if name in _NUMPY}
_FROM_NUMPY = {np_dtype: torch_dtype for torch_dtype, np_dtype in _TO_NUMPY.items()}

# the JAX package's 64-bit types off: what an array of each type holds
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.complex128: torch.complex64}


def resolve_dtype(dtype):
    """Accept NumPower-style strings, numpy dtypes or torch dtypes; return a
    torch dtype (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _DTYPE_MAP:
            raise ValueError(f"unknown dtype {dtype!r}; known: {sorted(_DTYPE_MAP)}")
        return _DTYPE_MAP[dtype]
    np_dtype = np.dtype(dtype)
    if np_dtype not in _FROM_NUMPY:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _FROM_NUMPY[np_dtype]


def canonical(dtype: torch.dtype) -> torch.dtype:
    """The dtype an array of `dtype` holds in the JAX package (float64 ->
    float32, int64 -> int32)."""
    return _CANONICAL.get(dtype, dtype)


def numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype, or None where numpy has none."""
    return _TO_NUMPY.get(dtype)


def get_type_size(dtype) -> int:
    """Element size in bytes (NumPower's get_type_size)."""
    return resolve_dtype(dtype).itemsize


def is_type(dtype, name: str) -> bool:
    """NumPower's is_type: do the two name one type?"""
    return resolve_dtype(dtype) == resolve_dtype(name)
