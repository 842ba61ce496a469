"""Persistence: save, load, serialize (the port's counterpart of
numpower_tpu/ops/io.py).

Arrays are written as .npy files, which numpy and both packages read; a
tensor is copied to the host first. ``save`` takes the port's native writer
where its runtime library is available, and ``load`` reads a file of 1 MiB
or more through the native mmap reader (``runtime.npy_read_fast``), as the
JAX package does; each falls back to numpy's. ``load`` and ``deserialize``
put the array on ``device`` (None: the card) with the JAX package's dtypes
(float64 held as float32, int64 as int32).
"""

from __future__ import annotations

import io as _io
import os
from typing import Any

import numpy as np
import torch

from numpower_tpu_torch import runtime
from numpower_tpu_torch.ops.creation import asarray

# Below this size np.load's overhead is noise; above it the native reader
# (one header parse and one copy out of a read-only mapping) is faster
_FAST_READ_MIN_BYTES = 1 << 20


def _host(a) -> np.ndarray:
    t = a if isinstance(a, torch.Tensor) else asarray(a, device="cpu")
    return t.detach().cpu().numpy()


def save(path: str, a) -> None:
    """nd::save: `a` as a .npy file at `path`."""
    arr = _host(a)
    if not runtime.npy_save_fast(path, arr):
        np.save(path, arr, allow_pickle=False)


def load(path: str, device=None) -> torch.Tensor:
    """nd::load: a .npy file (`path`, else `path` + ".npy") on `device`."""
    if not os.path.exists(path) and os.path.exists(path + ".npy"):
        path = path + ".npy"
    arr = None
    if os.path.getsize(path) >= _FAST_READ_MIN_BYTES:
        arr = runtime.npy_read_fast(path)
    if arr is None:
        arr = np.load(path, allow_pickle=False)
    return asarray(arr, device=device)


def serialize(a) -> bytes:
    """NumPower's __serialize: self-describing bytes (an in-memory .npy)."""
    buf = _io.BytesIO()
    np.save(buf, _host(a), allow_pickle=False)
    return buf.getvalue()


def deserialize(data: bytes, device=None) -> torch.Tensor:
    """NumPower's __unserialize, on `device`."""
    return asarray(np.load(_io.BytesIO(data), allow_pickle=False), device=device)


def to_list(a) -> Any:
    """nd::toArray: nested Python lists."""
    return _host(a).tolist()
