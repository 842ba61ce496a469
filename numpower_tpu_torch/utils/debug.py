"""Debug and observability (the port's counterpart of
numpower_tpu/utils/debug.py): NumPower's NDArray_Dump, its pretty printer
with `...` elision, and its CUDA device-property dump (dumpDevices), for
tensors and ``torch.cuda`` devices.
"""

from __future__ import annotations

import numpy as np
import torch


def dump(a) -> str:
    """NumPower's NDArray_Dump: a tensor's dtype, shape, size, bytes,
    device, strides and contiguity; printed and returned."""
    lines = [
        "numpower_tpu_torch.Tensor {",
        f"  dtype: {a.dtype}",
        f"  ndim: {a.ndim}",
        f"  shape: {tuple(a.shape)}",
        f"  size: {a.numel()}",
        f"  nbytes: {a.numel() * a.element_size()}",
        f"  device: {a.device}",
        f"  strides: {tuple(a.stride())}",
        f"  contiguous: {a.is_contiguous()}",
        "}",
    ]
    out = "\n".join(lines)
    print(out)
    return out


def dump_devices() -> str:
    """NumPower's dumpDevices for torch.cuda: each card's index, name,
    compute capability, multiprocessors and memory (free / total), then the
    count; printed and returned."""
    lines = []
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(count):
        p = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        lines.append(f"[{i}] cuda:{p.name} sm_{p.major}{p.minor} "
                     f"multiprocessors={p.multi_processor_count} mem_free={free}/{total}")
    lines.append(f"cuda_device_count={count}")
    out = "\n".join(lines)
    print(out)
    return out


def array_repr(a, precision: int = 8, edgeitems: int = 3, threshold: int = 1000) -> str:
    """NumPower's pretty printer: numpy's, which elides large arrays with
    `...` the same way, on a host copy."""
    host = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    with np.printoptions(precision=precision, edgeitems=edgeitems, threshold=threshold,
                         suppress=True):
        return np.array2string(host, separator=", ")
