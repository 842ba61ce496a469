"""Systematic resampling of a batched particle cloud (K14; port of
numpower_tpu/kernels/pf_resample.py ``resample_onehot_pallas``).

The kernel is CUDA C++ in ``csrc/pf_resample.cu`` (its note says what bounds
it on the H100 and how the design answers that): four output slots a
thread, their binary searches for the slots' owners advanced together over
the row's slot boundaries staged in shared memory, then every gather of the
owners' n floats before any store. It computes the
function of the TPU kernel, out[b, i] = parts[b, j] for the unique j with
m[b, j-1] <= i < m[b, j], without its O(N^2) one-hot contraction, which
existed for the TPU's matrix unit. This module holds its wrapper,
:func:`resample_systematic`, and its plain PyTorch version,
:func:`resample_systematic_reference` (the same search by
``torch.searchsorted``, then a gather). The wrapper takes the plain version
for a tensor on the CPU only; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand


def resample_systematic_reference(parts, m):
    """Plain PyTorch version of the kernel: the same arguments and results as
    :func:`resample_systematic`. The owner of slot i is the first j with
    m[b, j] > i (``torch.searchsorted``, right side); a slot no particle owns
    is a row of zeros, as the one-hot contraction leaves it."""
    B, N, n = parts.shape
    slots = torch.arange(N, dtype=m.dtype, device=m.device).expand(B, N).contiguous()
    j = torch.searchsorted(m.contiguous(), slots, right=True)
    owned = j < N
    out = torch.gather(parts, 1, j.clamp(max=N - 1)[..., None].expand(B, N, n))
    return torch.where(owned[..., None], out, torch.zeros((), dtype=parts.dtype,
                                                          device=parts.device))


def resample_systematic(parts, m):
    """Systematic resample of a batched cloud: parts (B, N, n) float32 and m
    (B, N) int32, nondecreasing slot boundaries from
    models/particle._resample_slots. Returns the resampled (B, N, n) cloud:
    out[b, i] = parts[b, j] for the unique j with m[b, j-1] <= i < m[b, j].

    On a CPU tensor this is :func:`resample_systematic_reference`. Each
    kernel launch adds one to ``resample_systematic.launches``."""
    if parts.device.type == "cpu":
        return resample_systematic_reference(parts, m)
    B, N, n = parts.shape
    device = parts.device
    _check_operand("parts", parts, device, (B, N, n))
    if m.device != device or m.dtype != torch.int32 or tuple(m.shape) != (B, N) \
            or not m.is_contiguous():
        raise ValueError(f"m must be a contiguous int32 ({B}, {N}) tensor on {device}, got "
                         f"{m.dtype} {tuple(m.shape)} on {m.device}")
    out = torch.empty_like(parts)
    code = _build.launch("npt_resample_systematic", device, parts.data_ptr(), m.data_ptr(),
                         out.data_ptr(), B, N, n)
    _build.check(code, "resample_systematic kernel launch")
    resample_systematic.launches += 1
    return out


resample_systematic.launches = 0


def resample_onehot_pallas(parts, m, blk: int = 512, interpret: bool = False):
    """K14 by the JAX package's name (numpower_tpu/kernels/pf_resample.py):
    :func:`resample_systematic`, with its operands and result. blk and
    interpret have no effect: parts's device chooses the route."""
    del blk, interpret
    return resample_systematic(parts, m)
