"""DNN convolutions, forward and backward (the port's counterpart of
numpower_tpu/ops/dnn.py): NCHW inputs and OIHW filters (NCH / OIH in 1-d),
``F.conv2d`` / ``F.conv1d`` accumulated in float32 with TF32 off (the
package's setting), cast back to the input's dtype.

The pads are explicit, as XLA computes them: "SAME" gives an output of
ceil(in / stride) with the odd pad at the end (torch's padding=1 pads both
sides, and its padding="same" refuses a stride above 1), "VALID" none, an
int the same on every side, a list of (low, high) pairs as it stands. The
backward pass is the exact vector-Jacobian product of the forward
(torch.autograd on it), as the JAX op's jax.vjp.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from numpower_tpu_torch.ops.creation import accumulation_dtype, as_operands, asarray

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _explicit_pads(padding, spatial: Sequence[int], kernel: Sequence[int],
                   stride: Sequence[int], dilation: Sequence[int]) -> list:
    """(low, high) pads per spatial dim, as lax.conv_general_dilated reads
    `padding`: "SAME" (XLA's: the odd pad at the end), "SAME_LOWER" (at the
    start), "VALID", an int, or a sequence of pairs."""
    if isinstance(padding, int):
        return [(padding, padding)] * len(spatial)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * len(spatial)
        if mode not in ("SAME", "SAME_LOWER"):
            raise ValueError(f"Unknown padding type: {padding}.")
        pads = []
        for n, k, s, d in zip(spatial, kernel, stride, dilation):
            eff_k = (k - 1) * d + 1
            total = max((-(-n // s) - 1) * s + eff_k - n, 0)
            lo = total // 2 if mode == "SAME" else total - total // 2
            pads.append((lo, total - lo))
        return pads
    return [(int(lo), int(hi)) for lo, hi in padding]


def _flat(pads: list) -> tuple:
    """F.pad's order: the last dim first."""
    return tuple(v for lo_hi in reversed(pads) for v in lo_hi)


def conv2d_forward(x, w, bias=None, stride: IntPair = 1, padding="SAME",
                   dilation: IntPair = 1) -> torch.Tensor:
    """NumPower's NDArray_Conv2D_Forward: x (N, C, H, W), w (O, C, KH, KW),
    with stride, padding and dilation, and a bias per output channel."""
    x, w = as_operands(x, w)
    stride, dilation = _pair(stride), _pair(dilation)
    pads = _explicit_pads(padding, x.shape[2:], w.shape[2:], stride, dilation)
    acc = accumulation_dtype(x.dtype)
    out = F.conv2d(F.pad(x.to(acc), _flat(pads)), w.to(acc), stride=stride,
                   dilation=dilation).to(x.dtype)
    if bias is not None:
        b = asarray(bias, device=out.device)
        out = out + b.reshape(1, -1, 1, 1).to(torch.promote_types(out.dtype, b.dtype))
    return out


def conv2d_backward(x, w, grad_out, stride: IntPair = 1, padding="SAME",
                    dilation: IntPair = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """NumPower's NDArray_Conv2D_Backward: (dInput, dW), the exact
    vector-Jacobian product of conv2d_forward (no bias) with grad_out."""
    x, w, grad_out = as_operands(x, w, grad_out)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        ww = w.detach().requires_grad_(True)
        out = conv2d_forward(xx, ww, None, stride, padding, dilation)
        dx, dw = torch.autograd.grad(out, (xx, ww), grad_out.to(out.dtype))
    return dx, dw


def conv1d_forward(x, w, stride: int = 1, padding: str = "same",
                   dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NumPower's NDArray_Conv1D: x (N, C_in, L), w (C_out, C_in / groups,
    K); groups, dilation and the pads same (the odd one at the end), valid,
    full and causal (all at the start)."""
    x, w = as_operands(x, w)
    eff_k = (w.shape[-1] - 1) * dilation + 1
    mode = padding.lower()
    if mode == "same":
        pad = ((eff_k - 1) // 2, eff_k - 1 - (eff_k - 1) // 2)
    elif mode == "valid":
        pad = (0, 0)
    elif mode == "full":
        pad = (eff_k - 1, eff_k - 1)
    elif mode == "causal":
        pad = (eff_k - 1, 0)
    else:
        raise ValueError(f"unknown padding mode {padding!r}")
    acc = accumulation_dtype(x.dtype)
    return F.conv1d(F.pad(x.to(acc), pad), w.to(acc), stride=stride, dilation=dilation,
                    groups=groups).to(x.dtype)
