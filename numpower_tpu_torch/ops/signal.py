"""2-D convolution and correlation, signal flavour (the port's counterpart of
numpower_tpu/ops/signal.py): SciPy's convolve2d / correlate2d with the modes
full, same and valid and the boundaries fill (a constant), wrap (circular)
and symm (numpy's "symmetric": the edge repeated, unlike torch's "reflect"),
and numpy's 1-d convolve.

The boundary is a pad, gathered by index for wrap and symm (so a pad longer
than the array repeats it as numpy's does); the convolution is one
``F.conv2d`` (a correlation) with the kernel flipped, accumulated in float32
and cast back to the operand's dtype, as the JAX op's preferred element type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from numpower_tpu_torch.ops.creation import accumulation_dtype, as_operands

_MODES = ("full", "same", "valid")
_BOUNDARIES = ("fill", "wrap", "symm")


def _pad_amounts(mode: str, k: int):
    """Top/bottom pad for one spatial dim, in *convolution* orientation."""
    if mode == "full":
        return k - 1, k - 1
    if mode == "same":
        return k // 2, (k - 1) // 2
    return 0, 0  # valid


def _pad_index(n: int, before: int, after: int, boundary: str, device) -> torch.Tensor:
    """The source index of each element of an axis of length n padded by
    (before, after): numpy's "wrap" or "symmetric" rule."""
    j = torch.arange(-before, n + after, device=device)
    if boundary == "wrap":
        return j % n
    m = j % (2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _conv2d_core(a: torch.Tensor, kernel: torch.Tensor, mode: str, boundary: str,
                 fill_value: float) -> torch.Tensor:
    kh, kw = kernel.shape
    pt, pb = _pad_amounts(mode, kh)
    pl, pr = _pad_amounts(mode, kw)
    if boundary not in _BOUNDARIES:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}, got {boundary!r}")
    acc = accumulation_dtype(a.dtype)
    x = a.to(acc)
    if boundary == "fill":
        x = F.pad(x, (pl, pr, pt, pb), value=float(fill_value))
    else:
        rows = _pad_index(x.shape[0], pt, pb, boundary, x.device)
        cols = _pad_index(x.shape[1], pl, pr, boundary, x.device)
        x = x[rows][:, cols]
    out_shape = (x.shape[0] - kh + 1, x.shape[1] - kw + 1)
    if min(out_shape) <= 0:  # a kernel past the (padded) input: empty, as XLA's
        return torch.zeros(tuple(max(d, 0) for d in out_shape), dtype=a.dtype, device=a.device)
    # convolution = correlation with the kernel flipped
    k = torch.flip(kernel, (0, 1)).to(a.dtype).to(acc)
    return F.conv2d(x[None, None], k[None, None])[0, 0].to(a.dtype)


def _check(a, kernel, mode, name):
    if a.ndim != 2 or kernel.ndim != 2:
        raise ValueError(f"{name} requires 2-d input and kernel")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


def convolve2d(a, kernel, mode: str = "full", boundary: str = "fill",
               fill_value: float = 0.0) -> torch.Tensor:
    """NumPower's NDArray_Convolve2D. In valid mode a kernel larger than the
    input (in either dimension) swaps the two, as SciPy and NumPower do."""
    a, kernel = as_operands(a, kernel)
    _check(a, kernel, mode, "convolve2d")
    if mode == "valid" and (kernel.shape[0] > a.shape[0] or kernel.shape[1] > a.shape[1]):
        a, kernel = kernel, a
    return _conv2d_core(a, kernel, mode, boundary, fill_value)


def correlate2d(a, kernel, mode: str = "full", boundary: str = "fill",
                fill_value: float = 0.0) -> torch.Tensor:
    """NumPower's NDArray_Correlate2D: convolution with the kernel unflipped."""
    a, kernel = as_operands(a, kernel)
    _check(a, kernel, mode, "correlate2d")
    return _conv2d_core(a, torch.flip(kernel, (0, 1)), mode, boundary, fill_value)


def convolve1d(a, kernel, mode: str = "full") -> torch.Tensor:
    """numpy's convolve: 1-d operands promoted to a floating dtype, swapped
    where the kernel is the longer, in the modes full, same and valid."""
    a, v = as_operands(a, kernel)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("convolve() only support 1-dimensional inputs.")
    dt = torch.promote_types(a.dtype, v.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    if len(a) == 0 or len(v) == 0:
        raise ValueError(f"convolve: inputs cannot be empty, got shapes {tuple(a.shape)} and "
                         f"{tuple(v.shape)}.")
    if len(a) < len(v):
        a, v = v, a
    m = v.shape[0]
    pads = {"valid": (0, 0), "same": (m // 2, m - m // 2 - 1), "full": (m - 1, m - 1)}
    if mode not in pads:
        raise ValueError("mode must be one of ['full', 'same', 'valid']")
    acc = accumulation_dtype(dt)
    x = F.pad(a.to(dt).to(acc), pads[mode])
    return F.conv1d(x[None, None], torch.flip(v.to(dt), (0,)).to(acc)[None, None])[0, 0].to(dt)
