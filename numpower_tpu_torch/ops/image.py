"""Image <-> tensor bridge (the port's counterpart of
numpower_tpu/ops/image.py): NumPower's GD bridge (NDArray_FromGD /
NDArray_ToGD) over uint8 numpy arrays (PIL images, tensors), HxW gray or HxWx3/4,
to float32 tensors in CHW (the default) or HWC, optionally scaled to [0, 1].

``to_image`` rounds half to even (jnp.round's rule; ``ops.round`` rounds half
away from zero) before the clip to [0, 255] and the cast to uint8.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from numpower_tpu_torch.ops.creation import asarray
from numpower_tpu_torch.utils.config import default_dtype


def from_image(img: Any, channel_first: bool = True, normalize: bool = False,
               device=None) -> torch.Tensor:
    """An image (a numpy array, a PIL image or a uint8 tensor) as a float32
    tensor on `device` (None: the card, or a tensor's own device): CHW where
    `channel_first`, else HWC (a gray image gets one channel); divided by
    255 where `normalize`."""
    if not isinstance(img, torch.Tensor):
        img = np.asarray(img)  # a PIL image too
    if img.ndim == 2:
        img = img[:, :, None]
    x = asarray(img, dtype=default_dtype(), device=device)
    if normalize:
        x = x / 255.0
    if channel_first:
        x = x.permute(2, 0, 1)
    return x


def to_image(a, channel_first: bool = True, denormalize: bool = False) -> np.ndarray:
    """A tensor (CHW, or HWC where not `channel_first`; 2-d for gray) as a
    uint8 HxWxC numpy image (HxW for one channel): times 255 where
    `denormalize`, rounded half to even, clipped to [0, 255]."""
    x = asarray(a)
    if x.ndim == 2:
        x = x[None] if channel_first else x[..., None]
    if channel_first:
        x = x.permute(1, 2, 0)
    if denormalize:
        x = x * 255.0
    out = torch.clamp(torch.round(x), 0, 255).to(torch.uint8).cpu().numpy()
    return out[..., 0] if out.shape[-1] == 1 else out
