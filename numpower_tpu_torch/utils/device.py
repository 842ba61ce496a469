"""The device the port's entry points use when the caller names none."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def default_device() -> torch.device:
    """The card: ``torch.device("cuda")``. An entry point that is handed no
    tensor and no ``device`` builds its tensors here, so on a machine without
    CUDA it raises; pass ``device="cpu"`` (or CPU tensors) to run on the CPU."""
    return torch.device("cuda")


def state_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An entry point's leading operand as a tensor: a tensor keeps its device
    and dtype; anything else (a numpy array, a list) becomes a tensor of
    ``like``'s dtype on its device (the QP's or the controller's, where the
    call has one), else a float32 tensor, the JAX package's default
    precision, on :func:`default_device`."""
    if isinstance(x, torch.Tensor):
        return x
    if like is None:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=default_device())
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def follow(like: torch.Tensor, *xs) -> tuple:
    """``xs`` as tensors of ``like``'s dtype on its device (a tensor already
    there is returned as it is); None stays None."""
    return tuple(None if x is None else torch.as_tensor(x, dtype=like.dtype, device=like.device)
                 for x in xs)


def seeded_generator(generator, device) -> torch.Generator:
    """The random stream of an entry point that takes a generator where the
    JAX package takes a key: ``generator`` itself, or, where it is None, a
    new one seeded 0 on ``device``."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    return generator
