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


def given_generator(generator, key):
    """The generator an entry point was handed, by ``generator=`` or by the
    JAX package's name ``key=`` (a ``torch.Generator`` either way, as
    ops.random takes it); None where neither is given. TypeError for both."""
    if key is not None and generator is not None:
        raise TypeError("pass the generator as generator= or as key=, not both")
    return generator if key is None else key


def seeded_generator(generator, device, key=None) -> torch.Generator:
    """The random stream of an entry point that takes a generator where the
    JAX package takes a key: ``generator`` (or ``key``, its JAX name,
    :func:`given_generator`) itself, or, where neither is given, a new one
    seeded 0 on ``device``."""
    generator = given_generator(generator, key)
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    return generator
