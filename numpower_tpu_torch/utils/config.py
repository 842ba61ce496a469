"""Runtime configuration of the port's op surface.

The port's counterpart of numpower_tpu/utils/config.py, holding only what the
ops read: the default element type. Like the JAX package, the port computes
in float32 unless a caller names another type.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    # Default element type: float32, the JAX package's (and NumPower's)
    # numerics default; creation functions and Python-native operands take it.
    default_dtype: torch.dtype = torch.float32


config = Config()


def default_dtype() -> torch.dtype:
    return config.default_dtype
