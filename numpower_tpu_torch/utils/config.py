"""Runtime configuration (port of numpower_tpu/utils/config.py).

NumPower configures itself with compile-time autoconf macros and a handful of
environment variables (NDARRAY_BUFFERLEAK, NDARRAY_VCHECK); the JAX package
replaces that with one runtime dataclass and environment overrides, and the
port keeps its fields: the precision policy, the mesh's axis names and shape,
the solver tolerances and the two debug switches. ``default_dtype`` is a
``torch.dtype`` here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Config:
    # Default element type: float32, the JAX package's (and NumPower's)
    # numerics default; creation functions and Python-native operands take it.
    default_dtype: torch.dtype = torch.float32

    # Matmul accumulation: "highest" is fp32 throughout (the port keeps TF32
    # off, numpower_tpu_torch/__init__.py).
    matmul_precision: str = "highest"

    # Mesh axis names used throughout parallel/: data = MPC scenarios,
    # model = QP/condensed-matrix blocks.
    data_axis: str = "data"
    model_axis: str = "model"

    # Default mesh shape (data, model). None => every rank on data.
    mesh_shape: Optional[Tuple[int, int]] = None

    # Solver tolerances.
    solver_atol: float = 1e-6
    qp_step_tol: float = 1e-7

    # Debug switches (environment overrides, mirroring NDARRAY_BUFFER_DEBUG etc.).
    buffer_debug: bool = bool(os.environ.get("NPTPU_BUFFER_DEBUG"))
    check_leaks: bool = bool(os.environ.get("NPTPU_VCHECK"))


config = Config()


def default_dtype() -> torch.dtype:
    return config.default_dtype
