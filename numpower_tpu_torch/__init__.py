"""numpower_tpu_torch — the PyTorch + CUDA port of numpower_tpu.

The JAX package ``numpower_tpu`` is the reference; this package mirrors its
layout and names and is held against it by tests/test_torch_*.py. It imports
torch and numpy, never jax. Its entry points run on the card
(``utils.default_device``) unless handed CPU tensors or ``device="cpu"``.

- ``numpower_tpu_torch.models``  — plants, LQR/Riccati (sequential,
                                   associative, per-scenario), condensed MPC,
                                   box-QP solvers (FISTA, PG, ADMM), tube MPC,
                                   the serving controller, iLQR / AL-iLQR, the
                                   state estimators and the closed-loop
                                   simulation
- ``numpower_tpu_torch.ops``     — the NumPower op surface as functions on
                                   tensors: creation, dtypes, elementwise,
                                   logic, reductions, statistics,
                                   manipulation, linalg, signal, dnn, io,
                                   image and the ``random`` module
- ``numpower_tpu_torch.NDArray``  — the object API of NumPower's PHP class
                                   (``ndarray.py``: ~140 methods, operators,
                                   indexing, iteration, pickling, the device
                                   shims), with ``nd`` and
                                   ``ArithmeticOperand``
- ``numpower_tpu_torch.runtime`` — the native host runtime (a copy of the
                                   JAX package's ndruntime.cpp, built with
                                   g++ at first use): the NDArray registry
                                   and its counters, the fast .npy paths
- ``numpower_tpu_torch.kernels`` — hand-written CUDA kernels for Hopper
                                   (``csrc/*.cu``, built at first use)
- ``numpower_tpu_torch.parallel`` — the mesh, the data-parallel solvers and
                                   the runtime setup on torch.distributed
- ``numpower_tpu_torch.utils``   — unrolled small-matrix linear algebra, the
                                   associative scan, the default device, the
                                   ops' configuration and the debug helpers
                                   (``utils.debug``: dump, dump_devices,
                                   array_repr)
"""

__version__ = "0.1.0"

import torch as _torch

# The 1e-4 parity bound needs fp32 matmuls: keep TF32 off for matmuls and
# convolutions (the counterpart of numpower_tpu's "highest" default precision).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from numpower_tpu_torch import kernels, models, ops, parallel, runtime, utils  # noqa: E402, F401
from numpower_tpu_torch.ndarray import ArithmeticOperand, NDArray, nd  # noqa: E402, F401
