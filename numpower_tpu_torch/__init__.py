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
                                   logic, reductions, statistics and
                                   manipulation
- ``numpower_tpu_torch.kernels`` — hand-written CUDA kernels for Hopper
                                   (``csrc/*.cu``, built at first use)
- ``numpower_tpu_torch.parallel`` — the mesh, the data-parallel solvers and
                                   the runtime setup on torch.distributed
- ``numpower_tpu_torch.utils``   — unrolled small-matrix linear algebra, the
                                   associative scan, the default device and
                                   the ops' configuration
"""

__version__ = "0.1.0"

import torch as _torch

# The 1e-4 parity bound needs fp32 matmuls: keep TF32 off for matmuls and
# convolutions (the counterpart of numpower_tpu's "highest" default precision).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from numpower_tpu_torch import kernels, models, ops, parallel, utils  # noqa: E402, F401
