"""Hand-written CUDA kernels for the hot paths, each with its wrapper and its
plain PyTorch version (sources in numpower_tpu_torch/csrc, built at first
use by kernels/_build.py). Each kernel module also holds the JAX package's
name of its kernels (``fista_mpc_pallas_res``, ``ekf_pallas``, ...), and
kalman_batched.py and rts_batched.py hold the names of K9 and K10 under the
JAX package's module names."""

from numpower_tpu_torch.kernels.boxqp_fista import (  # noqa: F401
    fista_boxqp, fista_boxqp_pallas, fista_boxqp_reference, fista_mpc, fista_mpc_reference,
    fista_mpc_res, fista_mpc_res_reference, solve_mpc_boxqp_pallas,
)
from numpower_tpu_torch.kernels.boxqp_admm import (  # noqa: F401
    admm_boxqp, admm_boxqp_reference, admm_mpc, admm_mpc_reference, admm_mpc_res,
    admm_mpc_res_reference, minv_factor,
)
from numpower_tpu_torch.kernels.cholesky import (  # noqa: F401
    cholesky_batched, cholesky_batched_reference, psd_solve_batched,
    psd_solve_batched_reference,
)
from numpower_tpu_torch.kernels.riccati import (  # noqa: F401
    riccati_batched_fused, riccati_batched_reference,
)
from numpower_tpu_torch.kernels.ilqr_backward import (  # noqa: F401
    ilqr_backward_fused, ilqr_backward_reference,
)
from numpower_tpu_torch.kernels.ilqr_forward import (  # noqa: F401
    ilqr_forward_fused, ilqr_forward_reference,
)
from numpower_tpu_torch.kernels.kalman_mean import (  # noqa: F401
    kalman_mean_pass, kalman_mean_pass_reference,
)
from numpower_tpu_torch.kernels.rts_mean import rts_mean_pass, rts_mean_pass_reference  # noqa: F401
from numpower_tpu_torch.kernels.ekf import ekf_batched, ekf_reference  # noqa: F401
from numpower_tpu_torch.kernels.ukf import ukf_batched, ukf_reference  # noqa: F401
from numpower_tpu_torch.kernels.mppi import (  # noqa: F401
    eps_direct_layout, eps_kernel_layout, mppi_fused, mppi_fused_reference,
)
from numpower_tpu_torch.kernels.pf_resample import (  # noqa: F401
    resample_systematic, resample_systematic_reference,
)
