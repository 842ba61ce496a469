"""Small-matrix linear algebra unrolled over the matrix indices, the
associative scan the parallel-in-time engines use and the default device;
the modules config, checkpoint, profiler, flops and debug hold the runtime
configuration, checkpoints, profiling hooks, the H100's cost model and the
debug helpers."""

from numpower_tpu_torch.utils.associative_scan import associative_scan  # noqa: F401
from numpower_tpu_torch.utils.device import default_device  # noqa: F401
from numpower_tpu_torch.utils.smallmat import (  # noqa: F401
    cholesky_unrolled, lu_solve_nopivot, lu_solve_unrolled, psd_solve_unrolled,
    solve_small, tri_solve_unrolled,
)
