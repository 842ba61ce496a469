"""Mesh, sharded solvers and the multi-process runtime on torch.distributed
(the ported part of numpower_tpu/parallel: mesh.py, distributed.py and
sharding.py)."""

from numpower_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, data_sharding, model_sharding, replicated, place, shard_batch,
)
from numpower_tpu_torch.parallel.sharding import (  # noqa: F401
    kalman_filter_batched_dp, kalman_smoother_batched_dp,
    solve_mpc_boxqp_dp, solve_mpc_boxqp_admm_dp,
    solve_mpc_boxqp_dp_tp, sweep_statistics_dp,
)
from numpower_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize, is_multi_host, local_scenario_slice, scaling_report,
)
