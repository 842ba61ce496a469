"""Mesh, sharded solvers and the multi-process runtime on torch.distributed
(port of numpower_tpu/parallel): the mesh (mesh.py), the runtime setup
(distributed.py), the data-parallel box-QP and Kalman solvers (sharding.py),
AL-iLQR and MHE (solvers_dp.py), MPPI and the particle filter
(sampling.py), the horizon-sharded Riccati and Kalman filter (riccati_sp.py,
kalman_sp.py) and the horizon pipeline (pipeline.py)."""

from numpower_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, data_sharding, model_sharding, replicated, place, shard_batch,
)
from numpower_tpu_torch.parallel.sharding import (  # noqa: F401
    kalman_filter_batched_dp, kalman_smoother_batched_dp,
    solve_mpc_boxqp_dp, solve_mpc_boxqp_admm_dp,
    solve_mpc_boxqp_dp_tp, sweep_statistics_dp,
)
from numpower_tpu_torch.parallel.pipeline import rollout_lti_pipelined  # noqa: F401
from numpower_tpu_torch.parallel.riccati_sp import riccati_associative_sharded  # noqa: F401
from numpower_tpu_torch.parallel.kalman_sp import (  # noqa: F401
    kalman_filter_associative_sharded,
)
from numpower_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize, is_multi_host, local_scenario_slice, scaling_report,
)
from numpower_tpu_torch.parallel.sampling import mppi_solve_dp, particle_filter_dp  # noqa: F401
from numpower_tpu_torch.parallel.solvers_dp import al_ilqr_solve_dp, mhe_solve_dp  # noqa: F401
