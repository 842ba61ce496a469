"""Plants, rollouts and linearization, LQR/Riccati, condensed-MPC box-QP
and OSQP solvers, tube MPC, the serving controller, iLQR / AL-iLQR, MPPI,
the state estimators (Kalman family, particle filter, MHE) and the
closed-loop simulation."""

from numpower_tpu_torch.models.plants import (  # noqa: F401
    LTIPlant, double_integrator, quadrotor12, cartpole_step, cartpole_params,
    pendulum_step, unicycle_step, planar_quadrotor_step, kernel_plant, plant_from_jax,
    first_components, kernel_measurement,
)
from numpower_tpu_torch.models.rollout import (  # noqa: F401
    rollout_lti, rollout_ltv, rollout_nonlinear, batched_rollout_lti,
    linearize, linearize_finite_diff, linearize_trajectory, quadratic_cost,
)
from numpower_tpu_torch.models.lqr import (  # noqa: F401
    riccati_scan, riccati_associative, riccati_scan_per_scenario,
    lqr_infinite_gain, lqr_solve, lqr_solve_batched, lqt_solve,
)
from numpower_tpu_torch.models.condensed import (  # noqa: F401
    CondensedQP, prediction_matrices, condense, gradient_offset,
)
from numpower_tpu_torch.models.boxqp import (  # noqa: F401
    BoxQPResult, solve_boxqp_pg, solve_boxqp_fista, solve_mpc_boxqp,
)
from numpower_tpu_torch.models.admm import (  # noqa: F401
    ADMMResult, OSQPResult, solve_boxqp_admm, solve_mpc_boxqp_admm,
    solve_qp_osqp, solve_mpc_state_constrained,
)
from numpower_tpu_torch.models.tube import TubeMPCResult, tube_mpc_solve  # noqa: F401
from numpower_tpu_torch.models.mpc import MPCController, MPCState  # noqa: F401
from numpower_tpu_torch.models.ilqr import ILQRResult, ilqr_solve, ilqr_solve_batched  # noqa: F401
from numpower_tpu_torch.models.al_ilqr import (  # noqa: F401
    ALILQRResult, al_ilqr_solve, al_ilqr_solve_batched,
)
from numpower_tpu_torch.models.mppi import (  # noqa: F401
    MPPIResult, mppi_solve, mppi_solve_batched, mppi_step, quadratic_mppi_cost,
)
from numpower_tpu_torch.models.estimation import (  # noqa: F401
    KalmanResult, SmootherResult, SqrtKalmanResult, kalman_filter,
    kalman_filter_batched, kalman_filter_associative, kalman_filter_sqrt,
    kalman_smoother, kalman_smoother_associative, kalman_smoother_batched,
    ekf_filter, ukf_filter,
    ukf_filter_batched, ekf_filter_batched, kalman_filter_sqrt_batched,
)
from numpower_tpu_torch.models.particle import (  # noqa: F401
    ParticleFilterResult, particle_filter, particle_filter_batched,
)
from numpower_tpu_torch.models.mhe import MHEResult, mhe_solve  # noqa: F401
from numpower_tpu_torch.models.simulate import (  # noqa: F401
    SimResult, simulate_closed_loop, lqr_feedback, kalman_estimator,
)
