"""The layout in which the wide K7 reads the linearization's Jacobians, on
the CPU: kernels/ilqr_backward.ilqr_backward_fused passes As and Bs to the
wide form at their element strides, and the linearization hands them over
column-major, as views of one block. The kernel itself runs only on the
card (tests/test_torch_ilqr_wide_cuda.py)."""

import numpy as np
import torch

from numpower_tpu_torch.models import linearize_trajectory, planar_quadrotor_step, rollout_nonlinear


def _formation_jacobians(k: int, N: int, T: int):
    """As and Bs of k planar quadrotors flown as one system, as the
    linearization hands them over."""
    def f(x, u):
        y = planar_quadrotor_step(x.reshape(*x.shape[:-1], k, 6), u.reshape(*u.shape[:-1], k, 2))
        return y.reshape(*y.shape[:-2], 6 * k)

    x0s = torch.as_tensor(0.2 * np.random.default_rng(k).standard_normal((N, 6 * k)),
                          dtype=torch.float32)
    us = torch.full((N, T, 2 * k), 0.5 * 9.81)
    return linearize_trajectory(f, rollout_nonlinear(f, x0s, us), us)


def test_linearization_hands_over_one_column_major_block():
    """Row stride 1, A's n columns and then B's m, n floats each, one (n + m,
    n) block per scenario-stage: the layout the wide form reads in place."""
    T, n, m = 5, 12, 4
    As, Bs = _formation_jacobians(2, 3, T)
    assert As.stride()[2:] == Bs.stride()[2:] == (1, n)
    assert As.stride()[:2] == Bs.stride()[:2] == (T * n * (n + m), n * (n + m))
    assert Bs.data_ptr() - As.data_ptr() == 4 * n * n
