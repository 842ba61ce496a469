"""The JAX package's module name of K9 (port of
numpower_tpu/kernels/kalman_batched.py): ``kalman_mean_pass_pallas`` over
the port's kernel module, kernels/kalman_mean.py, which holds the wrapper,
its plain version and the source note of ``csrc/kalman_mean.cu``."""

from __future__ import annotations

from numpower_tpu_torch.kernels.kalman_mean import kalman_mean_pass


def kalman_mean_pass_pallas(A, C, Ws, invLs, logdets, x0s, ys_t, us_t=None,
                            tile_b: int = 2048, interpret: bool = False):
    """K9 by the JAX package's name: :func:`kalman_mean.kalman_mean_pass`,
    with its operands and results (xs_f (T, N, n), xs_p (T, N, n), ll (N,)).
    tile_b and interpret have no effect: x0s's device chooses the route."""
    del tile_b, interpret
    return kalman_mean_pass(A, C, Ws, invLs, logdets, x0s, ys_t, us_t)
