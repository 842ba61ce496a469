"""The JAX package's module name of K10 (port of
numpower_tpu/kernels/rts_batched.py): ``rts_mean_pass_pallas`` over the
port's kernel module, kernels/rts_mean.py, which holds the wrapper, its
plain version and the source note of ``csrc/rts_mean.cu``."""

from __future__ import annotations

from numpower_tpu_torch.kernels.rts_mean import rts_mean_pass


def rts_mean_pass_pallas(G_Ts, es_t, x_last, tile_b: int = 2048, interpret: bool = False):
    """K10 by the JAX package's name: :func:`rts_mean.rts_mean_pass`, with
    its operands and result (xs_s (T, N, n)). tile_b and interpret have no
    effect: x_last's device chooses the route."""
    del tile_b, interpret
    return rts_mean_pass(G_Ts, es_t, x_last)
