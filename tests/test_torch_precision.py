"""numpower_tpu_torch.kernels.precision against the JAX package's
kernels/precision.py on the same numpy inputs (CPU)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from numpower_tpu.kernels import precision as jprec  # noqa: E402
from numpower_tpu_torch.kernels import precision as tprec  # noqa: E402


def _inputs():
    rng = np.random.default_rng(7)
    # the scale of the kernels' operands: box-bounded iterates, a condensed H
    Y = (0.5 * rng.standard_normal((24, 40))).astype(np.float32)
    Ht = (0.1 * rng.standard_normal((40, 40))).astype(np.float32)
    return Y, Ht


def test_bf16_split_matches_jax():
    Y, _ = _inputs()
    j_hi, j_lo = jprec.bf16_split(jnp.asarray(Y))
    t_hi, t_lo = tprec.bf16_split(torch.from_numpy(Y))
    np.testing.assert_allclose(t_hi.numpy(), np.asarray(j_hi), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lo.numpy(), np.asarray(j_lo), rtol=0, atol=1e-6)
    np.testing.assert_array_equal((t_hi + t_lo).numpy(), Y)


def test_bf16_round_is_the_split_high_part():
    Y, _ = _inputs()
    j_hi, _ = jprec.bf16_split(jnp.asarray(Y))
    np.testing.assert_array_equal(tprec.bf16_round(torch.from_numpy(Y)).numpy(),
                                  np.asarray(j_hi))
    # keeps its input's dtype
    assert tprec.bf16_round(torch.from_numpy(Y).double()).dtype == torch.float64


@pytest.mark.parametrize("scheme", ["bf16x3", "bf16x4", "highest"])
def test_make_tail_dot_matches_jax(scheme):
    Y, Ht = _inputs()
    want = jprec.make_tail_dot(jnp.asarray(Ht), scheme)(jnp.asarray(Y))
    got = tprec.make_tail_dot(torch.from_numpy(Ht), scheme)(torch.from_numpy(Y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # every scheme is fp32-level accurate against the float64 product
    exact = Y.astype(np.float64) @ Ht.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)


def test_make_tail_dot_rejects_unknown_scheme():
    with pytest.raises(ValueError):
        tprec.make_tail_dot(torch.zeros(2, 2), "bf16x2")
