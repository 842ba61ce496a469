"""The wide K7 of numpower_tpu_torch (csrc/ilqr_backward_wide.cu: n > 16 or
m > 8, its products on the tensor cores in 3xTF32, As and Bs read at their
strides) on the card: the linearization's column-major Jacobians against
contiguous copies of them, bit for bit; the kernel against its plain PyTorch
version and float64 at chip_smoke.py phase 29's shapes; the narrow K7's bits,
which the redesign leaves as they were, and the wide K7's, which the move of
its TF32 helpers into csrc/tf32_mma.cuh leaves as they were.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor numpower_tpu, so it runs on
the GPU machine, where jax is absent; tests/conftest.py imports jax, so run
it there without the conftest, from the repository root (it imports
chip_smoke's shapes and digests):

    python -m pytest --noconftest tests/test_torch_ilqr_wide_cuda.py -q

Tolerances: rtol 1e-3 / atol 1e-4 against the plain fp32 version, K7's
bound (tests/test_torch_ilqr_cuda.py, chip_smoke phase 9); against float64
the same bound scaled, or four times the plain fp32 version's own scaled
distance where fp32 itself cannot hold it (chip_smoke.scaled_err, phase 29).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    ILQR_DEPTH1_SHAPES, ILQR_WIDE_EDGES, ILQR_WORKSPACE_SHAPE, K7_NARROW_DIGESTS, K7_WIDE_DIGESTS,
    k7_checksums, k7_wide_checksums, random_ltv, scaled_err,
)
from numpower_tpu_torch.kernels import ilqr_backward
from numpower_tpu_torch.models import linearize_trajectory, planar_quadrotor_step, rollout_nonlinear

pytestmark = pytest.mark.cuda
T_EDGE = 8
# (n, m, N, T): phase 29's edges at T_EDGE, its one-stage-buffer shapes, its
# workspace shape
SHAPES = ([(n, m, 1003, T_EDGE) for n, m in ILQR_WIDE_EDGES] + list(ILQR_DEPTH1_SHAPES)
          + [ILQR_WORKSPACE_SHAPE])


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _column_major(x: torch.Tensor) -> torch.Tensor:
    """x with the same values, each matrix stored column-major."""
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


def _formation(k: int, N: int, T: int, device):
    """The first backward pass of k planar quadrotors flown as one system (n =
    6 k, m = 2 k), hovering from x0 = goal + 0.2 N(0, 1): As and Bs as the
    linearization hands them over (column-major views of one block), and the
    affine terms."""
    def f(x, u):
        y = planar_quadrotor_step(x.reshape(*x.shape[:-1], k, 6), u.reshape(*u.shape[:-1], k, 2))
        return y.reshape(*y.shape[:-2], 6 * k)

    n, m = 6 * k, 2 * k
    rng = np.random.default_rng(k)
    x0s = torch.as_tensor(0.2 * rng.standard_normal((N, n)), dtype=torch.float32, device=device)
    us = torch.full((N, T, m), 0.5 * 9.81, device=device)
    xs = rollout_nonlinear(f, x0s, us)
    As, Bs = linearize_trajectory(f, xs, us)
    eye = torch.eye(n, device=device)
    return [As, Bs, 2.0 * xs[:, :T], 0.2 * us, 2.0 * eye, 0.2 * torch.eye(m, device=device),
            20.0 * xs[:, T], 20.0 * eye]


def test_linearization_hands_over_column_major_jacobians(device):
    """The layout the wide form reads in place: row stride 1."""
    As, Bs = _formation(8, 4, 3, device)[:2]
    assert As.stride()[-2:] == (1, 48) and Bs.stride()[-2:] == (1, 48)
    assert Bs.data_ptr() == As.data_ptr() + 4 * 48 * 48


@pytest.mark.parametrize("k", [3, 8])
def test_column_major_and_contiguous_jacobians_give_the_same_bits(device, k):
    """The column-major views of the linearization, contiguous copies of
    them and column-major copies of those give the same ks and Ks, bit for
    bit: the layouts change the copies, not the arithmetic."""
    ops = _formation(k, 1003, 12, device)
    got = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3)
    for As, Bs in ((ops[0].contiguous(), ops[1].contiguous()),
                   (_column_major(ops[0].contiguous()), _column_major(ops[1].contiguous()))):
        again = ilqr_backward.ilqr_backward_fused(As, Bs, *ops[2:], reg=1e-3)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("layout", ["contiguous", "column-major", "transposed-batch"])
@pytest.mark.parametrize("n,m", [(17, 1), (16, 9), (4, 12), (48, 16)])
def test_any_jacobian_layout_gives_the_contiguous_bits(device, n, m, layout):
    """A transposed view (each matrix column-major), a view with the batch's
    axes swapped in memory and a contiguous copy give the same bits."""
    ops, diags = random_ltv(257, 6, n, m, device, seed=n + m)
    want = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3, luu_diags=diags)
    if layout == "column-major":
        As, Bs = _column_major(ops[0]), _column_major(ops[1])
    elif layout == "transposed-batch":
        As, Bs = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in ops[:2])
    else:
        As, Bs = ops[0].contiguous(), ops[1].contiguous()
    got = ilqr_backward.ilqr_backward_fused(As, Bs, *ops[2:], reg=1e-3, luu_diags=diags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("diag", [False, True], ids=["plain", "luu_diags"])
@pytest.mark.parametrize("n,m,N,T", SHAPES,
                         ids=[f"n{s[0]}-m{s[1]}-N{s[2]}-T{s[3]}" for s in SHAPES])
def test_wide_kernel_against_plain_and_float64(device, n, m, N, T, diag):
    """The wide form at phase 29's shapes (its two stage buffers, one, the
    workspace), column-major Jacobians, against its plain version (rtol 1e-3,
    atol 1e-4) and float64."""
    ops, diags = random_ltv(N, T, n, m, device, seed=n * 10 + m)
    ops = [_column_major(x) for x in ops[:2]] + list(ops[2:])
    d = diags if diag else None
    ks, Ks = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3, luu_diags=d)
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*ops, reg=1e-3, luu_diags=d)
    assert torch.allclose(ks, ks_p, rtol=1e-3, atol=1e-4)
    assert torch.allclose(Ks, Ks_p, rtol=1e-3, atol=1e-4)
    ks_64, Ks_64 = ilqr_backward.ilqr_backward_reference(
        *[x.double() for x in ops], reg=1e-3, luu_diags=None if d is None else d.double())
    e_k = max(scaled_err(ks, ks_64, 1e-3, 1e-4), scaled_err(Ks, Ks_64, 1e-3, 1e-4))
    e_p = max(scaled_err(ks_p, ks_64, 1e-3, 1e-4), scaled_err(Ks_p, Ks_64, 1e-3, 1e-4))
    assert e_k <= max(1.0, 4 * e_p)


@pytest.mark.parametrize("N", [4096, 1003])
def test_wide_kernel_at_the_formation(device, N):
    """Eight planar quadrotors (n = 48, m = 16, T = 50), the linearization's
    operands in place: against the plain version and float64."""
    ops = _formation(8, N, 50, device)
    ks, Ks = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3)
    ks_p, Ks_p = ilqr_backward.ilqr_backward_reference(*ops, reg=1e-3)
    assert torch.allclose(ks, ks_p, rtol=1e-3, atol=1e-4)
    assert torch.allclose(Ks, Ks_p, rtol=1e-3, atol=1e-4)
    ks_64, Ks_64 = ilqr_backward.ilqr_backward_reference(*[x.double() for x in ops], reg=1e-3)
    e_k = max(scaled_err(ks, ks_64, 1e-3, 1e-4), scaled_err(Ks, Ks_64, 1e-3, 1e-4))
    e_p = max(scaled_err(ks_p, ks_64, 1e-3, 1e-4), scaled_err(Ks_p, Ks_64, 1e-3, 1e-4))
    assert e_k <= max(1.0, 4 * e_p)


def test_wide_launch_is_counted_once_and_copies_no_jacobian(device):
    """One launch a call, and no device copy of As or Bs: the allocator's
    peak grows by the outputs alone."""
    ops = _formation(8, 1003, 50, device)
    ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3)
    torch.cuda.synchronize()
    before = ilqr_backward.ilqr_backward_fused.launches
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    ks, Ks = ilqr_backward.ilqr_backward_fused(*ops, reg=1e-3)
    grown = torch.cuda.max_memory_allocated(device) - base
    assert ilqr_backward.ilqr_backward_fused.launches == before + 1
    assert grown < ops[0].numel() * 4 // 2, (grown, ks.numel() * 4 + Ks.numel() * 4)


def test_narrow_kernel_is_bit_for_bit_unchanged(device):
    """The narrow forms (n <= 16, m <= 8) return the bits they returned
    before the wide form's redesign (chip_smoke.K7_NARROW_DIGESTS)."""
    got = {case: digest for case, (digest, _) in k7_checksums(device).items()}
    assert got == K7_NARROW_DIGESTS


def test_wide_kernel_keeps_its_bits(device):
    """The wide form returns the bits it returned before its TF32 helpers
    moved into csrc/tf32_mma.cuh (chip_smoke.K7_WIDE_DIGESTS): the
    eight-quadrotor formation at T = 10 and (48, 40), past m = 32, each with
    and without luu_diags."""
    got = {case: digest for case, (digest, _) in k7_wide_checksums(device).items()}
    assert got == K7_WIDE_DIGESTS
