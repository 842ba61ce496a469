"""The port's signal and DNN convolutions (numpower_tpu_torch.ops) against the
JAX package's (numpower_tpu.ops) on the same seeded inputs, on the CPU: the
twin of tests/test_signal_dnn.py, each of the 6 names. Tolerance:
CONVOLUTION (rtol 1e-5, atol 1e-5; each output a sum of 9 to a few hundred
products of order-one data, in another order; conv2d_backward's dw, a sum
over the batch and the image, with its atol times max(1, max |dw|)), with
shapes and dtypes equal; EXACT for integer data and hand-computed cases; the
JAX tests' own direct convolution also holds the port (rtol 1e-4, atol
1e-5, theirs).

Each trap has its own test: every mode x boundary of the 2-d ops with odd
and even kernels (numpy's "symmetric" repeats the edge, which torch's
"reflect" does not; "wrap" is circular), the operand swap of valid mode,
XLA's SAME pads (the odd pad at the end) with stride 1 and 2 on odd and even
sizes, dilation and explicit pads, conv2d_backward against JAX's vjp, and
conv1d's groups, dilation and four pad modes.
"""

import numpy as np
import pytest
import torch
from test_signal_dnn import _direct_conv2d
from torch_ops_twins import CONVOLUTION, check, to_port

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

RNG = np.random.default_rng(0)
A = RNG.standard_normal((6, 7)).astype(np.float32)
K = RNG.standard_normal((3, 3)).astype(np.float32)
K_EVEN = RNG.standard_normal((2, 4)).astype(np.float32)
K_WIDE = RNG.standard_normal((5, 2)).astype(np.float32)

MODES = ["full", "same", "valid"]
BOUNDARIES = ["fill", "wrap", "symm"]


@pytest.mark.parametrize("kernel", ["K", "K_EVEN", "K_WIDE"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", ["convolve2d", "correlate2d"])
def test_2d_modes_boundaries(name, mode, boundary, kernel):
    k = {"K": K, "K_EVEN": K_EVEN, "K_WIDE": K_WIDE}[kernel]
    got = check(name, A, k, mode=mode, boundary=boundary, tol=CONVOLUTION)
    flip = k if name == "convolve2d" else k[::-1, ::-1]
    np.testing.assert_allclose(got.numpy(), _direct_conv2d(A, flip, mode, boundary),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fill_value", [2.0, -1.5])
@pytest.mark.parametrize("mode", MODES)
def test_fill_value(mode, fill_value):
    check("convolve2d", A, K, mode=mode, boundary="fill", fill_value=fill_value, tol=CONVOLUTION)
    check("correlate2d", A, K_EVEN, mode=mode, boundary="fill", fill_value=fill_value,
          tol=CONVOLUTION)


@pytest.mark.parametrize("boundary", ["wrap", "symm"])
def test_boundary_pads_longer_than_the_input(boundary):
    """A full-mode pad longer than the input repeats it as numpy's pad does
    (F.pad's circular and reflect modes refuse such pads)."""
    small = A[:2, :3]
    check("convolve2d", small, RNG.standard_normal((5, 6)).astype(np.float32)[:4, :5],
          mode="full", boundary=boundary, tol=CONVOLUTION)


def test_symm_repeats_the_edge():
    """numpy's "symmetric" pad repeats the edge element (torch's "reflect"
    does not): a 1 x 1 input convolved in full mode with a ones kernel sums
    its repeated value."""
    got = check("convolve2d", np.array([[2.0, 5.0]], np.float32), np.ones((1, 3), np.float32),
                mode="same", boundary="symm")
    np.testing.assert_array_equal(got.numpy(), [[9.0, 12.0]])


@pytest.mark.parametrize("shape", [(2, 2), (6, 2), (2, 7), (6, 7)])
def test_valid_swaps_when_the_kernel_is_larger(shape):
    """signal.c's rule: in valid mode a kernel larger than the input in
    either dimension swaps the two."""
    check("convolve2d", A[:shape[0], :shape[1]], A[:4, :5], mode="valid", tol=CONVOLUTION)
    # a kernel larger in one dimension only leaves an empty result after the swap
    check("correlate2d", A[:shape[0], :shape[1]], A[:4, :5], mode="valid", tol=CONVOLUTION)


def test_correlate2d_even_kernel_same_anchor_hand_computed():
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    k = np.array([[1.0, 0.0], [0.0, 2.0]], np.float32)
    got = check("correlate2d", a, k, mode="same")
    np.testing.assert_allclose(got.numpy(), [[2.0, 4.0], [6.0, 9.0]], atol=1e-6)


def test_2d_of_integers():
    a = RNG.integers(-3, 4, (5, 5)).astype(np.int32)
    check("convolve2d", a, np.ones((3, 3), np.int32), mode="same")
    check("correlate2d", a, np.arange(4, dtype=np.float32).reshape(2, 2), mode="full")


@pytest.mark.parametrize("bad", [{"mode": "nearest"}, {"boundary": "reflect"}])
def test_2d_bad_arguments_raise(bad):
    for pkg, a in ((jops, A), (tops, to_port(A))):
        with pytest.raises(ValueError):
            pkg.convolve2d(a, K, **bad)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lengths", [(3, 3), (7, 3), (3, 7), (8, 4), (5, 1)])
def test_convolve1d(mode, lengths):
    """numpy's convolve, the longer operand first."""
    a = RNG.standard_normal(lengths[0]).astype(np.float32)
    k = RNG.standard_normal(lengths[1]).astype(np.float32)
    got = check("convolve1d", a, k, mode=mode, tol=CONVOLUTION)
    np.testing.assert_allclose(got.numpy(), np.convolve(a, k, mode=mode), rtol=1e-5, atol=1e-6)


def test_convolve1d_of_integers_is_float32():
    got = check("convolve1d", np.array([1, 2, 3], np.int32), np.array([0, 1, 2], np.int32))
    assert got.dtype == torch.float32


# -- DNN convolutions -------------------------------------------------------------------

X = RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
X_ODD = RNG.standard_normal((2, 3, 7, 9)).astype(np.float32)
W = RNG.standard_normal((4, 3, 3, 3)).astype(np.float32)
W_EVEN = RNG.standard_normal((4, 3, 2, 4)).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2, (2, 1), 3])
@pytest.mark.parametrize("x", ["even", "odd"])
@pytest.mark.parametrize("w", ["3x3", "2x4"])
@pytest.mark.parametrize("padding", ["SAME", "VALID", "same"])
def test_conv2d_forward_padding_strings(stride, x, w, padding):
    """A trap: XLA's SAME gives ceil(in / stride) outputs with the odd pad at
    the end: a 6 x 6 input, a 3 x 3 filter and stride 2 pad (0, 1), where
    torch's padding=1 pads (1, 1)."""
    check("conv2d_forward", X if x == "even" else X_ODD, W if w == "3x3" else W_EVEN,
          stride=stride, padding=padding, tol=CONVOLUTION)


def test_same_stride_2_is_not_torchs_symmetric_pad():
    x = RNG.standard_normal((1, 1, 6, 6)).astype(np.float32)
    w = RNG.standard_normal((1, 1, 3, 3)).astype(np.float32)
    got = check("conv2d_forward", x, w, stride=2, padding="SAME", tol=CONVOLUTION)
    symmetric = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                                           padding=1)
    assert got.shape == symmetric.shape and not torch.allclose(got, symmetric, atol=1e-3)


@pytest.mark.parametrize("padding", [0, 1, 2, [(0, 1), (2, 0)], [(1, 1), (0, 0)]])
@pytest.mark.parametrize("dilation", [1, 2, (1, 2)])
def test_conv2d_forward_explicit_pads_and_dilation(padding, dilation):
    check("conv2d_forward", X, W, stride=1, padding=padding, dilation=dilation, tol=CONVOLUTION)
    check("conv2d_forward", X_ODD, W_EVEN, stride=2, padding=padding, dilation=dilation,
          tol=CONVOLUTION)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_forward_bias(padding):
    b = np.array([1.0, 2.0, 3.0, -1.0], np.float32)
    got = check("conv2d_forward", X, W, bias=b, padding=padding, tol=CONVOLUTION)
    nb = tops.conv2d_forward(to_port(X), to_port(W), padding=padding)
    torch.testing.assert_close(got - nb, torch.from_numpy(b).reshape(1, 4, 1, 1).expand_as(nb),
                               rtol=1e-5, atol=1e-5)


def test_conv2d_forward_direct_element():
    out = check("conv2d_forward", X, W, padding="VALID", tol=CONVOLUTION)
    assert tuple(out.shape) == (2, 4, 6, 6)
    np.testing.assert_allclose(out[0, 0, 0, 0].item(), (X[0, :, 0:3, 0:3] * W[0]).sum(), rtol=1e-4)


@pytest.mark.parametrize("stride,padding,dilation", [
    (1, "SAME", 1), (2, "SAME", 1), (1, "VALID", 1), (2, "VALID", 2), (1, 1, 1),
    (2, [(0, 1), (1, 0)], 1), ((1, 2), "SAME", (2, 1)),
])
@pytest.mark.parametrize("x", ["even", "odd"])
def test_conv2d_backward_is_the_vjp(stride, padding, dilation, x):
    """(dx, dw) against JAX's vjp of the forward with the same cotangent."""
    xx = X if x == "even" else X_ODD
    out = jops.conv2d_forward(xx, W, None, stride, padding, dilation)
    g = RNG.standard_normal(out.shape).astype(np.float32)
    want = jops.conv2d_backward(xx, W, g, stride, padding, dilation)
    got = tops.conv2d_backward(to_port(xx), to_port(W), to_port(g), stride, padding, dilation)
    for w_, g_, scale in zip(want, got, (1.0, float(np.abs(np.asarray(want[1])).max()))):
        assert tuple(g_.shape) == w_.shape and g_.dtype == torch.float32
        # dw sums over the whole batch and image: its bound scales with its size
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=CONVOLUTION["rtol"],
                                   atol=CONVOLUTION["atol"] * max(1.0, scale))


def test_conv2d_backward_matches_numerical():
    x = RNG.standard_normal((1, 1, 4, 4)).astype(np.float32)
    w = RNG.standard_normal((1, 1, 3, 3)).astype(np.float32)
    dx, dw = tops.conv2d_backward(to_port(x), to_port(w), torch.ones(1, 1, 4, 4))
    eps = 1e-2
    wp, wm = w.copy(), w.copy()
    wp[0, 0, 0, 0] += eps
    wm[0, 0, 0, 0] -= eps
    fp = tops.conv2d_forward(to_port(x), to_port(wp)).sum().item()
    fm = tops.conv2d_forward(to_port(x), to_port(wm)).sum().item()
    np.testing.assert_allclose(dw[0, 0, 0, 0].item(), (fp - fm) / (2 * eps), rtol=1e-2)
    assert dx.shape == x.shape


@pytest.mark.parametrize("padding", ["same", "valid", "full", "causal", "SAME"])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("groups,stride", [(1, 1), (2, 1), (4, 2), (2, 3)])
def test_conv1d_forward(padding, dilation, groups, stride):
    x = RNG.standard_normal((2, 4, 16)).astype(np.float32)
    w = RNG.standard_normal((4, 4 // groups, 3)).astype(np.float32)
    check("conv1d_forward", x, w, stride=stride, padding=padding, dilation=dilation,
          groups=groups, tol=CONVOLUTION)


def test_conv1d_even_kernel_and_bad_mode():
    x = RNG.standard_normal((1, 2, 9)).astype(np.float32)
    w = RNG.standard_normal((3, 2, 4)).astype(np.float32)
    for mode in ("same", "causal", "full", "valid"):
        check("conv1d_forward", x, w, padding=mode, tol=CONVOLUTION)
    for pkg, xx in ((jops, x), (tops, to_port(x))):
        with pytest.raises(ValueError):
            pkg.conv1d_forward(xx, w, padding="reflect")
