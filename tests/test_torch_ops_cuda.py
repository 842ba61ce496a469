"""The port's op surface (numpower_tpu_torch.ops, all of it) and its NDArray
on the card: every exported op on CUDA tensors at 4096 x 4096 float32 (a
NumPower user's working array, 64 MB an operand; the decompositions at
1024 and on 4096 12 x 12 stacks) against the same op on CPU copies of its
inputs, its dtype equal and its result on the card, and the second half
(linalg, signal, dnn, io, image, random) again at 256 x 256; median and
quantile past torch.quantile's 2^24 elements; numpy operands and creation
with no device on the card; the NDArray phase (chip_smoke.py phase 21). The
cases and tolerances are chip_smoke.py phase 20's (op_cases: exact;
transcendentals and sqrt rtol 1e-6, atol 1e-7; reductions rtol 1e-6, atol
1e-6 on positive data; cumsum, cumprod and prod along 4096 terms, and every
product of K terms, each within (K - 1) 2^-24 of the float64 result; solves
and spectra rtol 1e-4, atol 1e-4 of float64; factorizations by their
reconstruction within 4 n eps max(1, max |A|) and their invariants; random
draws by their moments over 2^24 samples and the same draws after the same
seed).

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor numpower_tpu, so it runs on the GPU machine without the
conftest:

    python -m pytest --noconftest tests/test_torch_ops_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from numpower_tpu_torch import ops

pytestmark = pytest.mark.cuda
CASES = {name: (fn, tol) for name, fn, tol in chip_smoke.op_cases()}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the op surface's card results")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def operands(device):
    host = chip_smoke.ops_inputs()
    return host, {k: v.to(device) for k, v in host.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(device, operands, name):
    fn, tol = CASES[name]
    host, on_card = operands
    assert chip_smoke.ops_check(fn, tol, on_card, host) == ""


def test_every_exported_op_has_a_case():
    assert chip_smoke.exported_ops() == set(CASES)


SMALL = 256
SMALL_CASES = {name: (fn, tol) for name, fn, tol in chip_smoke.second_half_cases(SMALL)}


@pytest.fixture(scope="module")
def small_operands(device):
    host = chip_smoke.ops_inputs(SMALL, seed=3)
    return host, {k: v.to(device) for k, v in host.items()}


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_second_half_at_a_small_size(device, small_operands, name):
    fn, tol = SMALL_CASES[name]
    host, on_card = small_operands
    assert chip_smoke.ops_check(fn, tol, on_card, host) == ""


def test_eig_complex_stays_on_the_card(device):
    """A deliberate difference: the JAX package puts eig_complex's results
    on its CPU device; the port's stay on the operand's device."""
    a = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 8)).astype(np.float32))
    w, v = ops.eig_complex(a.to(device))
    assert w.device.type == "cuda" and v.device.type == "cuda" and w.dtype == torch.complex64


def test_ndarray_on_the_card(device):
    chip_smoke.ndarray_family(device, "test")


@pytest.mark.parametrize("name", ["median", "quantile"])
def test_median_quantile_past_two_to_the_24(device, name):
    n = chip_smoke.N_OPS_BIG
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((n, n)).astype(np.float32))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x.to(device), 0.5)
    fn = ops.median if name == "median" else (lambda t: ops.quantile(t, [0.01, 0.5]))
    tol = chip_smoke.OPS_EXACT if name == "median" else chip_smoke.OPS_REDUCTION
    assert chip_smoke.ops_agree(fn(x.to(device)), fn(x), tol, "cuda") == ""


def test_numpy_operands_and_creation_default_to_the_card(device):
    a = np.ones((3, 4), np.float32)
    for got in (ops.add(a, a), ops.asarray([1.0, 2.0]), ops.zeros(3), ops.eye(3),
                ops.linspace(0, 1, 5), ops.arange(4), ops.full((2,), 1.0)):
        assert got.device.type == "cuda"
    cpu = torch.ones(3)
    assert ops.add(cpu, np.ones(3, np.float32)).device.type == "cpu"  # follows the tensor
    assert ops.add(torch.ones(3, device=device), 2.0).device.type == "cuda"
