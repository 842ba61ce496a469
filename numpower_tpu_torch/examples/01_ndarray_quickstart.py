"""NumPower-user quickstart: the NDArray object API (the port of
examples/01_ndarray_quickstart.py).

Run from the repository root (on the card; --device cpu for the CPU):
    PYTHONPATH=. python numpower_tpu_torch/examples/01_ndarray_quickstart.py

Mirrors NumPower's README workflow (construction, operators, linalg,
persistence, iteration) on the port's array layer.
"""

import argparse
import os
import tempfile

import torch

from numpower_tpu_torch import NDArray, ops

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = torch.device(parser.parse_args().device)


def array(rows) -> NDArray:
    """An NDArray on the chosen device (a list alone goes to the card)."""
    return NDArray(torch.tensor(rows, dtype=torch.float32, device=dev))


# construction (fp32 like NumPower) + operators + chaining
a = array([[1.0, 2.0], [3.0, 4.0]])
b = (a @ a.T + 1.0).sqrt()
print("chained:", b)

# linalg: cholesky / det / trace (batched, unlike NumPower)
spd = array([[4.0, 2.0], [2.0, 3.0]])
print("cholesky:", spd.cholesky())
print("det:", spd.det(), " trace:", spd.trace())

# broadcasting strictly generalizes NumPower's partial cases
row = array([10.0, 20.0])
print("broadcast add:", a + row)

# reductions with axis/keepdims; 0-d results are Python floats
print("sum:", a.sum(), " mean(axis=0):", a.mean(axis=0))

# persistence: .npy round trip (the native fast path for large files)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "example_a.npy")
    a.save(path)
    print("reloaded:", NDArray(ops.load(path, device=dev)))

# iteration protocol (first-axis subviews, like NumPower)
for row_view in a:
    print("row:", row_view)

# the functional layer on tensors
x = ops.convolve2d(ops.random.normal((8, 8), device=dev), ops.ones((3, 3), device=dev) / 9,
                   mode="same")
print("conv out shape:", tuple(x.shape))
