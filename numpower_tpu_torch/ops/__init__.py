"""The port's functional op surface, the counterpart of numpower_tpu.ops:
the same names and signatures as plain functions on tensors (creation,
dtypes, elementwise, logic, reductions, statistics, manipulation, linalg,
signal, dnn, io, image, and the ``random`` module). Tensor operands keep
their device; numpy arrays, lists and Python scalars follow the first tensor
operand, and the functions that build an array from nothing (creation,
``load``, ``deserialize``, ``from_image``, the random draws) take
``device=None``, the card (``utils.default_device``). The object wrapper is
``numpower_tpu_torch.ndarray.NDArray``.
"""

from numpower_tpu_torch.ops.creation import (  # noqa: F401
    array, asarray, zeros, ones, full, empty, empty_like, zeros_like,
    ones_like, identity, eye, arange, linspace, diag, diagonal, fill, copy, tri,
)
from numpower_tpu_torch.ops.elementwise import (  # noqa: F401
    add, subtract, multiply, divide, pow, power, mod, maximum, minimum,
    arctan2, abs, absolute, sqrt, rsqrt, exp, exp2, expm1, log, log2, log10,
    log1p, logb, sin, cos, tan, arcsin, arccos, arctan, sinh, cosh, tanh,
    arcsinh, arccosh, arctanh, degrees, radians, rint, fix, floor, ceil,
    trunc, round, sinc, negative, positive, sign, reciprocal, square, clip,
)
from numpower_tpu_torch.ops.logic import (  # noqa: F401
    equal, not_equal, greater, greater_equal, less, less_equal, all, any,
    allclose, array_equal, isnan, isinf, isfinite, where,
)
from numpower_tpu_torch.ops.reductions import (  # noqa: F401
    sum, prod, mean, median, min, max, argmin, argmax, cumsum, cumprod,
    sort, argsort, take, searchsorted,
)
from numpower_tpu_torch.ops.statistics import (  # noqa: F401
    quantile, percentile, std, variance, var, average,
)
from numpower_tpu_torch.ops.manipulation import (  # noqa: F401
    transpose, reshape, flatten, ravel, flip, expand_dims, squeeze, swapaxes,
    rollaxis, moveaxis, concatenate, append, vstack, hstack, dstack,
    column_stack, stack, atleast_1d, atleast_2d, atleast_3d, split, tile,
    repeat, roll, broadcast_to, is_broadcastable, slice,
)
from numpower_tpu_torch.ops.linalg import (  # noqa: F401
    matmul, dot, inner, outer, trace, cholesky, solve, solve_triangular,
    cho_solve, inv, det, lu, qr, svd, svdvals, eig, eig_complex, eigh,
    eigvals, norm,
    cond, matrix_rank, lstsq, pinv, matrix_power, kron, einsum,
)
from numpower_tpu_torch.ops.signal import convolve2d, correlate2d, convolve1d  # noqa: F401
from numpower_tpu_torch.ops.dnn import conv1d_forward, conv2d_forward, conv2d_backward  # noqa: F401
from numpower_tpu_torch.ops.io import save, load, serialize, deserialize, to_list  # noqa: F401
from numpower_tpu_torch.ops.image import from_image, to_image  # noqa: F401
from numpower_tpu_torch.ops.dtypes import resolve_dtype, get_type_size, is_type  # noqa: F401
from numpower_tpu_torch.ops import random  # noqa: F401
