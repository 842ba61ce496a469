"""Fused whole-horizon batched EKF (K11; port of numpower_tpu/kernels/ekf.py
``ekf_pallas``).

The kernel is CUDA C++ in ``csrc/ekf.cu`` (its note says what bounds it on
the H100 and how the design answers that): a group of 4 or 8 lanes per
trajectory, the state and covariance in registers, the value and the
Jacobian by one evaluation of the registered plant and measurement on
forward-mode dual numbers of n tangents (``csrc/plants.cuh``). This
module holds its wrapper, :func:`ekf_batched`, and its plain PyTorch version,
:func:`ekf_reference`. The plain version follows the kernel's algebra: the
covariances' upper triangles mirrored (not ``0.5 (P + P')`` as
models/estimation.ekf_filter, the "xla" route, takes), S^-1 applied by the
Cholesky factor's substitutions. The wrapper takes the plain version for a
tensor on the CPU only (any f and h); for a CUDA tensor it launches the
kernel or raises, and an unregistered plant or measurement raises ValueError.

Layout: the natural one, x0s (B, n), yss (B, T, p), uss (B, T, m) -> xs_f,
xs_p (B, T, n), Ps_f, Ps_p (B, T, n, n), ll (B,): the fields of
models/estimation.KalmanResult.
"""

from __future__ import annotations

import ctypes
import math

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand
from numpower_tpu_torch.utils.smallmat import (
    cholesky_unrolled, psd_solve_unrolled, tri_solve_unrolled,
)

# The envelope of the whole-filter kernels K11 and K12: n <= MAX_N, m <= MAX_M
# and p <= n (so p <= MAX_P = MAX_N), every measurement width of a registered
# plant (they have n <= 6). The JAX package's "auto" holds to the narrower
# ok_dims, p <= 4 (models/estimation.py:955-958; estimation.AUTO_ENVELOPES).
MAX_N = 8
MAX_P = 8
MAX_M = 4


def upper_mirror(M):
    """M's upper triangle mirrored into the lower one (the kernels' way of
    keeping a covariance symmetric)."""
    return torch.triu(M) + torch.triu(M, 1).transpose(-1, -2)


def innovation_update(x_p, P_p, CP, S, v, R):
    """The kernels' update from the prediction x_p: S + R with its upper
    triangle mirrored, W = S^-1 CP (CP the (B, p, n) cross term) by its
    Cholesky factor's substitutions, x_f = x_p + W'v, and the whitened
    innovation log-density. Returns (x_f, W, S + R mirrored, ll_step)."""
    S = upper_mirror(S + R)
    L = cholesky_unrolled(S)
    W = psd_solve_unrolled(S, CP)                          # (B, p, n)
    x_f = x_p + (W.transpose(1, 2) @ v[..., None])[..., 0]
    alpha = tri_solve_unrolled(L, v)
    p = v.shape[-1]
    ll = (-0.5 * ((alpha * alpha).sum(-1) + p * math.log(2.0 * math.pi))
          - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))
    return x_f, W, S, ll


def ekf_reference(f, h, Q, R, x0s, P0, yss, uss):
    """Plain PyTorch version of the kernel: the same arguments and results as
    :func:`ekf_batched`, for any f and h that index the last axis. Per step,
    batched over the trajectories: A = df/dx at x (torch.func.jacfwd),
    x_p = f(x, u), P_p = A P A' + Q, C = dh/dx at x_p, S = C P_p C' + R,
    W = S^-1 C P_p, x_f = x_p + W'(y - h(x_p)), P_f = P_p - W' C P_p, each
    covariance its upper triangle mirrored. Works in x0s's dtype and device."""
    from numpower_tpu_torch.models.estimation import _jac_x, _stack_time

    Q, R, P0 = (torch.as_tensor(a, dtype=x0s.dtype, device=x0s.device) for a in (Q, R, P0))
    x, P = x0s, P0.expand(x0s.shape[:1] + P0.shape)
    ll = torch.zeros(x0s.shape[:1], dtype=x0s.dtype, device=x0s.device)
    outs = []
    for t in range(yss.shape[1]):
        u = uss[:, t]
        A = _jac_x(f, x, u)
        x_p = f(x, u)
        P_p = upper_mirror(A @ P @ A.transpose(1, 2) + Q)
        C = _jac_x(h, x_p)
        CP = C @ P_p
        x, W, _, l = innovation_update(x_p, P_p, CP, CP @ C.transpose(1, 2), yss[:, t] - h(x_p),
                                       R)
        P = upper_mirror(P_p - W.transpose(1, 2) @ CP)
        ll = ll + l
        outs.append((x, P, x_p, P_p))
    xs_f, Ps_f, xs_p, Ps_p = _stack_time(outs, x, P)
    return xs_f, Ps_f, xs_p, Ps_p, ll


def kernel_operands(f, h, Q, R, x0s, P0, yss, uss, what: str):
    """The registered (plant, measurement), the checked float32 operands (Q,
    R, P0, x0s, yss, uss) on x0s's CUDA device and the empty outputs (xs_f,
    Ps_f, xs_p, Ps_p, ll) of a launch of K11 or K12; ValueError for what the
    kernels do not take."""
    from numpower_tpu_torch.models.plants import kernel_measurement, kernel_plant

    plant, meas = kernel_plant(f), kernel_measurement(h)
    if plant is None:
        raise ValueError(f"plant {f!r} is not registered for the {what} kernel "
                         "(numpower_tpu_torch.models.plants.kernel_plant); use method='xla'")
    if meas is None:
        raise ValueError(f"measurement {h!r} is not registered for the {what} kernel "
                         "(numpower_tpu_torch.models.plants.kernel_measurement); "
                         "use method='xla'")
    device = x0s.device
    B, T, p = yss.shape
    n, m = x0s.shape[1], uss.shape[2]
    if (n, m, p) != (plant.n, plant.m, meas.p):
        raise ValueError(f"the plant is ({plant.n}, {plant.m}) with {meas.p} measured, "
                         f"the operands ({n}, {m}) with {p}")
    if n > MAX_N or p > n or m > MAX_M:
        raise ValueError(f"(n, p, m) = ({n}, {p}, {m}) is outside the {what} kernel's envelope "
                         f"(n <= {MAX_N}, p <= n, m <= {MAX_M})")
    to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()  # noqa: E731
    Q, R, P0 = (to_dev(a) for a in (Q, R, P0))
    x0s, yss, uss = (a.contiguous() for a in (x0s, yss, uss))
    for name, t, shape in (("Q", Q, (n, n)), ("R", R, (p, p)), ("P0", P0, (n, n)),
                           ("x0s", x0s, (B, n)), ("yss", yss, (B, T, p)),
                           ("uss", uss, (B, T, m))):
        _check_operand(name, t, device, shape)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)  # noqa: E731
    outs = (empty(B, T, n), empty(B, T, n, n), empty(B, T, n), empty(B, T, n, n), empty(B))
    return plant, meas, (Q, R, P0, x0s, yss, uss), outs


def plant_floats(plant):
    """The plant's parameter floats, padded to the kernels' eight, as ctypes."""
    from numpower_tpu_torch.models.plants import MAX_PLANT_PARAMS

    params = list(plant.params) + [0.0] * (MAX_PLANT_PARAMS - len(plant.params))
    return [ctypes.c_float(v) for v in params]


def ekf_batched(f, h, Q, R, x0s, P0, yss, uss):
    """Batched EKF, the whole filter in one kernel launch.

    f a registered plant (models/plants.kernel_plant), h a registered
    measurement (kernel_measurement), or partials of them; Q (n, n), R
    (p, p), P0 (n, n) shared; x0s (B, n), yss (B, T, p), uss (B, T, m).
    Returns (xs_f (B, T, n), Ps_f (B, T, n, n), xs_p, Ps_p, ll (B,)), the
    KalmanResult fields.

    On a CPU tensor this is :func:`ekf_reference`. Each kernel launch adds one
    to ``ekf_batched.launches``."""
    if x0s.device.type == "cpu":
        return ekf_reference(f, h, Q, R, x0s, P0, yss, uss)
    plant, meas, ins, outs = kernel_operands(f, h, Q, R, x0s, P0, yss, uss, "EKF")
    B, T = yss.shape[:2]
    code = _build.launch(
        "npt_ekf", x0s.device, plant.plant_id, *plant_floats(plant), meas.measure_id, meas.p,
        *(t.data_ptr() for t in ins), outs[0].data_ptr(), outs[2].data_ptr(),
        outs[1].data_ptr(), outs[3].data_ptr(), outs[4].data_ptr(), B, T)
    _build.check(code, "ekf_batched kernel launch")
    ekf_batched.launches += 1
    return outs


ekf_batched.launches = 0


def ekf_pallas(f, h, Q, R, x0s, P0, yss, uss, tile_b: int = 1024, interpret: bool = False):
    """K11 by the JAX package's name (numpower_tpu/kernels/ekf.py):
    :func:`ekf_batched`, with its operands and results. tile_b and interpret
    have no effect: x0s's device chooses the route."""
    del tile_b, interpret
    return ekf_batched(f, h, Q, R, x0s, P0, yss, uss)
