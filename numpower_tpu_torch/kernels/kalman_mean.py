"""Fused batched Kalman mean pass (K9; port of
numpower_tpu/kernels/kalman_batched.py ``kalman_mean_pass_pallas``).

The kernel is CUDA C++ in two forms, each with a note that says what bounds
it on the H100 and how the design answers that. The narrow form,
``csrc/kalman_mean.cu``, takes n <= MAX_N and p <= MAX_P: one lane per
trajectory, one warp a block, the whole horizon in one launch, the shared
gains and each lane's rows staged two chunks ahead through shared memory.
The wide form, ``csrc/kalman_wide.cu``, takes every other (n, p), as the JAX
kernel takes any: a tile of trajectories a block, each step's products
spread over the block's threads, with a device workspace allocated here
where even a tile of 4 trajectories does not fit in shared memory. This
module holds the wrapper, :func:`kalman_mean_pass`, and its plain PyTorch
version, :func:`kalman_mean_pass_reference`. The wrapper takes the plain
version for a tensor on the CPU only; for a CUDA tensor it launches a kernel
or raises.

Layout: the JAX package's time-major one, ys_t (T, N, p), us_t (T, N, n) ->
xs_f, xs_p (T, N, n), so the rows of one step are one contiguous run.
"""

from __future__ import annotations

import functools
import math

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand

# The narrow form's envelope (csrc/kalman_mean.cu's buckets: n and p padded to
# 2/4/8/16 and 1/2/4/8); the wide form takes any other n, p >= 1.
MAX_N = 16
MAX_P = 8


def _step_constants(logdets, p: int):
    """The per-step constant of the innovation log-density, logdet_t +
    0.5 p log 2pi, subtracted once per step (the TPU kernel's algebra)."""
    return logdets + 0.5 * (p * math.log(2.0 * math.pi))


def kalman_mean_pass_reference(A, C, Ws, invLs, logdets, x0s, ys_t, us_t=None):
    """Plain PyTorch version of the kernel: the same arguments and results as
    :func:`kalman_mean_pass`. Per step, batched over the trajectories:

        x_p = x A' + u_t;  v = y_t - x_p C';  x = x_p + v W_t;
        alpha = v invL_t';  ll -= 0.5 |alpha|^2 + cst_t

    Works in x0s's dtype and device."""
    cst = _step_constants(logdets, ys_t.shape[-1])
    x = x0s
    ll = torch.zeros(x0s.shape[:1], dtype=x0s.dtype, device=x0s.device)
    xs_f, xs_p = [], []
    for t in range(ys_t.shape[0]):
        x_p = x @ A.T
        if us_t is not None:
            x_p = x_p + us_t[t]
        v = ys_t[t] - x_p @ C.T
        x = x_p + v @ Ws[t]
        alpha = v @ invLs[t].T
        ll = ll - 0.5 * (alpha * alpha).sum(1) - cst[t]
        xs_f.append(x)
        xs_p.append(x_p)
    return torch.stack(xs_f), torch.stack(xs_p), ll


def kalman_mean_pass(A, C, Ws, invLs, logdets, x0s, ys_t, us_t=None):
    """Batched Kalman mean recurrence with shared gains, the whole horizon in
    one kernel launch.

    A (n, n), C (p, n), Ws (T, p, n), invLs (T, p, p), logdets (T,) [the
    covariance pass of kalman_filter_batched], x0s (N, n), ys_t (T, N, p),
    us_t optional (T, N, n) input terms (already u B'). Returns xs_f (T, N,
    n), xs_p (T, N, n), ll (N,). The data are made contiguous (a copy where
    they are not); every operand must be float32 on x0s's device.

    Any N, n, p, T >= 1: n <= MAX_N and p <= MAX_P take the narrow form,
    any other (n, p) the wide one. On a CPU tensor this is
    :func:`kalman_mean_pass_reference`. Each kernel launch, of either form,
    adds one to ``kalman_mean_pass.launches``."""
    if x0s.device.type == "cpu":
        return kalman_mean_pass_reference(A, C, Ws, invLs, logdets, x0s, ys_t, us_t)
    device = x0s.device
    T, N, p = ys_t.shape
    n = x0s.shape[1]
    if not (N >= 1 and n >= 1 and p >= 1 and T >= 1):
        raise ValueError(f"(N, T, n, p) = ({N}, {T}, {n}, {p}): the kernel takes N, T, n, "
                         "p >= 1")
    A, C, Ws, invLs, x0s, ys_t = (t.contiguous() for t in (A, C, Ws, invLs, x0s, ys_t))
    cst = _step_constants(logdets, p).contiguous()
    operands = [("A", A, (n, n)), ("C", C, (p, n)), ("Ws", Ws, (T, p, n)),
                ("invLs", invLs, (T, p, p)), ("cst", cst, (T,)), ("x0s", x0s, (N, n)),
                ("ys_t", ys_t, (T, N, p))]
    if us_t is not None:
        us_t = us_t.contiguous()
        operands.append(("us_t", us_t, (T, N, n)))
    for name, t, shape in operands:
        _check_operand(name, t, device, shape)
    xs_f = torch.empty((T, N, n), dtype=torch.float32, device=device)
    xs_p = torch.empty((T, N, n), dtype=torch.float32, device=device)
    ll = torch.empty((N,), dtype=torch.float32, device=device)
    args = (A.data_ptr(), C.data_ptr(), Ws.data_ptr(), invLs.data_ptr(), cst.data_ptr(),
            x0s.data_ptr(), ys_t.data_ptr(), None if us_t is None else us_t.data_ptr(),
            xs_f.data_ptr(), xs_p.data_ptr(), ll.data_ptr())
    if n <= MAX_N and p <= MAX_P:
        code = _build.launch("npt_kalman_mean", device, *args, N, T, n, p)
    else:
        floats = _wide_workspace_floats(device.index, N, n, p, us_t is not None)
        work = torch.empty(floats, dtype=torch.float32, device=device) if floats else None
        code = _build.launch("npt_kalman_mean_wide", device, *args,
                             None if work is None else work.data_ptr(), N, T, n, p)
    _build.check(code, "kalman_mean_pass kernel launch")
    kalman_mean_pass.launches += 1
    return xs_f, xs_p, ll


kalman_mean_pass.launches = 0


@functools.cache
def _wide_workspace_floats(device_index: int, N: int, n: int, p: int, has_u: bool) -> int:
    """Floats of device workspace the wide form needs for N trajectories at
    (n, p) on cuda:device_index: 0 where its tile fits in shared memory."""
    with torch.cuda.device(device_index):
        floats = _build.library().npt_kalman_mean_wide_workspace(N, n, p, int(has_u))
    if floats < 0:
        raise RuntimeError(f"kalman_mean_pass: the shared-memory limit of cuda:{device_index} "
                           "is unreadable")
    return floats


def wide_plan(device_index: int, n: int, p: int, has_u: bool) -> tuple:
    """(form, tile) the wide form takes at (n, p) on cuda:device_index: form 0
    holds the shared matrices and the tile in shared memory, form 1 reads the
    matrices through L1, form 2 keeps the tile in a device workspace; the
    tile is the trajectories a block."""
    with torch.cuda.device(device_index):
        code = _build.library().npt_kalman_mean_wide_plan(n, p, int(has_u))
    if code < 0:
        raise RuntimeError(f"kalman_mean_pass: the wide form's plan on cuda:{device_index} "
                           "is unreadable")
    return divmod(code, 100)
