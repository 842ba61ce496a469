"""Fused batched RTS mean pass (K10; port of
numpower_tpu/kernels/rts_batched.py ``rts_mean_pass_pallas``).

The kernel is CUDA C++ in two forms, each with a note that says what bounds
it on the H100 and how the design answers that. The narrow form,
``csrc/rts_mean.cu``, takes n <= MAX_N: K9's design backward in time, one
lane per trajectory, one warp a block, the shared gains and each lane's rows
of e_t staged two chunks ahead through shared memory. The wide form,
``csrc/kalman_wide.cu`` (beside the wide K9), takes any larger n, as the JAX
kernel does: a tile of trajectories a block, each step's product spread over
the block's threads, with a device workspace allocated here where even a
tile of 4 trajectories does not fit in shared memory.
This module holds its wrapper, :func:`rts_mean_pass`, and its plain PyTorch
version, :func:`rts_mean_pass_reference`, which is also the "xla" route of
models/estimation.kalman_smoother_batched. The wrapper takes the plain
version for a tensor on the CPU only; for a CUDA tensor it launches a kernel
or raises.
"""

from __future__ import annotations

import functools

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand

MAX_N = 16  # the narrow form's envelope (csrc/rts_mean.cu's largest bucket)


def rts_mean_pass_reference(G_Ts, es_t, x_last):
    """Plain PyTorch version of the kernel: x_s[T-1] = x_last and, for
    t = T-2 .. 0, x_s[t] = x_s[t+1] @ G_t' + e_t, batched over the
    trajectories. Returns xs (T, N, n) in forward time order."""
    x = x_last
    xs = [x]
    for t in range(es_t.shape[0] - 1, -1, -1):
        x = x @ G_Ts[t] + es_t[t]
        xs.append(x)
    return torch.stack(xs[::-1])


def rts_mean_pass(G_Ts, es_t, x_last):
    """Batched RTS mean backward recurrence, the whole horizon in one kernel
    launch. G_Ts (T-1, n, n), the transposed smoother gains G_t' shared by
    the batch; es_t (T-1, N, n), the affine terms; x_last (N, n), the anchor
    x_f[T-1]; T >= 2. Returns xs_s (T, N, n). The data are made contiguous;
    every operand must be float32 on x_last's device.

    Any N, n >= 1: n <= MAX_N takes the narrow form, any larger n the wide
    one. On a CPU tensor this is :func:`rts_mean_pass_reference`. Each
    kernel launch, of either form, adds one to ``rts_mean_pass.launches``."""
    if x_last.device.type == "cpu":
        return rts_mean_pass_reference(G_Ts, es_t, x_last)
    device = x_last.device
    Tm1, N, n = es_t.shape
    if not (N >= 1 and n >= 1 and Tm1 >= 1):
        raise ValueError(f"(N, T, n) = ({N}, {Tm1 + 1}, {n}): the kernel takes N, n >= 1 and "
                         "T >= 2")
    G_Ts, es_t, x_last = (t.contiguous() for t in (G_Ts, es_t, x_last))
    for name, t, shape in (("G_Ts", G_Ts, (Tm1, n, n)), ("es_t", es_t, (Tm1, N, n)),
                           ("x_last", x_last, (N, n))):
        _check_operand(name, t, device, shape)
    xs = torch.empty((Tm1 + 1, N, n), dtype=torch.float32, device=device)
    args = (G_Ts.data_ptr(), es_t.data_ptr(), x_last.data_ptr(), xs.data_ptr())
    if n <= MAX_N:
        code = _build.launch("npt_rts_mean", device, *args, N, Tm1 + 1, n)
    else:
        floats = _wide_workspace_floats(device.index, N, n)
        work = torch.empty(floats, dtype=torch.float32, device=device) if floats else None
        code = _build.launch("npt_rts_mean_wide", device, *args,
                             None if work is None else work.data_ptr(), N, Tm1 + 1, n)
    _build.check(code, "rts_mean_pass kernel launch")
    rts_mean_pass.launches += 1
    return xs


rts_mean_pass.launches = 0


@functools.cache
def _wide_workspace_floats(device_index: int, N: int, n: int) -> int:
    """Floats of device workspace the wide form needs for N trajectories at n
    on cuda:device_index: 0 where its tile fits in shared memory."""
    with torch.cuda.device(device_index):
        floats = _build.library().npt_rts_mean_wide_workspace(N, n)
    if floats < 0:
        raise RuntimeError(f"rts_mean_pass: the shared-memory limit of cuda:{device_index} is "
                           "unreadable")
    return floats


def wide_plan(device_index: int, n: int) -> tuple:
    """(form, tile) the wide form takes at n on cuda:device_index, as
    kalman_mean.wide_plan."""
    with torch.cuda.device(device_index):
        code = _build.library().npt_rts_mean_wide_plan(n)
    if code < 0:
        raise RuntimeError(f"rts_mean_pass: the wide form's plan on cuda:{device_index} is "
                           "unreadable")
    return divmod(code, 100)
