"""Fused batched RTS mean pass (K10; port of
numpower_tpu/kernels/rts_batched.py ``rts_mean_pass_pallas``).

The kernel is CUDA C++ in ``csrc/rts_mean.cu`` (its note says what bounds it
on the H100 and how the design answers that): K9's design backward in time,
one lane per trajectory, one warp a block, the shared gains and each lane's
rows of e_t staged two chunks ahead through shared memory.
This module holds its wrapper, :func:`rts_mean_pass`, and its plain PyTorch
version, :func:`rts_mean_pass_reference`, which is also the "xla" route of
models/estimation.kalman_smoother_batched. The wrapper takes the plain
version for a tensor on the CPU only; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand

MAX_N = 16  # csrc/rts_mean.cu's largest bucket


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

    On a CPU tensor this is :func:`rts_mean_pass_reference`. Each kernel
    launch adds one to ``rts_mean_pass.launches``."""
    if x_last.device.type == "cpu":
        return rts_mean_pass_reference(G_Ts, es_t, x_last)
    device = x_last.device
    Tm1, N, n = es_t.shape
    if n > MAX_N:
        raise ValueError(f"n = {n} is outside the kernel's envelope (n <= {MAX_N})")
    G_Ts, es_t, x_last = (t.contiguous() for t in (G_Ts, es_t, x_last))
    for name, t, shape in (("G_Ts", G_Ts, (Tm1, n, n)), ("es_t", es_t, (Tm1, N, n)),
                           ("x_last", x_last, (N, n))):
        _check_operand(name, t, device, shape)
    xs = torch.empty((Tm1 + 1, N, n), dtype=torch.float32, device=device)
    code = _build.launch("npt_rts_mean", device, G_Ts.data_ptr(), es_t.data_ptr(),
                         x_last.data_ptr(), xs.data_ptr(), N, Tm1 + 1, n)
    _build.check(code, "rts_mean_pass kernel launch")
    rts_mean_pass.launches += 1
    return xs


rts_mean_pass.launches = 0
