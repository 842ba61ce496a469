"""Fused whole-horizon batched UKF (K12; port of numpower_tpu/kernels/ukf.py
``ukf_pallas``).

The kernel is CUDA C++ in ``csrc/ukf.cu`` (its note says what bounds it on
the H100 and how the design answers that): a group of 8 or 16 lanes per
trajectory, lane k forming Wan-Merwe sigma point k and sending it through
the registered plant (``csrc/plants.cuh``) in the kernel; every lane
gathers the images and forms the moments and the update itself. This
module holds its wrapper, :func:`ukf_batched`, and its plain PyTorch version,
:func:`ukf_reference`, which follows the kernel's algebra (the spread
c_sig 0.5 (P + P') + 1e-9 I, covariances' upper triangles mirrored, S^-1
applied by substitution). The wrapper takes the plain version for a tensor
on the CPU only (any f and h); for a CUDA tensor it launches the kernel or
raises, and an unregistered plant or measurement raises ValueError.

Layout as kernels/ekf.py.
"""

from __future__ import annotations

import ctypes

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.ekf import (
    innovation_update, kernel_operands, plant_floats, upper_mirror,
)
from numpower_tpu_torch.utils.smallmat import cholesky_unrolled

JITTER = 1e-9  # on the spread's diagonal, as the JAX package adds it


def sigma_weights(n: int, alpha: float, beta: float, kappa: float):
    """(wm_0, wm_i, wc_0, wc_i, c_sig 0.5): the Wan-Merwe weights of point 0
    and of points 1..2n, and the spread, folded in double as the JAX package
    folds them in Python."""
    lam = alpha * alpha * (n + kappa) - n
    c_sig = n + lam
    return (lam / c_sig, 0.5 / c_sig, lam / c_sig + (1.0 - alpha * alpha + beta), 0.5 / c_sig,
            c_sig * 0.5)


def ukf_reference(f, h, Q, R, x0s, P0, yss, uss, alpha: float = 1.0, beta: float = 2.0,
                  kappa: float = 0.0):
    """Plain PyTorch version of the kernel: the same arguments and results as
    :func:`ukf_batched`, for any f and h that index the last axis. Works in
    x0s's dtype and device."""
    from numpower_tpu_torch.models.estimation import _stack_time

    Q, R, P0 = (torch.as_tensor(a, dtype=x0s.dtype, device=x0s.device) for a in (Q, R, P0))
    B, n = x0s.shape
    wm0, wmi, wc0, wci, c_half = sigma_weights(n, alpha, beta, kappa)
    kw = dict(dtype=x0s.dtype, device=x0s.device)
    wm = torch.tensor([wm0] + [wmi] * (2 * n), **kw)
    wc = torch.tensor([wc0] + [wci] * (2 * n), **kw)
    jitter = JITTER * torch.eye(n, **kw)

    def sigma_points(x, P):                        # (B, 2n+1, n)
        S_T = cholesky_unrolled(c_half * (P + P.transpose(1, 2)) + jitter).transpose(1, 2)
        return torch.cat([x[:, None], x[:, None] + S_T, x[:, None] - S_T], dim=1)

    x, P = x0s, P0.expand(B, n, n)
    ll = torch.zeros((B,), **kw)
    outs = []
    for t in range(yss.shape[1]):
        u = uss[:, t]
        pts = sigma_points(x, P)
        fx = f(pts, u[:, None].expand(pts.shape[:2] + u.shape[1:]))
        x_p = wm @ fx
        dX = fx - x_p[:, None]
        P_p = upper_mirror((wc[:, None] * dX).transpose(1, 2) @ dX + Q)
        pts2 = sigma_points(x_p, P_p)
        hy = h(pts2)
        y_p = wm @ hy
        dY = hy - y_p[:, None]
        Pxy = (wc[:, None] * (pts2 - x_p[:, None])).transpose(1, 2) @ dY      # (B, n, p)
        x, W, S, l = innovation_update(x_p, P_p, Pxy.transpose(1, 2),
                                       (wc[:, None] * dY).transpose(1, 2) @ dY, yss[:, t] - y_p,
                                       R)
        P = upper_mirror(P_p - W.transpose(1, 2) @ (S @ W))
        ll = ll + l
        outs.append((x, P, x_p, P_p))
    xs_f, Ps_f, xs_p, Ps_p = _stack_time(outs, x, P)
    return xs_f, Ps_f, xs_p, Ps_p, ll


def ukf_batched(f, h, Q, R, x0s, P0, yss, uss, alpha: float = 1.0, beta: float = 2.0,
                kappa: float = 0.0):
    """Batched UKF, the whole filter in one kernel launch; the arguments and
    results of kernels/ekf.ekf_batched plus the sigma-point parameters.

    On a CPU tensor this is :func:`ukf_reference`. Each kernel launch adds one
    to ``ukf_batched.launches``."""
    if x0s.device.type == "cpu":
        return ukf_reference(f, h, Q, R, x0s, P0, yss, uss, alpha, beta, kappa)
    plant, meas, ins, outs = kernel_operands(f, h, Q, R, x0s, P0, yss, uss, "UKF")
    B, T = yss.shape[:2]
    weights = sigma_weights(x0s.shape[1], alpha, beta, kappa) + (JITTER,)
    with torch.cuda.device(x0s.device):
        stream = torch.cuda.current_stream(x0s.device).cuda_stream
        code = _build.library().npt_ukf(
            plant.plant_id, *plant_floats(plant), meas.measure_id, meas.p,
            *(ctypes.c_float(w) for w in weights), *(t.data_ptr() for t in ins),
            outs[0].data_ptr(), outs[2].data_ptr(), outs[1].data_ptr(), outs[3].data_ptr(),
            outs[4].data_ptr(), B, T, stream)
    _build.check(code, "ukf_batched kernel launch")
    ukf_batched.launches += 1
    return outs


ukf_batched.launches = 0


def ukf_pallas(f, h, Q, R, x0s, P0, yss, uss, alpha: float = 1.0, beta: float = 2.0,
               kappa: float = 0.0, tile_b: int = 1024, interpret: bool = False):
    """K12 by the JAX package's name (numpower_tpu/kernels/ukf.py):
    :func:`ukf_batched`, with its operands and results. tile_b and interpret
    have no effect: x0s's device chooses the route."""
    del tile_b, interpret
    return ukf_batched(f, h, Q, R, x0s, P0, yss, uss, alpha, beta, kappa)
