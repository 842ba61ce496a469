"""Fused ADMM box-QP kernel for condensed MPC (port of
numpower_tpu/kernels/boxqp_admm.py ``admm_mpc_pallas_res``, s-form).

The kernel is CUDA C++ in ``csrc/boxqp_admm.cu`` (its note says what bounds
it on the H100 and how the design answers that). This module holds the host
setup :func:`minv_factor`, the wrapper :func:`admm_mpc_res` and its plain
PyTorch version :func:`admm_mpc_res_reference`, which computes the same
function with the same bf16 rounding of the coarse-phase operands. The
wrapper takes the plain version for a tensor on the CPU only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels._build import MAX_D  # noqa: F401  (the routing envelope)
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand, _launch_shape
from numpower_tpu_torch.kernels.precision import bf16_round


def minv_factor(H: torch.Tensor, rho) -> torch.Tensor:
    """(H + rho I)^{-1} via Cholesky and two triangular solves: one
    factorization shared by every scenario and iteration. ``cholesky_ex`` does not wait on the device to check the factor; a
    matrix that is not positive definite gives NaNs, as in the JAX package."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L, _ = torch.linalg.cholesky_ex(H + rho * eye)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.T @ Linv


def _fold(H, SxT, SuTQT, rho, Minv):
    """Host-side folds: (rho Minv)' and Wc = Sx'(Su'Q)'Minv'."""
    if Minv is None:
        Minv = minv_factor(H, rho)
    rminvT = rho * Minv.T
    Wc = SxT @ (SuTQT @ Minv.T)
    return rminvT, Wc


def admm_mpc_res_reference(H, SxT, SuTQT, x0s, lo: float, hi: float, rho,
                           iters: int = 40, coarse_iters: int = 0,
                           over_relax: float = 1.6,
                           Minv: Optional[torch.Tensor] = None,
                           U0: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel: returns (z (N, d), r_primal,
    r_dual).

    c = x0s @ Wc, s = clip(U0) (clip(0) cold), then the s-form iteration
    p = clip(s), t = 2p - s, u = t @ (rho Minv)', s += alpha (u - c - p),
    whose first ``coarse_iters`` products round both operands to bf16.
    Residuals come from one more fp32 x-update at the final (z, y = s - z),
    as maxima over the N x d entries. Works in the dtype of its inputs."""
    coarse_iters = min(coarse_iters, iters)
    rminvT, Wc = _fold(H, SxT, SuTQT, rho, Minv)
    rminvT_coarse = bf16_round(rminvT)
    alpha = over_relax
    c = x0s @ Wc
    start = torch.zeros_like(c) if U0 is None else U0
    s = torch.clamp(start, lo, hi)
    for k in range(iters):
        p = torch.clamp(s, lo, hi)
        t = 2.0 * p - s
        u = bf16_round(t) @ rminvT_coarse if k < coarse_iters else t @ rminvT
        s = s + alpha * (u - c - p)
    z = torch.clamp(s, lo, hi)
    x = (2.0 * z - s) @ rminvT - c
    z_next = torch.clamp(s + alpha * (x - z), lo, hi)
    r_primal = torch.abs(x - z).max()
    r_dual = rho * torch.abs(z_next - z).max()
    return z, r_primal, r_dual


def admm_mpc_res(H, SxT, SuTQT, x0s, lo: float, hi: float, rho,
                 iters: int = 40, coarse_iters: int = 0, over_relax: float = 1.6,
                 Minv: Optional[torch.Tensor] = None,
                 U0: Optional[torch.Tensor] = None):
    """Fused ADMM MPC solve: returns (z (N, d), r_primal, r_dual).

    H (d, d); SxT (n, T n) = Sx'; SuTQT (T n, d) = (Su' Qbar)'; x0s (N, n);
    rho a scalar tensor (or float); Minv = (H + rho I)^{-1}, factored here
    when None; U0 (N, d) warm start, clipped. The folds (rho Minv)' and
    Wc = Sx'(Su'Q)'Minv' are host-side matmuls; c = x0s @ Wc, the whole
    iteration loop and both residuals run in the kernel. On a CPU tensor this
    is :func:`admm_mpc_res_reference`. Each kernel launch adds one to
    ``admm_mpc_res.launches``."""
    if x0s.device.type == "cpu":
        return admm_mpc_res_reference(H, SxT, SuTQT, x0s, lo, hi, rho, iters,
                                      coarse_iters, over_relax, Minv, U0)
    device, N, n, d, coarse_iters = _launch_shape(H, x0s, iters, coarse_iters)
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=device).reshape(())
    rminvT, Wc = _fold(H, SxT, SuTQT, rho_t, Minv)
    rminvT, Wc = rminvT.contiguous(), Wc.contiguous()
    for name, t, shape in (("(rho Minv)'", rminvT, (d, d)), ("Wc", Wc, (n, d)),
                           ("x0s", x0s, (N, n)), ("rho", rho_t, ())):
        _check_operand(name, t, device, shape)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    z = torch.empty((N, d), dtype=torch.float32, device=device)
    rp = torch.zeros((), dtype=torch.float32, device=device)
    rd = torch.zeros((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _build.library().npt_admm_mpc_res(
            rminvT.data_ptr(), Wc.data_ptr(), x0s.data_ptr(),
            None if U0 is None else U0.data_ptr(), rho_t.data_ptr(),
            z.data_ptr(), rp.data_ptr(), rd.data_ptr(), N, n, d, iters,
            coarse_iters, ctypes.c_float(float(lo)), ctypes.c_float(float(hi)),
            ctypes.c_float(float(over_relax)), stream)
    _build.check(code, "admm_mpc_res kernel launch")
    admm_mpc_res.launches += 1
    return z, rp, rd


admm_mpc_res.launches = 0
