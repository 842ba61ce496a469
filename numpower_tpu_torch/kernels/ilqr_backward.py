"""Fused batched iLQR backward pass (K7; port of
numpower_tpu/kernels/ilqr_backward.py ``ilqr_backward_fused``).

The kernel is CUDA C++ in ``csrc/ilqr_backward.cu`` (its note says what bounds
it on the H100 and how the design answers that): one thread per scenario for
n <= 4, its whole step in registers, the horizon staged ahead in chunks by
bulk asynchronous copies; above, 8 or 16 lanes per scenario, lane i owning
row i of Vxx; the whole T loop in one launch. This module holds its
wrapper, :func:`ilqr_backward_fused`, and its plain PyTorch version,
:func:`ilqr_backward_reference`, which runs the kernel's recursion (not the
full form of models/ilqr._backward_pass: the two agree only up to rounding).
The wrapper takes the plain version for a tensor on the CPU only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand
from numpower_tpu_torch.utils.smallmat import psd_solve_unrolled

# The kernel's envelope (csrc/ilqr_backward.cu kMaxN, kMaxM), K5's.
MAX_N = 16
MAX_M = 8


def _mirror_upper(X: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix whose upper triangle is X's (the kernel forms
    the upper triangle and mirrors it)."""
    return X.triu() + X.triu(1).transpose(-1, -2)


def ilqr_backward_reference(As, Bs, lxs, lus, lxx, luu, lxT, lxxT, reg: float = 1e-3,
                            luu_diags=None):
    """Plain PyTorch version of the kernel: the same arguments and results as
    :func:`ilqr_backward_fused`. Per backward step, batched over the
    scenarios:

        Qx = lx + A'Vx;  Qu = lu + B'Vx;  W = Vxx A
        Qxx = lxx + A'W (upper, mirrored);  Quu = luu + reg I + diag(luu_diag) + B'Vxx B
        Qux = B'W;  [k | K] = -Quu^{-1} [Qu | Qux]   (Cholesky of Quu's lower triangle)
        Vx' = Qx + Qux'k;  Vxx' = Qxx + Qux'K (upper, mirrored)

    Works in As's dtype and device (float64 for a reference run)."""
    N, T, n, _ = As.shape
    m = Bs.shape[-1]
    dt, dev = As.dtype, As.device
    lxx, luu, lxxT = (torch.as_tensor(x, dtype=dt, device=dev) for x in (lxx, luu, lxxT))
    luu_reg = luu + reg * torch.eye(m, dtype=dt, device=dev)
    ks = torch.empty((N, T, m), dtype=dt, device=dev)
    Ks = torch.empty((N, T, m, n), dtype=dt, device=dev)
    Vx = lxT
    Vxx = lxxT.expand(N, n, n)
    for t in range(T - 1, -1, -1):
        A, B = As[:, t], Bs[:, t]
        At, Bt = A.transpose(1, 2), B.transpose(1, 2)
        Qx = lxs[:, t] + (At @ Vx[..., None])[..., 0]
        Qu = lus[:, t] + (Bt @ Vx[..., None])[..., 0]
        W = Vxx @ A
        Qxx = _mirror_upper(lxx + At @ W)
        Quu = luu_reg + Bt @ (Vxx @ B)
        if luu_diags is not None:
            Quu = Quu + torch.diag_embed(luu_diags[:, t])
        Qux = Bt @ W
        sol = -psd_solve_unrolled(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
        k, K = sol[..., 0], sol[..., 1:]
        Vx = Qx + (Qux.transpose(1, 2) @ k[..., None])[..., 0]
        Vxx = _mirror_upper(Qxx + Qux.transpose(1, 2) @ K)
        ks[:, t], Ks[:, t] = k, K
    return ks, Ks


def ilqr_backward_fused(As, Bs, lxs, lus, lxx, luu, lxT, lxxT, reg: float = 1e-3,
                        luu_diags=None):
    """Batched iLQR backward pass.

    As (N,T,n,n), Bs (N,T,n,m): per-scenario/timestep linearizations;
    lxs (N,T,n), lus (N,T,m): affine stage-cost gradients; lxx (n,n),
    luu (m,m): shared stage-cost Hessians (2Q, 2R); lxT (N,n): terminal
    gradient; lxxT (n,n): terminal Hessian; reg: Levenberg term folded into
    luu; luu_diags (N,T,m), optional: per-scenario/timestep diagonal added to
    luu (the AL-iLQR active-set penalty Hessian). lxx, luu, lxxT may be numpy
    arrays or tensors anywhere (they are copied to As's device as fp32).

    Returns (ks (N,T,m), Ks (N,T,m,n)). Envelope: n <= MAX_N, m <= MAX_M
    (ValueError beyond). On a CPU tensor this is
    :func:`ilqr_backward_reference`. Each kernel launch adds one to
    ``ilqr_backward_fused.launches``."""
    if As.device.type == "cpu":
        return ilqr_backward_reference(As, Bs, lxs, lus, lxx, luu, lxT, lxxT, reg, luu_diags)
    device = As.device
    N, T, n = As.shape[0], As.shape[1], As.shape[-1]
    m = Bs.shape[-1]
    if not (N >= 1 and 1 <= n <= MAX_N and 1 <= m <= MAX_M and T >= 0):
        raise ValueError(f"(N, T, n, m) = ({N}, {T}, {n}, {m}) is outside the kernel's "
                         f"envelope: N >= 1, n <= {MAX_N}, m <= {MAX_M}")
    lxx, luu, lxxT = (torch.as_tensor(x, dtype=torch.float32, device=device) for x in
                      (lxx, luu, lxxT))
    luu_reg = (luu + reg * torch.eye(m, dtype=torch.float32, device=device)).contiguous()
    As, Bs, lxs, lus, lxT = (x.contiguous() for x in (As, Bs, lxs, lus, lxT))
    operands = [("As", As, (N, T, n, n)), ("Bs", Bs, (N, T, n, m)), ("lxs", lxs, (N, T, n)),
                ("lus", lus, (N, T, m)), ("lxx", lxx.contiguous(), (n, n)),
                ("luu", luu_reg, (m, m)), ("lxT", lxT, (N, n)),
                ("lxxT", lxxT.contiguous(), (n, n))]
    if luu_diags is not None:
        luu_diags = luu_diags.contiguous()
        operands.append(("luu_diags", luu_diags, (N, T, m)))
    for name, t, shape in operands:
        _check_operand(name, t, device, shape)
    lxx, lxxT = operands[4][1], operands[7][1]
    ks = torch.empty((N, T, m), dtype=torch.float32, device=device)
    Ks = torch.empty((N, T, m, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _build.library().npt_ilqr_backward(
            As.data_ptr(), Bs.data_ptr(), lxs.data_ptr(), lus.data_ptr(),
            None if luu_diags is None else luu_diags.data_ptr(), lxx.data_ptr(),
            luu_reg.data_ptr(), lxT.data_ptr(), lxxT.data_ptr(), ks.data_ptr(), Ks.data_ptr(),
            N, n, m, T, stream)
    _build.check(code, "ilqr_backward_fused kernel launch")
    ilqr_backward_fused.launches += 1
    return ks, Ks


ilqr_backward_fused.launches = 0
