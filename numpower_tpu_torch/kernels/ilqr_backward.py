"""Fused batched iLQR backward pass (K7; port of
numpower_tpu/kernels/ilqr_backward.py ``ilqr_backward_fused``).

The kernel is CUDA C++ in ``csrc/ilqr_backward.cu`` (its note says what bounds
it on the H100 and how the design answers that): one thread per scenario for
n <= 4, its whole step in registers, the horizon staged ahead in chunks by
bulk asynchronous copies; above, 8 or 16 lanes per scenario, lane i owning
row i of Vxx, to the narrow envelope (MAX_N, MAX_M); past it, for any (n, m),
the wide form of ``csrc/ilqr_backward_wide.cu``, one block per scenario with
its working set in shared memory, or in a device workspace this wrapper
allocates where that does not fit, its products on the tensor cores
(3xTF32), As and Bs read at their strides (the linearization's column-major
Jacobians in place); the whole T loop in one launch. This
module holds its wrapper, :func:`ilqr_backward_fused`, and its plain PyTorch
version, :func:`ilqr_backward_reference`, which runs the kernel's recursion
(not the full form of models/ilqr._backward_pass: the two agree only up to
rounding).
The wrapper takes the plain version for a tensor on the CPU only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand
from numpower_tpu_torch.utils.smallmat import psd_solve_unrolled

# The narrow forms' envelope (csrc/ilqr_backward.cu kMaxN, kMaxM), K5's: past
# it the wide form (csrc/ilqr_backward_wide.cu) takes any (n, m).
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


@functools.cache
def _workspace_floats_per_scenario(device_index: int, n: int, m: int) -> int:
    """Floats of the wide form's device workspace a scenario at (n, m) on
    the current device, cuda:device_index: 0 where shared memory holds its
    working set, or the narrow forms take (n, m)."""
    floats = _build.library().npt_ilqr_backward_workspace(1, n, m)
    if floats < 0:
        raise RuntimeError(f"ilqr_backward_fused: the shared-memory limit of cuda:{device_index} "
                           "is unreadable")
    return floats


def _wide_depth(device_index: int, n: int, m: int) -> int:
    """The wide form the kernel takes at (n, m) on cuda:device_index (the
    current device): 2 or 1 stage buffers in shared memory, 0 a workspace;
    -1 where the narrow forms take (n, m)."""
    with torch.cuda.device(device_index):
        return _build.library().npt_ilqr_backward_wide_depth(n, m)


def ilqr_backward_fused(As, Bs, lxs, lus, lxx, luu, lxT, lxxT, reg: float = 1e-3,
                        tile_b: int = 512, interpret: bool = False, luu_diags=None):
    """Batched iLQR backward pass.

    As (N,T,n,n), Bs (N,T,n,m): per-scenario/timestep linearizations;
    lxs (N,T,n), lus (N,T,m): affine stage-cost gradients; lxx (n,n),
    luu (m,m): shared stage-cost Hessians (2Q, 2R); lxT (N,n): terminal
    gradient; lxxT (n,n): terminal Hessian; reg: Levenberg term folded into
    luu; luu_diags (N,T,m), optional: per-scenario/timestep diagonal added to
    luu (the AL-iLQR active-set penalty Hessian). lxx, luu, lxxT may be numpy
    arrays or tensors anywhere (they are copied to As's device as fp32).

    Returns (ks (N,T,m), Ks (N,T,m,n)). Any N, n, m >= 1 and T >= 0, as the
    JAX kernel: n <= MAX_N and m <= MAX_M run the narrow forms, any other
    (n, m) the wide form, with a device workspace allocated here where its
    working set does not fit a block's shared memory. On a CPU tensor this
    is :func:`ilqr_backward_reference`. Each kernel launch, of either form,
    adds one to ``ilqr_backward_fused.launches``. tile_b and interpret are
    the JAX package's arguments (in its order) and have no effect: As's
    device chooses the route."""
    del tile_b, interpret
    if As.device.type == "cpu":
        return ilqr_backward_reference(As, Bs, lxs, lus, lxx, luu, lxT, lxxT, reg, luu_diags)
    device = As.device
    N, T, n = As.shape[0], As.shape[1], As.shape[-1]
    m = Bs.shape[-1]
    if not (N >= 1 and n >= 1 and m >= 1 and T >= 0):
        raise ValueError(f"(N, T, n, m) = ({N}, {T}, {n}, {m}): the kernel takes N, n, m >= 1 "
                         "and T >= 0")
    lxx, luu, lxxT = (torch.as_tensor(x, dtype=torch.float32, device=device) for x in
                      (lxx, luu, lxxT))
    luu_reg = (luu + reg * torch.eye(m, dtype=torch.float32, device=device)).contiguous()
    # the wide form reads As and Bs at their element strides, in any layout:
    # the linearization's column-major Jacobians (models/rollout.
    # linearize_trajectory) are not copied
    wide = n > MAX_N or m > MAX_M
    if not wide:
        As, Bs = As.contiguous(), Bs.contiguous()
    lxs, lus, lxT, lxx, lxxT = (x.contiguous() for x in (lxs, lus, lxT, lxx, lxxT))
    operands = [("As", As, (N, T, n, n)), ("Bs", Bs, (N, T, n, m)), ("lxs", lxs, (N, T, n)),
                ("lus", lus, (N, T, m)), ("lxx", lxx, (n, n)), ("luu", luu_reg, (m, m)),
                ("lxT", lxT, (N, n)), ("lxxT", lxxT, (n, n))]
    if luu_diags is not None:
        luu_diags = luu_diags.contiguous()
        operands.append(("luu_diags", luu_diags, (N, T, m)))
    for name, t, shape in operands:
        _check_operand(name, t, device, shape, contiguous=not (wide and name in ("As", "Bs")))
    ks = torch.empty((N, T, m), dtype=torch.float32, device=device)
    Ks = torch.empty((N, T, m, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (As.data_ptr(), Bs.data_ptr(), lxs.data_ptr(), lus.data_ptr(),
                None if luu_diags is None else luu_diags.data_ptr(), lxx.data_ptr(),
                luu_reg.data_ptr(), lxT.data_ptr(), lxxT.data_ptr(), ks.data_ptr(),
                Ks.data_ptr(), N, n, m, T)
        if wide:
            floats = N * _workspace_floats_per_scenario(device.index, n, m)
            work = torch.empty(floats, dtype=torch.float32, device=device) if floats else None
            code = _build.library().npt_ilqr_backward_wide(
                *args, None if work is None else work.data_ptr(), *As.stride(), *Bs.stride(),
                stream)
        else:
            code = _build.library().npt_ilqr_backward(*args, stream)
    _build.check(code, "ilqr_backward_fused kernel launch")
    ilqr_backward_fused.launches += 1
    return ks, Ks


ilqr_backward_fused.launches = 0
