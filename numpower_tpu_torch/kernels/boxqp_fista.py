"""FISTA box-QP kernels for condensed MPC (port of
numpower_tpu/kernels/boxqp_fista.py ``fista_mpc_pallas_res``, K2,
``fista_boxqp_pallas``, K3b, and ``fista_mpc_pallas``, K2', with the drop-in
``solve_mpc_boxqp_pallas``).

The three kernels are one CUDA C++ template in ``csrc/boxqp_fista.cu`` (its
note says what bounds it on the H100 and how the design answers that), each
on two tiles (``csrc/boxqp_tile.cuh``): one block a 32-scenario tile for
d <= 128, a cluster of ceil(d / 128) blocks for 128 < d <= 1024, whose
matrix operand the wrapper splits and lays out once (:func:`_wide_operand`). K2
forms g = x0 @ W and the residual in the kernel, K3b takes g as given, K2'
forms g and returns it beside U. K2 and K2' take any state dimension n, as
the JAX kernels do: the kernel sums the (n, d) fold W in chunks of
``_build.FOLD_ROWS`` = 32 rows, in order. This module holds their wrappers,
:func:`fista_mpc_res`, :func:`fista_boxqp` and :func:`fista_mpc`, and their
plain PyTorch versions, :func:`fista_mpc_res_reference`,
:func:`fista_boxqp_reference` and :func:`fista_mpc_reference`, which compute
the same functions with the same bf16 rounding of the coarse-phase operands
and the same precision classes (K2's ``tail_precision`` and
``g_precision``, kernels/precision.py). A wrapper takes the plain version
for a tensor on the CPU only; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels._build import MAX_D, TILE_D
from numpower_tpu_torch.kernels.precision import (
    bf16_round, bf16_split3, make_tail_dot, precision_code,
)

# K2's precision classes, the JAX package's value sets (boxqp_fista.py:312-313)
TAIL_PRECISIONS = ("bf16x3", "highest")
G_PRECISIONS = ("highest", "bf16x4", "bf16x3")


def _fista_betas(iters: int) -> list[float]:
    """Static FISTA momentum schedule: t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2,
    beta_k = (t_k - 1) / t_{k+1}."""
    betas = []
    t = 1.0
    for _ in range(iters):
        t_next = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        betas.append((t - 1.0) / t_next)
        t = t_next
    return betas


def fista_mpc_res_reference(H, SxT, SuTQT, x0s, lo: float, hi: float, lipschitz,
                            iters: int = 40, coarse_iters: int = 0,
                            U0: Optional[torch.Tensor] = None,
                            tail_precision: str = "highest", g_precision: str = "highest"):
    """Plain PyTorch version of the kernel: returns (U (N, d), resid).

    g = x0s @ (SxT @ SuTQT) in the class ``g_precision``; static-beta FISTA
    from U0 (not clipped; zeros when None), whose first ``coarse_iters``
    products round both operands to bf16 and whose tail products run in the
    class ``tail_precision``; the momentum restarts at the switch to the
    tail. resid is the projected-gradient residual max over the N x d
    entries, its product in the tail's class. Works in the dtype of its
    inputs (float64 for a reference run at coarse_iters=0 in "highest")."""
    return _fista_mpc_res_plain(H, H.T, SxT @ SuTQT, x0s, lo, hi, lipschitz, iters,
                                coarse_iters, U0, tail_precision, g_precision)


def _fista_mpc_res_plain(H, Ht, W, x0s, lo: float, hi: float, lipschitz, iters: int,
                         coarse_iters: int, U0, tail_precision: str, g_precision: str):
    """:func:`fista_mpc_res_reference` on the kernel's host-side operands
    H' and W = SxT @ SuTQT (the first two of :func:`_fista_folds`)."""
    precision_code(tail_precision, TAIL_PRECISIONS, "tail_precision")
    precision_code(g_precision, G_PRECISIONS, "g_precision")
    g = make_tail_dot(W, g_precision)(x0s)
    tail_dot = make_tail_dot(Ht, tail_precision)
    U = _fista_loop(H, g, lo, hi, lipschitz, iters, coarse_iters, U0, tail_dot)
    step = 1.0 / lipschitz
    grad = tail_dot(U) + g
    resid = torch.abs(U - torch.clamp(U - step * grad, lo, hi)).max()
    return U, resid


def _fista_loop(H, g, lo: float, hi: float, lipschitz, iters: int, coarse_iters: int, U0,
                tail_dot):
    """The loop of the three kernels: static-beta FISTA from U0 (not
    clipped; zeros when None), the first ``coarse_iters`` products with both
    operands rounded to bf16, the tail's by ``tail_dot``; the momentum
    restarts at the switch to the tail. Returns U."""
    coarse_iters = min(coarse_iters, iters)
    Ht_coarse = bf16_round(H.T)
    step = 1.0 / lipschitz
    betas = _fista_betas(coarse_iters) + _fista_betas(iters - coarse_iters)
    U = torch.zeros_like(g) if U0 is None else U0
    Y = U
    for k in range(iters):
        gemm = bf16_round(Y) @ Ht_coarse if k < coarse_iters else tail_dot(Y)
        U_new = torch.clamp(Y - step * (gemm + g), lo, hi)
        beta = 0.0 if k == coarse_iters - 1 else betas[k]
        Y = U_new + beta * (U_new - U)
        U = U_new
    return U


def fista_boxqp_reference(H, g, lo: float, hi: float, lipschitz, iters: int = 40,
                          coarse_iters: int = 0, U0: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the two-step kernel: U (N, d) from g (N, d).

    Static-beta FISTA from U0 (not clipped; zeros when None), whose first
    ``coarse_iters`` products round both operands to bf16; the momentum
    restarts at the switch to the fp32 tail. The loop of the three kernels.
    Works in the dtype of its inputs."""
    return _fista_loop(H, g, lo, hi, lipschitz, iters, coarse_iters, U0,
                       make_tail_dot(H.T, "highest"))


def fista_mpc_reference(H, SxT, SuTQT, x0s, lo: float, hi: float, lipschitz,
                        iters: int = 40, coarse_iters: int = 0):
    """Plain PyTorch version of K2': returns (U, g), both (N, d).

    g = x0s @ (SxT @ SuTQT), then :func:`fista_boxqp_reference` on that g
    from a cold start at 0: K2' is K3b on the g it forms. Works in the dtype
    of its inputs."""
    g = x0s @ (SxT @ SuTQT)
    return fista_boxqp_reference(H, g, lo, hi, lipschitz, iters, coarse_iters), g


def _check_operand(name: str, t: torch.Tensor, device: torch.device, shape,
                   dtype: torch.dtype = torch.float32, contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_shape(H, x0s, iters: int, coarse_iters: int):
    """(device, N, n, d, coarse_iters) of a launch on x0s's CUDA device, or a
    ValueError for what the kernels do not take: d <= MAX_D = 1024, the JAX
    package's bound (the narrow tile to TILE_D = 128, the wide one past it),
    and any n >= 1, as the JAX kernels fold any state dimension. The
    two-step kernels pass their (N, d) g as x0s."""
    if x0s.device.type != "cuda":
        raise ValueError(f"x0s is on {x0s.device}: the kernel needs a CUDA tensor")
    if x0s.ndim != 2:
        raise ValueError(f"the kernel takes a batch (N, width), got shape {tuple(x0s.shape)}")
    N, n = x0s.shape
    d = H.shape[0]
    if not (1 <= d <= MAX_D and n >= 1 and N >= 1):
        raise ValueError(f"(N, n, d) = ({N}, {n}, {d}) is outside the kernel's "
                         f"envelope: N >= 1, n >= 1, d <= {MAX_D}")
    if iters < 0 or coarse_iters < 0:
        raise ValueError("iters and coarse_iters must be non-negative")
    return x0s.device, N, n, d, min(coarse_iters, iters)


def _wide_operand(m: torch.Tensor) -> Optional[torch.Tensor]:
    """The wide tile's matrix operand (csrc/boxqp_tile.cuh, WideTile) from the
    kernels' fp32 (d, d) operand m (H' or (rho Minv)'), or None where
    d <= TILE_D (the narrow tile stages m itself). A = m' zero-padded to
    D = 128 b, b = ceil(d / 128) the cluster's blocks, split exactly into
    bf16 parts hi + mid + lo (precision.bf16_split3, the split the narrow
    kernels make in shared memory), laid out (b, 3, 2 b, 8192): for block r,
    part p and 64-column slab s, the 128 x 64 block A[128 r.., 64 s..] as
    8 x 8 core matrices, K-major, each slab one contiguous 16 KB copy."""
    d = m.shape[0]
    if d <= TILE_D:
        return None
    b = -(-d // TILE_D)
    A = torch.zeros((TILE_D * b, TILE_D * b), dtype=torch.float32, device=m.device)
    A[:d, :d] = m.T
    parts = torch.stack([part.to(torch.bfloat16) for part in bf16_split3(A)])
    # (p, r, j // 8, j % 8, s, k // 8, k % 8) -> (r, p, s, j // 8, k // 8, j % 8, k % 8)
    return parts.view(3, b, 16, 8, 2 * b, 8, 8).permute(1, 0, 4, 2, 5, 3, 6).reshape(
        b, 3, 2 * b, 8 * TILE_D * 8).contiguous()


def _matrix_operand(name: str, m: torch.Tensor, wide: Optional[torch.Tensor],
                    device: torch.device, d: int) -> torch.Tensor:
    """The matrix a launch passes: m (d, d) for the narrow tile; past TILE_D
    the wide tile's split operand, ``wide`` when given (formed once by a
    caller that solves one QP many times), else formed from m here."""
    _check_operand(name, m, device, (d, d))
    if d <= TILE_D:
        return m
    wide = _wide_operand(m) if wide is None else wide
    b = -(-d // TILE_D)
    _check_operand(f"{name} (split)", wide, device, (b, 3, 2 * b, 8 * TILE_D * 8),
                   torch.bfloat16)
    return wide


def _entry(name: str, d: int):
    """The library's launch function `name` for d: its wide entry past TILE_D."""
    return getattr(_build.library(), f"{name}_wide" if d > TILE_D else name)


def _fista_folds(H, SxT, SuTQT) -> tuple:
    """The host-side operands of the FISTA kernels, which depend on the QP
    alone: (H', W, H' split) with the fold W = SxT @ SuTQT, each contiguous,
    and the wide tile's operand of H' on the card past d = 128
    (:func:`_wide_operand`; None otherwise). A caller that solves one QP
    many times (models/mpc.MPCController) forms them once and hands them to
    :func:`_fista_mpc_res` and :func:`_fista_boxqp`."""
    Ht = H.T.contiguous()
    return Ht, (SxT @ SuTQT).contiguous(), _wide_operand(Ht) if Ht.is_cuda else None


def _mpc_operands(H, SxT, SuTQT, x0s, lipschitz, iters: int, coarse_iters: int, U0=None,
                  folds=None):
    """The checked operands of a launch that forms g in the kernel: the
    launch shape, the matrix (H', or its wide operand past d = 128), the
    fold W = SxT @ SuTQT (one host-side matmul, or ``folds`` from
    :func:`_fista_folds`) and the Lipschitz constant, on x0s's device."""
    shape = device, N, n, d, _ = _launch_shape(H, x0s, iters, coarse_iters)
    Ht, W, wide = _fista_folds(H, SxT, SuTQT) if folds is None else folds
    lip = torch.as_tensor(lipschitz, dtype=torch.float32, device=device).reshape(())
    mat = _matrix_operand("H'", Ht, wide, device, d)
    for name, t, want in (("W", W, (n, d)), ("x0s", x0s, (N, n)), ("lipschitz", lip, ())):
        _check_operand(name, t, device, want)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    return shape, mat, W, lip


def fista_mpc_res(H, SxT, SuTQT, x0s, lo: float, hi: float, lipschitz,
                  iters: int = 40, coarse_iters: int = 0,
                  U0: Optional[torch.Tensor] = None,
                  tail_precision: str = "highest", g_precision: str = "highest"):
    """Fused FISTA MPC solve: returns (U (N, d), resid scalar).

    H (d, d); SxT (n, T n) = Sx'; SuTQT (T n, d) = (Su' Qbar)'; x0s (N, n);
    lipschitz a scalar tensor (or float); U0 (N, d) warm start. The fold
    W = SxT @ SuTQT is one host-side matmul; g = x0s @ W, the whole iteration
    loop and the residual run in the kernel. tail_precision ("bf16x3" |
    "highest") is the class of the tail and residual products, g_precision
    ("highest" | "bf16x4" | "bf16x3") that of g (kernels/precision.py); the
    port's defaults are "highest", where the JAX package's tail default is
    "bf16x3". On a CPU tensor this is :func:`fista_mpc_res_reference`. Each
    kernel launch adds one to ``fista_mpc_res.launches``; one
    recorded into a CUDA graph does not (its replays run it, models/mpc.py)."""
    return _fista_mpc_res(H, SxT, SuTQT, x0s, lo, hi, lipschitz, iters, coarse_iters, U0,
                          tail_precision, g_precision, None)


def _fista_mpc_res(H, SxT, SuTQT, x0s, lo: float, hi: float, lipschitz, iters: int,
                   coarse_iters: int, U0, tail_precision: str, g_precision: str,
                   folds: Optional[tuple]):
    """:func:`fista_mpc_res` with its QP-only operands given: ``folds`` =
    (H', W, H' split) of :func:`_fista_folds`, formed here when None. On a
    CPU tensor the plain version runs on the same H' and W."""
    tail_code = precision_code(tail_precision, TAIL_PRECISIONS, "tail_precision")
    g_code = precision_code(g_precision, G_PRECISIONS, "g_precision")
    if x0s.device.type == "cpu":
        if folds is None:
            return fista_mpc_res_reference(H, SxT, SuTQT, x0s, lo, hi, lipschitz,
                                           iters, coarse_iters, U0, tail_precision, g_precision)
        return _fista_mpc_res_plain(H, *folds[:2], x0s, lo, hi, lipschitz, iters, coarse_iters,
                                    U0, tail_precision, g_precision)
    (device, N, n, d, coarse_iters), mat, W, lip = _mpc_operands(
        H, SxT, SuTQT, x0s, lipschitz, iters, coarse_iters, U0, folds)
    U = torch.empty((N, d), dtype=torch.float32, device=device)
    resid = torch.zeros((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = _entry("npt_fista_mpc_res", d)(
            mat.data_ptr(), W.data_ptr(), x0s.data_ptr(),
            None if U0 is None else U0.data_ptr(), lip.data_ptr(),
            U.data_ptr(), resid.data_ptr(), N, n, d, iters, coarse_iters,
            ctypes.c_float(float(lo)), ctypes.c_float(float(hi)), tail_code, g_code, stream)
    _build.check(code, "fista_mpc_res kernel launch")
    if not capturing:  # a launch recorded into a CUDA graph runs on its replays
        fista_mpc_res.launches += 1
    return U, resid


fista_mpc_res.launches = 0


def fista_mpc(H, SxT, SuTQT, x0s, lo: float, hi: float, lipschitz, iters: int = 40,
              coarse_iters: int = 0):
    """FISTA MPC solve with g formed in the kernel (K2'): returns (U, g),
    both (N, d), from a cold start at 0 and with no residual.

    Operands as :func:`fista_mpc_res`; the products are fp32. The caller
    forms the residual from the g it gets back, as the JAX package's
    callers do. On a CPU tensor this is :func:`fista_mpc_reference`. Each
    kernel launch adds one to ``fista_mpc.launches``."""
    if x0s.device.type == "cpu":
        return fista_mpc_reference(H, SxT, SuTQT, x0s, lo, hi, lipschitz, iters, coarse_iters)
    (device, N, n, d, coarse_iters), mat, W, lip = _mpc_operands(
        H, SxT, SuTQT, x0s, lipschitz, iters, coarse_iters)
    U = torch.empty((N, d), dtype=torch.float32, device=device)
    g = torch.empty((N, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _entry("npt_fista_mpc", d)(
            mat.data_ptr(), W.data_ptr(), x0s.data_ptr(), lip.data_ptr(), U.data_ptr(),
            g.data_ptr(), N, n, d, iters, coarse_iters, ctypes.c_float(float(lo)),
            ctypes.c_float(float(hi)), stream)
    _build.check(code, "fista_mpc kernel launch")
    fista_mpc.launches += 1
    return U, g


fista_mpc.launches = 0


def fista_boxqp(H, g, lo: float, hi: float, lipschitz, iters: int = 40,
                coarse_iters: int = 0, U0: Optional[torch.Tensor] = None, *,
                tile_n: int = 1024, interpret: bool = False):
    """Two-step FISTA box-QP solve: argmin_U 1/2 U'HU + g_i'U, lo <= U <= hi,
    for each row g_i of g (N, d); returns U (N, d).

    H (d, d); lipschitz a scalar tensor (or float); U0 (N, d) warm start (not
    clipped). The whole iteration loop runs in the kernel; the caller forms
    the residual. On a CPU tensor this is :func:`fista_boxqp_reference`. Each
    kernel launch adds one to ``fista_boxqp.launches``; one recorded into a
    CUDA graph does not (its replays run it, models/mpc.py). tile_n and
    interpret are the JAX package's arguments and have no effect: g's device
    chooses the route."""
    del tile_n, interpret
    return _fista_boxqp(H, g, lo, hi, lipschitz, iters, coarse_iters, U0, None)


def _fista_boxqp(H, g, lo: float, hi: float, lipschitz, iters: int, coarse_iters: int, U0,
                 folds: Optional[tuple]):
    """:func:`fista_boxqp` with the operands of :func:`_fista_folds` given
    (H' and, past d = 128, its wide operand; W is not read), formed here
    when None. On a CPU tensor the plain version runs on the same H'."""
    if g.device.type == "cpu":
        if folds is None:
            return fista_boxqp_reference(H, g, lo, hi, lipschitz, iters, coarse_iters, U0)
        return _fista_loop(H, g, lo, hi, lipschitz, iters, coarse_iters, U0,
                           make_tail_dot(folds[0], "highest"))
    device, N, _, d, coarse_iters = _launch_shape(H, g, iters, coarse_iters)
    Ht, _, wide = (H.T.contiguous(), None, None) if folds is None else folds
    mat = _matrix_operand("H'", Ht, wide, device, d)
    lip = torch.as_tensor(lipschitz, dtype=torch.float32, device=device).reshape(())
    for name, t, shape in (("g", g, (N, d)), ("lipschitz", lip, ())):
        _check_operand(name, t, device, shape)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    U = torch.empty((N, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = _entry("npt_fista_boxqp", d)(
            mat.data_ptr(), g.data_ptr(), None if U0 is None else U0.data_ptr(),
            lip.data_ptr(), U.data_ptr(), N, d, iters, coarse_iters,
            ctypes.c_float(float(lo)), ctypes.c_float(float(hi)), stream)
    _build.check(code, "fista_boxqp kernel launch")
    if not capturing:  # a launch recorded into a CUDA graph runs on its replays
        fista_boxqp.launches += 1
    return U


fista_boxqp.launches = 0


def solve_mpc_boxqp_pallas(qp, x0s, u_lo: float, u_hi: float, iters: int = 40,
                           coarse_iters: Optional[int] = None):
    """Drop-in for models.boxqp.solve_mpc_boxqp over the two-step kernel: g
    from the QP, U by :func:`fista_boxqp`, the residual outside. x0s (N, n)."""
    from numpower_tpu_torch.models.boxqp import BoxQPResult
    from numpower_tpu_torch.models.condensed import default_coarse_iters, gradient_offset

    if coarse_iters is None:
        coarse_iters = default_coarse_iters(qp, iters)
    g = gradient_offset(qp, x0s)
    U = fista_boxqp(qp.H, g, u_lo, u_hi, qp.lipschitz, iters=iters,
                    coarse_iters=coarse_iters)
    step = 1.0 / qp.lipschitz
    grad = U @ qp.H.T + g
    resid = torch.abs(U - torch.clamp(U - step * grad, u_lo, u_hi)).max()
    return BoxQPResult(U=U, iterations=iters, residual=resid)


# -- the JAX package's names (numpower_tpu/kernels/boxqp_fista.py) ------------
# Each takes the JAX function's operands in its order and returns its results
# in its layout. tile_n and interpret have no effect: the operands' device
# chooses the route, the kernel on a CUDA tensor and its plain version on a
# CPU one. The precision classes keep the port's default, "highest".


def fista_mpc_pallas_res(H, SxT, SuTQT, x0s, lo, hi, lipschitz, iters: int = 40,
                         coarse_iters: int = 0, tile_n: int = 1024, interpret: bool = False,
                         U0: Optional[torch.Tensor] = None, tail_precision: str = "highest",
                         g_precision: str = "highest"):
    """K2 by the JAX package's name: :func:`fista_mpc_res`, (U (N, d), resid)."""
    del tile_n, interpret
    return fista_mpc_res(H, SxT, SuTQT, x0s, lo, hi, lipschitz, iters, coarse_iters, U0,
                         tail_precision, g_precision)


def fista_mpc_pallas(H, SxT, SuTQT, x0s, lo, hi, lipschitz, iters: int = 40,
                     coarse_iters: int = 0, tile_n: int = 1024, interpret: bool = False):
    """K2' by the JAX package's name: :func:`fista_mpc`, (U, g)."""
    del tile_n, interpret
    return fista_mpc(H, SxT, SuTQT, x0s, lo, hi, lipschitz, iters, coarse_iters)


def fista_boxqp_pallas(H, g, lo, hi, lipschitz, iters: int = 40, coarse_iters: int = 0,
                       tile_n: int = 1024, interpret: bool = False,
                       U0: Optional[torch.Tensor] = None):
    """K3b by the JAX package's name: :func:`fista_boxqp`, U (N, d)."""
    return fista_boxqp(H, g, lo, hi, lipschitz, iters, coarse_iters, U0, tile_n=tile_n,
                       interpret=interpret)
