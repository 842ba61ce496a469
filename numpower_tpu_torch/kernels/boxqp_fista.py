"""FISTA box-QP kernels for condensed MPC (port of
numpower_tpu/kernels/boxqp_fista.py ``fista_mpc_pallas_res``, K2,
``fista_boxqp_pallas``, K3b, and ``fista_mpc_pallas``, K2', with the drop-in
``solve_mpc_boxqp_pallas``).

The three kernels are one CUDA C++ template in ``csrc/boxqp_fista.cu`` (its
note says what bounds it on the H100 and how the design answers that): K2
forms g = x0 @ W and the residual in the kernel, K3b takes g as given, K2'
forms g and returns it beside U. This module holds their wrappers,
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
from numpower_tpu_torch.kernels._build import MAX_D, MAX_N
from numpower_tpu_torch.kernels.precision import bf16_round, make_tail_dot, precision_code

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
    H' and W = SxT @ SuTQT (:func:`_fista_folds`)."""
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


def _check_operand(name: str, t: torch.Tensor, device: torch.device, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_shape(H, x0s, iters: int, coarse_iters: int, n_max: int = MAX_N):
    """(device, N, n, d, coarse_iters) of a launch on x0s's CUDA device, or a
    ValueError for what the kernels do not take. The two-step kernels pass
    their (N, d) g as x0s, with no bound on its width but d's."""
    if x0s.device.type != "cuda":
        raise ValueError(f"x0s is on {x0s.device}: the kernel needs a CUDA tensor")
    if x0s.ndim != 2:
        raise ValueError(f"the kernel takes a batch (N, width), got shape {tuple(x0s.shape)}")
    N, n = x0s.shape
    d = H.shape[0]
    if not (1 <= d <= MAX_D and 1 <= n <= n_max and N >= 1):
        raise ValueError(f"(N, n, d) = ({N}, {n}, {d}) is outside the kernel's "
                         f"envelope: N >= 1, n <= {n_max}, d <= {MAX_D}")
    if iters < 0 or coarse_iters < 0:
        raise ValueError("iters and coarse_iters must be non-negative")
    return x0s.device, N, n, d, min(coarse_iters, iters)


def _fista_folds(H, SxT, SuTQT) -> tuple:
    """The host-side operands of the FISTA kernels, which depend on the QP
    alone: (H', W) with the fold W = SxT @ SuTQT, each contiguous. A caller
    that solves one QP many times (models/mpc.MPCController) forms them
    once and hands them to :func:`_fista_mpc_res` and :func:`_fista_boxqp`."""
    return H.T.contiguous(), (SxT @ SuTQT).contiguous()


def _mpc_operands(H, SxT, SuTQT, x0s, lipschitz, iters: int, coarse_iters: int, U0=None,
                  folds=None):
    """The checked operands of a launch that forms g in the kernel: the
    launch shape, H', the fold W = SxT @ SuTQT (one host-side matmul, or
    ``folds`` from :func:`_fista_folds`) and the Lipschitz constant, on x0s's
    device."""
    shape = device, N, n, d, _ = _launch_shape(H, x0s, iters, coarse_iters)
    Ht, W = _fista_folds(H, SxT, SuTQT) if folds is None else folds
    lip = torch.as_tensor(lipschitz, dtype=torch.float32, device=device).reshape(())
    for name, t, want in (("H'", Ht, (d, d)), ("W", W, (n, d)), ("x0s", x0s, (N, n)),
                          ("lipschitz", lip, ())):
        _check_operand(name, t, device, want)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    return shape, Ht, W, lip


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
    (H', W) of :func:`_fista_folds`, formed here when None. On a CPU tensor
    the plain version runs on the same folds."""
    tail_code = precision_code(tail_precision, TAIL_PRECISIONS, "tail_precision")
    g_code = precision_code(g_precision, G_PRECISIONS, "g_precision")
    if x0s.device.type == "cpu":
        if folds is None:
            return fista_mpc_res_reference(H, SxT, SuTQT, x0s, lo, hi, lipschitz,
                                           iters, coarse_iters, U0, tail_precision, g_precision)
        return _fista_mpc_res_plain(H, *folds, x0s, lo, hi, lipschitz, iters, coarse_iters, U0,
                                    tail_precision, g_precision)
    (device, N, n, d, coarse_iters), Ht, W, lip = _mpc_operands(
        H, SxT, SuTQT, x0s, lipschitz, iters, coarse_iters, U0, folds)
    U = torch.empty((N, d), dtype=torch.float32, device=device)
    resid = torch.zeros((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = _build.library().npt_fista_mpc_res(
            Ht.data_ptr(), W.data_ptr(), x0s.data_ptr(),
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
    (device, N, n, d, coarse_iters), Ht, W, lip = _mpc_operands(
        H, SxT, SuTQT, x0s, lipschitz, iters, coarse_iters)
    U = torch.empty((N, d), dtype=torch.float32, device=device)
    g = torch.empty((N, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _build.library().npt_fista_mpc(
            Ht.data_ptr(), W.data_ptr(), x0s.data_ptr(), lip.data_ptr(), U.data_ptr(),
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
                 Ht: Optional[torch.Tensor]):
    """:func:`fista_boxqp` with H' given (the first of :func:`_fista_folds`),
    formed here when None. On a CPU tensor the plain version runs on the
    same H'."""
    if g.device.type == "cpu":
        if Ht is None:
            return fista_boxqp_reference(H, g, lo, hi, lipschitz, iters, coarse_iters, U0)
        return _fista_loop(H, g, lo, hi, lipschitz, iters, coarse_iters, U0,
                           make_tail_dot(Ht, "highest"))
    device, N, _, d, coarse_iters = _launch_shape(H, g, iters, coarse_iters, n_max=MAX_D)
    Ht = H.T.contiguous() if Ht is None else Ht
    lip = torch.as_tensor(lipschitz, dtype=torch.float32, device=device).reshape(())
    for name, t, shape in (("H'", Ht, (d, d)), ("g", g, (N, d)), ("lipschitz", lip, ())):
        _check_operand(name, t, device, shape)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    U = torch.empty((N, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = _build.library().npt_fista_boxqp(
            Ht.data_ptr(), g.data_ptr(), None if U0 is None else U0.data_ptr(),
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
