"""ADMM box-QP kernels for condensed MPC (port of
numpower_tpu/kernels/boxqp_admm.py ``admm_mpc_pallas_res``, K1,
``admm_boxqp_pallas``, K3a, and ``admm_mpc_pallas``, K1').

The three kernels are one CUDA C++ template in ``csrc/boxqp_admm.cu`` (its
note says what bounds it on the H100 and how the design answers that), each
on the narrow tile (d <= 128) and the wide one (128 < d <= 1024), for any
state dimension n, as the FISTA kernels (kernels/boxqp_fista.py): K1
forms c from x0 and both residuals in the kernel, in one of three loop forms
("s", "zy", "sp") and with c in one of three precision classes; K3a forms c
from a given g and returns (z, y); K1' forms g from x0 and returns (z, y, g).
This module holds the host setup :func:`minv_factor`, the wrappers
:func:`admm_mpc_res`, :func:`admm_boxqp` and :func:`admm_mpc`, and their
plain PyTorch versions :func:`admm_mpc_res_reference`,
:func:`admm_boxqp_reference` and :func:`admm_mpc_reference`, which compute
the same functions with the same bf16 rounding of the coarse-phase operands.
A wrapper takes the plain version for a tensor on the CPU only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels._build import MAX_D
from numpower_tpu_torch.kernels.boxqp_fista import (
    _check_operand, _entry, _launch_shape, _matrix_operand, _wide_operand,
)
from numpower_tpu_torch.kernels.precision import bf16_round, make_tail_dot, precision_code

# K1's loop forms (their codes in csrc/boxqp_admm.cu) and the precision
# classes of its c, the JAX package's value sets (boxqp_admm.py:321, :369)
FORMS = {"s": 0, "zy": 1, "sp": 2}
C_PRECISIONS = ("bf16x4", "bf16x3", "highest")


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


def _admm_folds(H, SxT, SuTQT, rho, Minv: Optional[torch.Tensor] = None) -> tuple:
    """The host-side operands of the fused ADMM kernel, which depend on the
    QP and rho alone: ((rho Minv)', Wc, (rho Minv)' split) with ((rho
    Minv)', Wc) of :func:`_fold` on a float32 rho, each contiguous, as
    :func:`admm_mpc_res` forms them, and the wide tile's operand of (rho
    Minv)' on the card past d = 128 (boxqp_fista._wide_operand; None
    otherwise). A caller that solves one QP many times
    (models/mpc.MPCController) forms them once and hands them to
    :func:`_admm_mpc_res`."""
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=H.device).reshape(())
    rminvT, Wc = _fold(H, SxT, SuTQT, rho_t, Minv)
    rminvT = rminvT.contiguous()
    return rminvT, Wc.contiguous(), _wide_operand(rminvT) if rminvT.is_cuda else None


def _form_code(form: str) -> int:
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r} ({'|'.join(FORMS)})")
    return FORMS[form]


def _admm_loop(c, rminvT, lo, hi, alpha, iters: int, coarse_iters: int, U0, tail_dot,
               form: str = "s"):
    """The iteration of the kernels from z0 = clip(U0) (clip(0) cold), the
    first ``coarse_iters`` products with both operands rounded to bf16, the
    tail's by ``tail_dot(t)``, in one of K1's loop forms (the same recursion,
    grouped three ways):

    "s":  p = clip(s), t = 2p - s, u = t @ (rho Minv)', s += alpha (u - c - p);
    "sp": the same with a = s - alpha c - alpha p formed before the product
          and s' = a + alpha u after it;
    "zy": z, y = z0, 0; t = z - y, x = t @ (rho Minv)' - c,
          x_r = alpha x + (1 - alpha) z, z' = clip(x_r + y), y += x_r - z'.

    Returns the final pre-projection state s (z + y for "zy")."""
    _form_code(form)
    coarse_iters = min(coarse_iters, iters)
    rminvT_coarse = bf16_round(rminvT)

    def product(t, k):
        return bf16_round(t) @ rminvT_coarse if k < coarse_iters else tail_dot(t)

    s = torch.clamp(torch.zeros_like(c) if U0 is None else U0, lo, hi)
    if form == "zy":
        z, y = s, torch.zeros_like(s)
        for k in range(iters):
            x_r = alpha * (product(z - y, k) - c) + (1.0 - alpha) * z
            z_new = torch.clamp(x_r + y, lo, hi)
            y = y + x_r - z_new
            z = z_new
        return z + y
    for k in range(iters):
        p = torch.clamp(s, lo, hi)
        t = 2.0 * p - s
        if form == "sp":
            a = s - alpha * c - alpha * p
            s = a + alpha * product(t, k)
        else:
            s = s + alpha * (product(t, k) - c - p)
    return s


def admm_mpc_res_reference(H, SxT, SuTQT, x0s, lo: float, hi: float, rho,
                           iters: int = 40, coarse_iters: int = 0,
                           over_relax: float = 1.6,
                           Minv: Optional[torch.Tensor] = None,
                           U0: Optional[torch.Tensor] = None, form: str = "s",
                           c_precision: str = "highest"):
    """Plain PyTorch version of the kernel: returns (z (N, d), r_primal,
    r_dual).

    c = x0s @ Wc in the class ``c_precision``, s = clip(U0) (clip(0) cold),
    then the iteration of ``form`` (:func:`_admm_loop`), whose first
    ``coarse_iters`` products round both operands to bf16. Residuals come
    from one more fp32 x-update at the final (z, y = s - z), as maxima over
    the N x d entries. Works in the dtype of its inputs."""
    return _admm_mpc_res_plain(*_fold(H, SxT, SuTQT, rho, Minv), x0s, lo, hi, rho, iters,
                               coarse_iters, over_relax, U0, form, c_precision)


def _admm_mpc_res_plain(rminvT, Wc, x0s, lo: float, hi: float, rho, iters: int,
                        coarse_iters: int, over_relax: float, U0, form: str, c_precision: str):
    """:func:`admm_mpc_res_reference` on the kernel's host-side operands
    ((rho Minv)', Wc) (:func:`_fold`)."""
    precision_code(c_precision, C_PRECISIONS, "c_precision")
    alpha = over_relax
    c = make_tail_dot(Wc, c_precision)(x0s)
    s = _admm_loop(c, rminvT, lo, hi, alpha, iters, coarse_iters, U0,
                   make_tail_dot(rminvT, "highest"), form)
    z = torch.clamp(s, lo, hi)
    x = (2.0 * z - s) @ rminvT - c
    z_next = torch.clamp(s + alpha * (x - z), lo, hi)
    r_primal = torch.abs(x - z).max()
    r_dual = rho * torch.abs(z_next - z).max()
    return z, r_primal, r_dual


def admm_mpc_res(H, SxT, SuTQT, x0s, lo: float, hi: float, rho,
                 iters: int = 40, coarse_iters: int = 0, over_relax: float = 1.6,
                 Minv: Optional[torch.Tensor] = None,
                 U0: Optional[torch.Tensor] = None, form: str = "s",
                 c_precision: str = "highest"):
    """Fused ADMM MPC solve: returns (z (N, d), r_primal, r_dual).

    H (d, d); SxT (n, T n) = Sx'; SuTQT (T n, d) = (Su' Qbar)'; x0s (N, n);
    rho a scalar tensor (or float); Minv = (H + rho I)^{-1}, factored here
    when None; U0 (N, d) warm start, clipped. The folds (rho Minv)' and
    Wc = Sx'(Su'Q)'Minv' are host-side matmuls; c = x0s @ Wc, the whole
    iteration loop and both residuals run in the kernel. form ("s" | "zy" |
    "sp") is the loop form, c_precision ("bf16x4" | "bf16x3" | "highest")
    the class of c (kernels/precision.py); the port's default is "highest",
    where the JAX package's is "bf16x4". On a CPU tensor this is
    :func:`admm_mpc_res_reference`. Each kernel launch adds one to
    ``admm_mpc_res.launches``; one recorded into a CUDA graph does not (its
    replays run it, models/mpc.py)."""
    return _admm_mpc_res(H, SxT, SuTQT, x0s, lo, hi, rho, iters, coarse_iters, over_relax, Minv,
                         U0, form, c_precision, None)


def _admm_mpc_res(H, SxT, SuTQT, x0s, lo: float, hi: float, rho, iters: int,
                  coarse_iters: int, over_relax: float, Minv, U0, form: str, c_precision: str,
                  folds: Optional[tuple]):
    """:func:`admm_mpc_res` with its QP-only operands given: ``folds`` =
    ((rho Minv)', Wc, (rho Minv)' split) of :func:`_admm_folds` for this rho
    and Minv, formed here when None. On a CPU tensor the plain version runs
    on the same ((rho Minv)', Wc)."""
    form_code = _form_code(form)
    c_code = precision_code(c_precision, C_PRECISIONS, "c_precision")
    if x0s.device.type == "cpu":
        if folds is None:
            return admm_mpc_res_reference(H, SxT, SuTQT, x0s, lo, hi, rho, iters,
                                          coarse_iters, over_relax, Minv, U0, form, c_precision)
        return _admm_mpc_res_plain(*folds[:2], x0s, lo, hi, rho, iters, coarse_iters,
                                   over_relax, U0, form, c_precision)
    device, N, n, d, coarse_iters = _launch_shape(H, x0s, iters, coarse_iters)
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=device).reshape(())
    rminvT, Wc, wide = _admm_folds(H, SxT, SuTQT, rho_t, Minv) if folds is None else folds
    mat = _matrix_operand("(rho Minv)'", rminvT, wide, device, d)
    for name, t, shape in (("Wc", Wc, (n, d)), ("x0s", x0s, (N, n)), ("rho", rho_t, ())):
        _check_operand(name, t, device, shape)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    z = torch.empty((N, d), dtype=torch.float32, device=device)
    rp = torch.zeros((), dtype=torch.float32, device=device)
    rd = torch.zeros((), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        code = _entry("npt_admm_mpc_res", d)(
            mat.data_ptr(), Wc.data_ptr(), x0s.data_ptr(),
            None if U0 is None else U0.data_ptr(), rho_t.data_ptr(),
            z.data_ptr(), rp.data_ptr(), rd.data_ptr(), N, n, d, iters,
            coarse_iters, ctypes.c_float(float(lo)), ctypes.c_float(float(hi)),
            ctypes.c_float(float(over_relax)), form_code, c_code, stream)
    _build.check(code, "admm_mpc_res kernel launch")
    if not capturing:  # a launch recorded into a CUDA graph runs on its replays
        admm_mpc_res.launches += 1
    return z, rp, rd


admm_mpc_res.launches = 0


def admm_boxqp_reference(H, g, lo: float, hi: float, rho, iters: int = 30,
                         coarse_iters: int = 0, over_relax: float = 1.6,
                         U0: Optional[torch.Tensor] = None,
                         Minv: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the two-step kernel: returns (z, y), both
    (N, d), from g (N, d).

    c = (g @ (rho Minv)') * (1 / rho), then the s-form loop from
    s = clip(U0) (clip(0) cold); z = clip(s), y = s - z. Minv =
    (H + rho I)^{-1}, factored here when None. Works in the dtype of its
    inputs."""
    if Minv is None:
        Minv = minv_factor(H, rho)
    rminvT = rho * Minv.T
    c = (g @ rminvT) * (1.0 / rho)
    s = _admm_loop(c, rminvT, lo, hi, over_relax, iters, coarse_iters, U0,
                   make_tail_dot(rminvT, "highest"))
    z = torch.clamp(s, lo, hi)
    return z, s - z


def admm_boxqp(H, g, lo: float, hi: float, rho, iters: int = 30, coarse_iters: int = 0,
               over_relax: float = 1.6, U0: Optional[torch.Tensor] = None,
               Minv: Optional[torch.Tensor] = None):
    """Two-step ADMM box-QP solve: argmin_U 1/2 U'HU + g_i'U, lo <= U <= hi,
    for each row g_i of g (N, d); returns (z, y), the feasible iterate and
    the scaled dual, both (N, d).

    H (d, d); rho a scalar tensor (or float); U0 (N, d) warm start of z,
    clipped; Minv = (H + rho I)^{-1}, factored here when None (pass it to
    share the factorization with the caller's residuals). The fold
    (rho Minv)' is a host-side product; c, the whole iteration loop and y
    run in the kernel. On a CPU tensor this is :func:`admm_boxqp_reference`.
    Each kernel launch adds one to ``admm_boxqp.launches``."""
    if g.device.type == "cpu":
        return admm_boxqp_reference(H, g, lo, hi, rho, iters, coarse_iters, over_relax,
                                    U0, Minv)
    device, N, _, d, coarse_iters = _launch_shape(H, g, iters, coarse_iters)
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=device).reshape(())
    if Minv is None:
        Minv = minv_factor(H, rho_t)
    mat = _matrix_operand("(rho Minv)'", (rho_t * Minv.T).contiguous(), None, device, d)
    for name, t, shape in (("g", g, (N, d)), ("rho", rho_t, ())):
        _check_operand(name, t, device, shape)
    if U0 is not None:
        _check_operand("U0", U0, device, (N, d))
    z = torch.empty((N, d), dtype=torch.float32, device=device)
    y = torch.empty((N, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _entry("npt_admm_boxqp", d)(
            mat.data_ptr(), g.data_ptr(), None if U0 is None else U0.data_ptr(),
            rho_t.data_ptr(), z.data_ptr(), y.data_ptr(), N, d, iters, coarse_iters,
            ctypes.c_float(float(lo)), ctypes.c_float(float(hi)),
            ctypes.c_float(float(over_relax)), stream)
    _build.check(code, "admm_boxqp kernel launch")
    admm_boxqp.launches += 1
    return z, y


admm_boxqp.launches = 0


def admm_mpc_reference(H, SxT, SuTQT, x0s, lo: float, hi: float, rho, iters: int = 40,
                       coarse_iters: int = 0, over_relax: float = 1.6,
                       Minv: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K1': returns (z, y, g), each (N, d).

    g = x0s @ (SxT @ SuTQT), then :func:`admm_boxqp_reference` on that g
    from a cold start at clip(0): K1' is K3a on the g it forms. Works in the
    dtype of its inputs."""
    g = x0s @ (SxT @ SuTQT)
    z, y = admm_boxqp_reference(H, g, lo, hi, rho, iters, coarse_iters, over_relax, None, Minv)
    return z, y, g


def admm_mpc(H, SxT, SuTQT, x0s, lo: float, hi: float, rho, iters: int = 40,
             coarse_iters: int = 0, over_relax: float = 1.6,
             Minv: Optional[torch.Tensor] = None):
    """ADMM MPC solve with g formed in the kernel (K1'): returns (z, y, g),
    each (N, d): the feasible iterate, the scaled dual and g = x0s @ W,
    from a cold start at clip(0) and with no residuals.

    Operands as :func:`admm_mpc_res`. The folds (rho Minv)' and
    W = Sx'(Su'Q)' are host-side matmuls; g, c = (g @ (rho Minv)') / rho,
    the loop and y run in the kernel, in fp32. The caller forms the
    residuals from (z, y, g), as the JAX package's callers do. On a CPU
    tensor this is :func:`admm_mpc_reference`. Each kernel launch adds one
    to ``admm_mpc.launches``."""
    if x0s.device.type == "cpu":
        return admm_mpc_reference(H, SxT, SuTQT, x0s, lo, hi, rho, iters, coarse_iters,
                                  over_relax, Minv)
    device, N, n, d, coarse_iters = _launch_shape(H, x0s, iters, coarse_iters)
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=device).reshape(())
    if Minv is None:
        Minv = minv_factor(H, rho_t)
    mat = _matrix_operand("(rho Minv)'", (rho_t * Minv.T).contiguous(), None, device, d)
    W = (SxT @ SuTQT).contiguous()
    for name, t, shape in (("W", W, (n, d)), ("x0s", x0s, (N, n)), ("rho", rho_t, ())):
        _check_operand(name, t, device, shape)
    z, y, g = (torch.empty((N, d), dtype=torch.float32, device=device) for _ in range(3))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _entry("npt_admm_mpc", d)(
            mat.data_ptr(), W.data_ptr(), x0s.data_ptr(), rho_t.data_ptr(), z.data_ptr(),
            y.data_ptr(), g.data_ptr(), N, n, d, iters, coarse_iters,
            ctypes.c_float(float(lo)), ctypes.c_float(float(hi)),
            ctypes.c_float(float(over_relax)), stream)
    _build.check(code, "admm_mpc kernel launch")
    admm_mpc.launches += 1
    return z, y, g


admm_mpc.launches = 0


# -- the JAX package's names (numpower_tpu/kernels/boxqp_admm.py) -------------
# Each takes the JAX function's operands in its order and returns its results
# in its layout. tile_n and interpret have no effect: the operands' device
# chooses the route, the kernel on a CUDA tensor and its plain version on a
# CPU one. c_precision keeps the port's default, "highest".


def admm_mpc_pallas_res(H, SxT, SuTQT, x0s, lo, hi, rho, iters: int = 40,
                        coarse_iters: int = 0, over_relax: float = 1.6, tile_n: int = 1024,
                        interpret: bool = False, Minv: Optional[torch.Tensor] = None,
                        U0: Optional[torch.Tensor] = None, form: str = "s",
                        c_precision: str = "highest"):
    """K1 by the JAX package's name: :func:`admm_mpc_res`, (z, r_primal, r_dual)."""
    del tile_n, interpret
    return admm_mpc_res(H, SxT, SuTQT, x0s, lo, hi, rho, iters, coarse_iters, over_relax, Minv,
                        U0, form, c_precision)


def admm_boxqp_pallas(H, g, lo, hi, rho, iters: int = 30, coarse_iters: int = 0,
                      over_relax: float = 1.6, tile_n: int = 1024, interpret: bool = False,
                      U0: Optional[torch.Tensor] = None, Minv: Optional[torch.Tensor] = None):
    """K3a by the JAX package's name: :func:`admm_boxqp`, (z, y)."""
    del tile_n, interpret
    return admm_boxqp(H, g, lo, hi, rho, iters, coarse_iters, over_relax, U0, Minv)


def admm_mpc_pallas(H, SxT, SuTQT, x0s, lo, hi, rho, iters: int = 40, coarse_iters: int = 0,
                    over_relax: float = 1.6, tile_n: int = 1024, interpret: bool = False,
                    Minv: Optional[torch.Tensor] = None):
    """K1' by the JAX package's name: :func:`admm_mpc`, (z, y, g)."""
    del tile_n, interpret
    return admm_mpc(H, SxT, SuTQT, x0s, lo, hi, rho, iters, coarse_iters, over_relax, Minv)
