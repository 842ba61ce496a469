"""Fused per-scenario backward Riccati kernel (K5; port of
numpower_tpu/kernels/riccati.py ``riccati_batched_fused``).

The kernel is CUDA C++ in two forms, each with a note on what bounds it on
the H100 and how the design answers that: ``csrc/riccati.cu`` for n <= 16
and m <= 8 (16 lanes per scenario, 32 where n + m > 16, lane c owning column
c of [A | B] in registers), and ``csrc/riccati_wide.cu`` past that, up to
n = m = 48 (one block a scenario, a thread per column of [A | B], P, [A | B],
B'PA and S in shared memory, S factored by one warp); both read P by rows as
16-byte broadcasts and run the whole T loop in one launch. This module holds
the wrapper, :func:`riccati_batched_fused`, and its plain PyTorch version,
:func:`riccati_batched_reference`, which is also the loop of
models/lqr.riccati_scan_per_scenario's "plain" and "psd" routes. The wrapper
takes the plain version for a tensor on the CPU only; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand
from numpower_tpu_torch.utils.smallmat import psd_solve_unrolled

# The narrow form's envelope (csrc/riccati.cu kMaxN, kMaxM): a scenario's rows
# fit its 16 lanes and S's factor a lane's registers. It covers every plant in
# the repo (quadrotor 12/4, planar quadrotor 6/2, cartpole 4/1, unicycle 3/2,
# pendulum and double integrator 2/1). Past it the wide form
# (csrc/riccati_wide.cu kWideMaxN, kWideMaxM) takes n <= 48 and m <= 48: the
# JAX package's "auto" takes its kernel for n <= 48 (models/lqr.py), and a
# block's P, [A | B], B'PA and S fit the 48 KB of a plain launch there.
NARROW_N = 16
NARROW_M = 8
MAX_N = 48
MAX_M = 48


def _entry(N: int, n: int, m: int, horizon: int) -> str:
    """The library function that launches the kernel for this shape: the
    narrow form inside its envelope, the wide one past it; ValueError
    outside both."""
    if not (N >= 1 and 1 <= n <= MAX_N and 1 <= m <= MAX_M and horizon >= 0):
        raise ValueError(f"(N, n, m, T) = ({N}, {n}, {m}, {horizon}) is outside the kernel's "
                         f"envelope: N >= 1, n <= {MAX_N}, m <= {MAX_M}, T >= 0")
    if n <= NARROW_N and m <= NARROW_M:
        return "npt_riccati_fused"
    return "npt_riccati_fused_wide"


def riccati_batched_reference(As, Bs, Q, R, QF, horizon: int, spd_solve=psd_solve_unrolled):
    """Plain PyTorch version of the kernel: As (N, n, n), Bs (N, n, m), shared
    Q (n, n), R (m, m), QF (n, n) -> Ks (N, T, m, n) in forward time, P0
    (N, n, n). Per backward step, batched over the scenarios:

        S = R + B'PB;  K = spd_solve(sym(S), B'PA);  P' = sym(Q + A'PA - (B'PA)'K)

    spd_solve(S, rhs) solves the (N, m, m) x (N, m, n) SPD systems. Works in
    As's dtype and device (float64 for a reference run)."""
    N, n, _ = As.shape
    m = Bs.shape[-1]
    Q, R, QF = (torch.as_tensor(x, dtype=As.dtype, device=As.device) for x in (Q, R, QF))
    Ks = torch.empty((N, horizon, m, n), dtype=As.dtype, device=As.device)
    P = QF.expand(N, n, n)
    Bt, At = Bs.transpose(1, 2), As.transpose(1, 2)
    for t in range(horizon - 1, -1, -1):
        BtP = Bt @ P
        S = R + BtP @ Bs
        BtPA = BtP @ As
        K = spd_solve(0.5 * (S + S.transpose(1, 2)), BtPA)
        P_new = Q + At @ P @ As - BtPA.transpose(1, 2) @ K
        P = 0.5 * (P_new + P_new.transpose(1, 2))
        Ks[:, t] = K
    return Ks, P.contiguous()


def riccati_batched_fused(As, Bs, Q, R, QF, horizon: int, tile_b: int = 4096,
                          interpret: bool = False):
    """Fused per-scenario Riccati: As (N, n, n), Bs (N, n, m), shared Q, R,
    QF -> (Ks (N, T, m, n), P0 (N, n, n)), the kernel writing both in this
    layout. Bs may be a broadcast view (it is made contiguous); Q, R, QF may
    be numpy arrays or tensors anywhere (they are copied to As's device as
    fp32). Envelope: n <= MAX_N, m <= MAX_M (ValueError beyond); the narrow
    form runs n <= NARROW_N with m <= NARROW_M, the wide form the rest.
    On a CPU tensor this is :func:`riccati_batched_reference`. Each kernel
    launch adds one to ``riccati_batched_fused.launches``. tile_b and
    interpret are the JAX package's arguments and have no effect: As's
    device chooses the route."""
    del tile_b, interpret
    if As.device.type == "cpu":
        return riccati_batched_reference(As, Bs, Q, R, QF, horizon)
    device = As.device
    N, n = As.shape[0], As.shape[-1]
    m = Bs.shape[-1]
    entry = _entry(N, n, m, horizon)
    As, Bs = As.contiguous(), Bs.contiguous()  # a broadcast Bs is copied
    Q, R, QF = (torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
                for x in (Q, R, QF))
    for name, t, shape in (("As", As, (N, n, n)), ("Bs", Bs, (N, n, m)), ("Q", Q, (n, n)),
                           ("R", R, (m, m)), ("QF", QF, (n, n))):
        _check_operand(name, t, device, shape)
    Ks = torch.empty((N, horizon, m, n), dtype=torch.float32, device=device)
    P0 = torch.empty((N, n, n), dtype=torch.float32, device=device)
    code = _build.launch(entry, device, As.data_ptr(), Bs.data_ptr(), Q.data_ptr(),
                         R.data_ptr(), QF.data_ptr(), Ks.data_ptr(), P0.data_ptr(), N, n, m,
                         horizon)
    _build.check(code, "riccati_batched_fused kernel launch")
    riccati_batched_fused.launches += 1
    return Ks, P0


riccati_batched_fused.launches = 0
