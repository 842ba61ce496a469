"""Fused iLQR forward line search (K8; port of
numpower_tpu/kernels/ilqr_forward.py ``ilqr_forward_pallas``).

The kernel is CUDA C++ in ``csrc/ilqr_forward.cu`` (its note says what bounds
it on the H100 and how the design answers that): one thread per (alpha,
scenario), the state in registers, the registered plant's device function
(``csrc/plants.cuh``) in the kernel, the nominal rows staged ahead in chunks
by bulk asynchronous copies for a block's alphas, the outputs written back
chunk by chunk. This module holds its wrapper, :func:`ilqr_forward_fused`, and its plain
PyTorch version, :func:`ilqr_forward_reference`: the closed-loop rollout of
models/ilqr._forward_pass over all alphas at once and the cost of
models/ilqr._total_cost. The wrapper takes the plain version for a tensor on
the CPU only (any plant); for a CUDA tensor it launches the kernel or raises,
and a plant that is not registered raises ValueError.

Layout: the natural one, x0s (N, n), xs_nom (N, T+1, n), us_nom (N, T, m),
ks (N, T, m), Ks (N, T, m, n) -> us (A, N, T, m), xs (A, N, T+1, n),
costs (A, N). (The JAX wrapper's lane-major (T, ., N) layout was for TPU
lanes; its callers transpose it away.)
"""

from __future__ import annotations

import ctypes

import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand

MAX_ALPHAS = 32  # csrc/ilqr_forward.cu kMaxAlphas: one warp per alpha


def ilqr_forward_reference(f, Q, R, QF, x_goal, alphas, x0s, xs_nom, us_nom, ks, Ks):
    """Plain PyTorch version of the kernel: the same arguments and results as
    :func:`ilqr_forward_fused`, for any plant f. Works in x0s's dtype."""
    from numpower_tpu_torch.models.ilqr import _forward_pass, _total_cost

    alphas = torch.as_tensor(alphas, dtype=x0s.dtype, device=x0s.device)
    us, xs = _forward_pass(f, x0s, xs_nom, us_nom, ks, Ks, alphas[:, None, None])
    return us, xs, _total_cost(xs, us, Q, R, QF, x_goal)


def ilqr_forward_fused(f, Q, R, QF, x_goal, alphas, x0s, xs_nom, us_nom, ks, Ks):
    """Closed-loop line-search rollouts u = u_nom + alpha k + K (x - x_nom)
    of every alpha (A,) for every scenario, with quadratic costs.

    f a registered plant (models/plants.kernel_plant) or a partial of one;
    Q (n, n), R (m, m), QF (n, n) symmetric, x_goal (n,) and alphas (A,)
    tensors (pass them on the device: a host array would be copied, and
    waited for, at every call); x0s (N, n); xs_nom (N, T+1, n) or
    (N, T, n); us_nom, ks (N, T, m); Ks (N, T, m, n). Returns us
    (A, N, T, m), xs (A, N, T+1, n), costs (A, N).

    On a CPU tensor this is :func:`ilqr_forward_reference`. Each kernel
    launch adds one to ``ilqr_forward_fused.launches``."""
    if x0s.device.type == "cpu":
        return ilqr_forward_reference(f, Q, R, QF, x_goal, alphas, x0s, xs_nom, us_nom, ks, Ks)
    from numpower_tpu_torch.models.plants import MAX_PLANT_PARAMS, kernel_plant

    plant = kernel_plant(f)
    if plant is None:
        raise ValueError(f"plant {f!r} is not registered for the kernel "
                         "(numpower_tpu_torch.models.plants.kernel_plant); "
                         "use forward='plain' to roll it out in PyTorch")
    device = x0s.device
    N, n = x0s.shape
    T, m = us_nom.shape[1], us_nom.shape[2]
    if (n, m) != (plant.n, plant.m):
        raise ValueError(f"the plant is ({plant.n}, {plant.m}), the operands ({n}, {m})")
    to_dev = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()  # noqa: E731
    Q, R, QF, x_goal, alphas = (to_dev(x) for x in (Q, R, QF, x_goal, alphas))
    A = alphas.shape[0]
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"{A} alphas: the kernel takes 1..{MAX_ALPHAS}")
    xs_rows = xs_nom.shape[1]
    for name, t, shape in (("Q", Q, (n, n)), ("R", R, (m, m)), ("QF", QF, (n, n)),
                           ("x_goal", x_goal, (n,)), ("alphas", alphas, (A,)),
                           ("x0s", x0s, (N, n)), ("xs_nom", xs_nom, (N, max(xs_rows, T), n)),
                           ("us_nom", us_nom, (N, T, m)), ("ks", ks, (N, T, m)),
                           ("Ks", Ks, (N, T, m, n))):
        _check_operand(name, t, device, shape)
    params = list(plant.params) + [0.0] * (MAX_PLANT_PARAMS - len(plant.params))
    us = torch.empty((A, N, T, m), dtype=torch.float32, device=device)
    xs = torch.empty((A, N, T + 1, n), dtype=torch.float32, device=device)
    costs = torch.empty((A, N), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = _build.library().npt_ilqr_forward(
            plant.plant_id, *(ctypes.c_float(p) for p in params), Q.data_ptr(), R.data_ptr(),
            QF.data_ptr(), x_goal.data_ptr(), alphas.data_ptr(), x0s.data_ptr(),
            xs_nom.data_ptr(), us_nom.data_ptr(), ks.data_ptr(), Ks.data_ptr(), us.data_ptr(),
            xs.data_ptr(), costs.data_ptr(), N, T, A, xs_rows, stream)
    _build.check(code, "ilqr_forward_fused kernel launch")
    ilqr_forward_fused.launches += 1
    return us, xs, costs


ilqr_forward_fused.launches = 0
