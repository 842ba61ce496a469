"""MPPI (Model Predictive Path Integral) sampling-based control (port of
numpower_tpu/models/mppi.py).

Algorithm (Williams et al., information-theoretic MPC), per round:
  1. draw K control perturbation sequences eps ~ N(0, sigma^2)
  2. roll out u_nom + eps through the plant (every sample at once)
  3. S_k = trajectory cost + temperature-weighted control coupling
  4. w_k = softmax(-S_k / lambda);  u_nom += sum_k w_k eps_k
  5. repeat `iters` times

Every function here takes leading batch dimensions, the port's replacement
for ``vmap``: the plain route of mppi_solve_batched is the single solve run
on the whole batch (K samples and N scenarios are batch dimensions of one
rollout per step). The kernel route runs the whole batched solve in one
launch of K13 (kernels/mppi.py), wherever the JAX route takes its kernel
(samples % 128 == 0, at any number of samples), up to horizon * m = 32768.

Random numbers. Where the JAX package takes a key, the port takes a
``torch.Generator`` in the same position (default: one seeded 0 on the
states' device). torch cannot reproduce JAX's threefry stream, so the draws
are made apart from the iterations: the public functions draw the
pre-scaled perturbations eps (..., iters, K, T, m) and hand them to a
private core, which tests can hand the JAX package's own draws.

Devices. A numpy state goes to the card as float32 (utils.state_tensor);
every other operand follows the state's device and dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from numpower_tpu_torch.kernels import mppi as mppi_kernel
from numpower_tpu_torch.kernels.mppi import _clip
from numpower_tpu_torch.models.rollout import rollout_nonlinear
from numpower_tpu_torch.utils.device import given_generator, seeded_generator, state_tensor


class MPPIResult(NamedTuple):
    us: torch.Tensor    # (..., T, m) updated nominal control sequence
    xs: torch.Tensor    # (..., T+1, n) rollout of the nominal sequence
    cost: torch.Tensor  # (...) cost of the nominal sequence
    ess: torch.Tensor   # (...) effective sample size of the last weight set (1..K)


def _trajectory_cost(cost_fn, xs, us):
    """cost_fn(x, u, t) summed over the horizon + cost_fn(x_T, None, T)."""
    T = us.shape[-2]
    stage = torch.stack([cost_fn(xs[..., t, :], us[..., t, :], t) for t in range(T)], dim=-1)
    return torch.sum(stage, dim=-1) + cost_fn(xs[..., T, :], None, T)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def quadratic_mppi_cost(Q, R, QF, x_goal):
    """Standard quadratic tracking cost in MPPI's (x, u, t) callback form,
    batched over the leading dimensions of x (..., n) and u (..., m).

    Terminal stages (u is None) use QF. Matches the iLQR objective so the
    two solver families are directly comparable. The matrices (numpy arrays,
    lists or tensors) are read once, here.

    The returned callable carries two more forms of the same cost (and the
    rows form carries both as well):
    ``.kernel``, the tuple (Q, R, QF, x_goal) of float32 numpy arrays that
    K13 reads (kernels/mppi.py), and ``.rows``, the component-rows form of
    the JAX package's ``.rows`` that K13's plain version evaluates: x and u
    are lists of tensors, and the quadratic forms unroll to scalar products
    with zero entries skipped."""
    Qn, Rn, QFn, gn = (_host(M) for M in (Q, R, QF, x_goal))
    cache = {}

    def mats(like):
        key = (like.device, like.dtype)
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(M, dtype=like.dtype, device=like.device)
                               for M in (Qn, Rn, QFn, gn))
        return cache[key]

    def cost_fn(x, u, t):
        Qt, Rt, QFt, g = mats(x)
        dx = x - g
        if u is None:
            return torch.sum((dx @ QFt) * dx, dim=-1)
        return torch.sum((dx @ Qt) * dx, dim=-1) + torch.sum((u @ Rt) * u, dim=-1)

    def rows(x, u, t):
        M = QFn if u is None else Qn
        n = len(x)
        dx = [x[i] - float(gn[i]) for i in range(n)]
        acc = None
        for i in range(n):
            for j in range(n):
                if M[i, j] != 0.0:
                    term = float(M[i, j]) * dx[i] * dx[j]
                    acc = term if acc is None else acc + term
        if u is not None:
            for a in range(len(u)):
                for b in range(len(u)):
                    if Rn[a, b] != 0.0:
                        acc = acc + float(Rn[a, b]) * u[a] * u[b]
        return acc

    cost_fn.rows = rows
    cost_fn.kernel = tuple(M.astype(np.float32) for M in (Qn, Rn, QFn, gn))
    # the rows form is a cost of its own for K13 (kernels/mppi.mppi_pallas takes
    # it, as the JAX kernel does): it carries both forms too
    rows.rows, rows.kernel = rows, cost_fn.kernel
    return cost_fn


def _input_dim(m, us_init) -> int:
    if m is None:
        if us_init is None:
            raise ValueError("pass m= (input dim) or us_init")
        m = us_init.shape[-1]
    return m


def _mppi_core(f, x0, cost_fn, eps, lam=1.0, sigma=1.0, u_lo=None, u_hi=None, us_init=None,
               baseline_mix=0.0) -> MPPIResult:
    """The iterations of mppi_solve on x0 (..., n) with the pre-scaled
    perturbations eps (..., iters, K, T, m): every leading dimension is an
    independent solve."""
    iters, K, T, m = eps.shape[-4:]
    batch = x0.shape[:-1]
    dt = x0.dtype
    if us_init is None:
        us = torch.zeros(batch + (T, m), dtype=dt, device=x0.device)
    else:
        us = torch.as_tensor(us_init, dtype=dt, device=x0.device).expand(batch + (T, m))
    sigma_arr = torch.as_tensor(np.asarray(mppi_kernel.sigma_tuple(sigma, m), np.float32),
                                dtype=dt, device=x0.device)
    inv_sig2 = 1.0 / (sigma_arr * sigma_arr)
    n_base = int(round(K * baseline_mix))
    x0k = x0[..., None, :].expand(batch + (K, x0.shape[-1]))
    ess = None
    for it in range(iters):
        e = eps[..., it, :, :, :]
        cand = us[..., None, :, :] + e
        if n_base > 0:
            # the first n_base samples explore around zero instead of the nominal
            cand = torch.cat([e[..., :n_base, :, :], cand[..., n_base:, :, :]], dim=-3)
        cand = _clip(cand, u_lo, u_hi)
        eps_eff = cand - us[..., None, :, :]  # clipping-consistent perturbations
        costs = _trajectory_cost(cost_fn, rollout_nonlinear(f, x0k, cand), cand)  # (..., K)
        # information-theoretic control coupling term: lam * u' Sigma^-1 eps
        couple = lam * torch.einsum("...ktm,...tm->...k", eps_eff, inv_sig2 * us)
        w = torch.softmax(-(costs + couple) / lam, dim=-1)
        ess = 1.0 / torch.sum(w * w, dim=-1)
        us = _clip(us + torch.einsum("...k,...ktm->...tm", w, eps_eff), u_lo, u_hi)
    xs = rollout_nonlinear(f, x0, us)
    return MPPIResult(us=us, xs=xs, cost=_trajectory_cost(cost_fn, xs, us), ess=ess)


def mppi_solve(
    f: Callable,
    x0,
    cost_fn: Callable,
    horizon: int,
    generator: Optional[torch.Generator] = None,
    samples: int = 1024,
    iters: int = 8,
    lam: float = 1.0,
    sigma=1.0,
    u_lo: Optional[float] = None,
    u_hi: Optional[float] = None,
    m: Optional[int] = None,
    us_init=None,
    baseline_mix: float = 0.0,
    *,
    key: Optional[torch.Generator] = None,
) -> MPPIResult:
    """Full MPPI solve: `iters` importance-sampled updates of u_nom.

    f(x, u) -> x_next        a plant that indexes the last axis (models/plants)
    cost_fn(x, u, t) -> cost stage cost over the leading dims; u is None at
                             the terminal stage (see quadratic_mppi_cost)
    generator                torch.Generator of the draws (default: seeded 0
                             on x0's device); key= is its JAX name
    lam                      softmax temperature (lower = greedier)
    sigma                    exploration std-dev (scalar or (m,) per input)
    u_lo/u_hi                optional box: samples AND the updated nominal
                             are clipped
    baseline_mix             fraction of samples forced to pure noise around
                             zero (helps escape bad nominals early)

    x0 (n,), or (..., n) for independent solves that share one draw of eps
    per round (mppi_solve_batched draws one per scenario)."""
    x0 = state_tensor(x0)
    m = _input_dim(m, us_init)
    generator = seeded_generator(generator, x0.device, key)
    eps = mppi_kernel.draw_eps(generator, 1, iters, samples, horizon, m, sigma, x0.dtype)[0]
    return _mppi_core(f, x0, cost_fn, eps, lam=lam, sigma=sigma, u_lo=u_lo, u_hi=u_hi,
                      us_init=us_init, baseline_mix=baseline_mix)


def route_mppi(device_type: str, dtype: torch.dtype, cost_fn, samples: int, horizon: int,
               m: int, baseline_mix: float, method: str = "auto") -> str:
    """The route of mppi_solve_batched: "pallas" (K13, kernels/mppi.py) or
    "xla" (the plain batched solve).

    "auto" takes the kernel for a float32 tensor on a CUDA device wherever
    the JAX package's route takes its kernel (samples % 128 == 0, a cost with
    a kernel form, which quadratic_mppi_cost attaches, and baseline_mix == 0;
    numpower_tpu/models/mppi.py:196-212), at any number of samples, up to
    horizon * m <= WIDE_MAX_TM = 32768 nominal entries (the wide K13's
    shared memory, csrc/mppi_wide.cu); "xla" otherwise, a stated route.
    K13 runs its narrow form up to 1024 samples and 1024 entries and its
    wide form past either. The kernel's own wrapper (kernels/mppi.mppi_fused)
    takes any samples >= 1. On the kernel route the plant must be registered
    (models/plants.kernel_plant): for a CUDA tensor the kernel's wrapper
    raises ValueError naming the registry otherwise, so a caller with its own
    plant passes method="xla". An explicit "pallas" raises ValueError where
    the JAX route raises, or past horizon * m = 32768; on a CPU tensor it
    runs the kernel's plain version."""
    if method not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown method {method!r} (auto|pallas|xla)")
    eligible = (hasattr(cost_fn, "kernel") and hasattr(cost_fn, "rows")
                and samples >= 1 and samples % 128 == 0
                and horizon * m <= mppi_kernel.WIDE_MAX_TM and baseline_mix == 0.0)
    if method == "auto":
        return "pallas" if device_type == "cuda" and dtype == torch.float32 and eligible else "xla"
    if method == "pallas" and not eligible:
        raise ValueError(
            "the MPPI kernel route needs cost_fn.kernel and cost_fn.rows (see "
            "quadratic_mppi_cost), samples % 128 == 0, "
            f"horizon * m <= {mppi_kernel.WIDE_MAX_TM} and baseline_mix == 0 "
            f"(got samples={samples}, horizon * m = {horizon * m})")
    return method


def mppi_solve_batched(f, x0s, cost_fn, horizon: int, generator: Optional[torch.Generator] = None,
                       method: str = "auto", eps_stream: str = "exact", *,
                       key: Optional[torch.Generator] = None, **kwargs) -> MPPIResult:
    """Independent solves of the scenarios x0s (N, n), each with its own
    sample stream.

    method (see route_mppi): "xla" is mppi_solve's iterations on the whole
    batch; "pallas" runs the ENTIRE solve (all rounds, their rollouts,
    softmax weights and nominal updates) in one launch of K13
    (kernels/mppi.py). eps_stream (kernel route only): "exact" hands the
    kernel the very perturbations the plain route draws from the same
    generator state, transposed to the kernel's layout, so kernel == plain to
    fp tolerance; "direct" draws them in the kernel's layout in one call (a
    different, statistically equivalent stream). "auto" takes the kernel on
    the card at every samples % 128 == 0 up to horizon * m = 32768 (the
    narrow K13 up to 1024 samples and 1024 entries, the wide one past).
    The perturbations take iters*T*m*N*K floats of device memory (84 MB at
    N = K = 256, T = 40, 8 rounds; 1.3 GB at K = 4096). key is the JAX
    package's name of generator."""
    x0s = state_tensor(x0s)
    if eps_stream not in ("exact", "direct"):
        raise ValueError(f"unknown eps_stream {eps_stream!r} (exact|direct)")
    m = _input_dim(kwargs.get("m"), kwargs.get("us_init"))
    route = route_mppi(x0s.device.type, x0s.dtype, cost_fn, kwargs.get("samples", 1024), horizon,
                       m, kwargs.get("baseline_mix", 0.0), method)
    generator = seeded_generator(generator, x0s.device, key)
    if route == "pallas":
        return _mppi_solve_batched_pallas(f, x0s, cost_fn, horizon, generator,
                                          eps_stream=eps_stream, **kwargs)
    samples, iters = kwargs.pop("samples", 1024), kwargs.pop("iters", 8)
    kwargs.pop("m", None)
    eps = mppi_kernel.draw_eps(generator, x0s.shape[0], iters, samples, horizon, m,
                               kwargs.get("sigma", 1.0), x0s.dtype)
    return _mppi_core(f, x0s, cost_fn, eps, **kwargs)


def _mppi_kernel_core(f, x0s, cost_fn, eps_all, horizon: int, iters: int, m: int, lam=1.0,
                      sigma=1.0, u_lo=None, u_hi=None, us_init=None) -> MPPIResult:
    """The kernel route on the perturbations eps_all (iters*T*m, N, K) in
    kernel layout: one K13 launch (its plain version on a CPU tensor), then
    the nominal rollout and cost."""
    T = horizon
    us0 = (torch.zeros(T * m, dtype=x0s.dtype, device=x0s.device) if us_init is None
           else torch.as_tensor(us_init, dtype=x0s.dtype, device=x0s.device).reshape(T * m))
    us, ess = mppi_kernel.mppi_fused(f, cost_fn, x0s.contiguous(), eps_all, us0, T=T,
                                     iters=iters, m=m, lam=float(lam), sigma=sigma, u_lo=u_lo,
                                     u_hi=u_hi)
    xs = rollout_nonlinear(f, x0s, us)
    return MPPIResult(us=us, xs=xs, cost=_trajectory_cost(cost_fn, xs, us), ess=ess[:, -1])


def _mppi_solve_batched_pallas(f, x0s, cost_fn, horizon, generator, samples=1024, iters=8,
                               lam=1.0, sigma=1.0, u_lo=None, u_hi=None, m=None, us_init=None,
                               baseline_mix=0.0, eps_stream: str = "exact") -> MPPIResult:
    """Kernel route of mppi_solve_batched (same contract)."""
    del baseline_mix  # 0 on this route (route_mppi)
    m = _input_dim(m, us_init)
    layout = (mppi_kernel.eps_kernel_layout if eps_stream == "exact"
              else mppi_kernel.eps_direct_layout)
    eps_all = layout(generator, x0s.shape[0], iters, horizon, m, samples, sigma, x0s.dtype)
    return _mppi_kernel_core(f, x0s, cost_fn, eps_all, horizon, iters, m, lam=lam, sigma=sigma,
                             u_lo=u_lo, u_hi=u_hi, us_init=us_init)


def mppi_step(f, state, x_now, cost_fn, generator: Optional[torch.Generator] = None, *,
              key: Optional[torch.Generator] = None, **kwargs) -> tuple:
    """Receding-horizon tick: re-solve from x_now warm-started with the
    previous plan shifted by one step (the standard MPC warm start). state
    is the previous plan (T, m). Returns (u_apply, result). key is the JAX
    package's name of generator."""
    x_now = state_tensor(x_now)
    us_prev = torch.as_tensor(state, dtype=x_now.dtype, device=x_now.device)
    us_shift = torch.cat([us_prev[1:], us_prev[-1:]], dim=0)
    res = mppi_solve(f, x_now, cost_fn, us_prev.shape[0], given_generator(generator, key),
                     us_init=us_shift, **kwargs)
    return res.us[0], res
