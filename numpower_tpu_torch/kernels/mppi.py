"""Fused whole-solve batched MPPI (K13; port of numpower_tpu/kernels/mppi.py
``mppi_pallas``).

The kernel is CUDA C++ in two forms, each with a note that says what bounds
it on the H100 and how the design answers that. ``csrc/mppi.cu``, the narrow
K13, takes K <= MAX_K = 1024 samples and T*m <= MAX_TM = 1024 nominal
entries: one block per scenario, a thread per sample (up to four per thread
past K = 256), all ``iters`` rounds in one launch, each round a T-step
rollout of every sample through the registered plant's device function
(``csrc/plants.cuh``), the quadratic stage costs, the softmax weights and the
effective sample size (ESS), and the nominal update. ``csrc/mppi_wide.cu``,
the wide K13, takes every other K >= 1 and T*m <= WIDE_MAX_TM = 32768: the
same rounds, a block walking its scenario's samples in tiles
(:func:`wide_plan`). This module holds their wrapper, :func:`mppi_fused`,
which picks the form by size, its plain PyTorch version,
:func:`mppi_fused_reference` (the kernels' formulas on (N, K) tensors), the
host side of a launch (:func:`chunk_plan`, :func:`wide_plan`,
:func:`packed_constants`, :func:`kernel_args`) and the two layouts of the
perturbations the kernel consumes. The wrapper takes the plain version for a
tensor on the CPU only (any plant); for a CUDA tensor it launches a kernel or
raises, and a plant that is not registered raises ValueError.

Layout (the JAX kernel's): x0s (N, n); eps (iters*T*m, N, K), the
perturbations pre-scaled by sigma, row r = (it*T + t)*m + a, each row
contiguous along the K samples; us0 (T*m,) a warm start shared by every
scenario -> us (N, T, m), ess (N, iters).

The cost is a quadratic one (models/mppi.quadratic_mppi_cost): the kernel
reads its ``.kernel`` form (Q, R, QF, x_goal as float arrays) and the plain
version its ``.rows`` form, the JAX package's component-rows callable.

Memory: eps holds iters*T*m*N*K floats, 84 MB at the bench's shape (N = 256,
K = 256, T = 40, m = 1, 8 rounds), 1.3 GB at N = 4096 or at K = 4096; the
"exact" layout draws it in the plain route's order and transposes it, which
holds a second copy for a moment.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from numpower_tpu_torch.kernels import _build
from numpower_tpu_torch.kernels.boxqp_fista import _check_operand

# The narrow K13's envelope; every other size takes the wide one.
MAX_K = 1024   # csrc/mppi.cu kMaxK: one block per scenario, at most 4 samples a thread
MAX_TM = 1024  # csrc/mppi.cu kMaxTM: the nominal in shared memory
# The wide K13 (csrc/mppi_wide.cu checks these): threads a block at most; the
# most nominal entries T*m (128 KB of shared memory).
WIDE_THREADS = 256
WIDE_MAX_TM = 32768
# The narrow kernel's plan (csrc/mppi.cu checks it): threads a block, steps a staged
# chunk, and the bytes of its ring of eps chunks in shared memory when a
# round's slice stays resident (50 KB: the bench's 48 KB, so that four
# blocks share a multiprocessor) and when four slots stream it.
MAX_THREADS = 256
MAX_TC = 8
RESIDENT_BUDGET = 50 * 1024
STREAM_BUDGET = 48 * 1024


@functools.lru_cache(maxsize=None)
def chunk_plan(K: int, T: int, m: int) -> tuple:
    """The launch plan of K13 for K samples, horizon T and m inputs:
    (threads, samples a thread, steps a chunk Tc, chunks a round, resident).
    A thread carries 1 sample up to K = 256, 2 up to 512, else 4. The round's
    slice stays resident in shared memory where its ceil(T/Tc) chunks and
    one more (the next round's first, in flight during the softmax and the
    update) fit RESIDENT_BUDGET, for the largest Tc <= MAX_TC that fits;
    otherwise four slots of the largest Tc that fits STREAM_BUDGET stream
    the chunks, twice a round. A staged row holds a float per sample slot
    (threads * samples a thread)."""
    spt = 1 if K <= 256 else 2 if K <= 512 else 4
    threads = (-(-K // spt) + 31) // 32 * 32
    row = 4 * m * spt * threads  # bytes a step
    for tc in range(min(MAX_TC, T), 0, -1):
        nch = -(-T // tc)
        if (nch + 1) * tc * row <= RESIDENT_BUDGET:
            return threads, spt, tc, nch, True
    tc = min(MAX_TC, T)
    while tc > 1 and 4 * tc * row > STREAM_BUDGET:
        tc -= 1
    return threads, spt, tc, -(-T // tc), False


def is_narrow(K: int, T: int, m: int) -> bool:
    """Whether a launch of K samples, horizon T and m inputs takes the narrow
    K13 (csrc/mppi.cu); every other takes the wide one (csrc/mppi_wide.cu)."""
    return K <= MAX_K and T * m <= MAX_TM


@functools.lru_cache(maxsize=None)
def wide_plan(K: int) -> tuple:
    """The launch plan of the wide K13 for K samples: (threads, samples a
    thread, tiles a round). A block walks its K samples in ceil(K / 1024)
    tiles of equal size but the last, in order, keeping the softmax online
    over them; a thread carries 1 sample of a tile up to 256 a tile, 2 up
    to 512, else 4, and the threads (whole warps, at most WIDE_THREADS)
    cover a tile, whose weights the block holds in shared memory. The
    horizon does not move the plan; kernel_operands checks T*m."""
    tiles = -(-K // (4 * WIDE_THREADS))
    per_tile = -(-K // tiles)
    spt = 1 if per_tile <= 256 else 2 if per_tile <= 512 else 4
    threads = (-(-per_tile // spt) + 31) // 32 * 32
    return threads, spt, -(-K // (threads * spt))


def sigma_tuple(sigma, m: int) -> tuple:
    """The exploration std-dev as m Python floats (a scalar is repeated; an
    array's entries are its float32 values), as the JAX package forms it."""
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.detach().cpu().numpy()
    if isinstance(sigma, (int, float)):
        sig = (float(sigma),)
    else:
        sig = tuple(float(s) for s in np.atleast_1d(np.asarray(sigma, np.float32)))
    if len(sig) == 1 and m > 1:
        sig = sig * m
    if len(sig) != m:
        raise ValueError(f"sigma has {len(sig)} entries for m = {m} inputs")
    return sig


def draw_eps(generator: torch.Generator, N: int, iters: int, K: int, T: int, m: int, sigma,
             dtype=torch.float32) -> torch.Tensor:
    """The perturbations of a batched solve, (N, iters, K, T, m): one normal
    draw from ``generator`` on its device, times sigma (per input)."""
    sig = torch.tensor(sigma_tuple(sigma, m), dtype=dtype, device=generator.device)
    return torch.randn((N, iters, K, T, m), generator=generator, dtype=dtype,
                       device=generator.device) * sig


def _layout_args(generator, key, sigma, sigma_arr, sizes: dict) -> tuple:
    """(generator, sigma) of a layout function called with the port's
    names or the JAX package's (key=, sigma_arr=); TypeError for a missing
    operand or for both names of one."""
    from numpower_tpu_torch.utils.device import given_generator

    generator = given_generator(generator, key)
    if sigma is not None and sigma_arr is not None:
        raise TypeError("pass sigma or sigma_arr, not both")
    sigma = sigma if sigma_arr is None else sigma_arr
    missing = [k for k, v in dict(generator=generator, sigma=sigma, **sizes).items() if v is None]
    if missing:
        raise TypeError(f"missing arguments: {', '.join(missing)}")
    return generator, sigma


def eps_kernel_layout(generator: torch.Generator = None, N: int = None, iters: int = None,
                      T: int = None, m: int = None, K: int = None, sigma=None,
                      dtype=torch.float32, *, key: torch.Generator = None,
                      sigma_arr=None) -> torch.Tensor:
    """The plain batched route's perturbations (:func:`draw_eps`, the same
    draw from the same generator state) laid out (iters*T*m, N, K) for the
    kernel, so that kernel and plain route agree to fp tolerance from one
    seed (the JAX package's "exact" stream). key and sigma_arr are the JAX
    package's names of generator and sigma; every operand is required."""
    generator, sigma = _layout_args(generator, key, sigma, sigma_arr,
                                    dict(N=N, iters=iters, T=T, m=m, K=K))
    eps = draw_eps(generator, N, iters, K, T, m, sigma, dtype)
    return eps.permute(1, 3, 4, 0, 2).reshape(iters * T * m, N, K).contiguous()


def eps_direct_layout(generator: torch.Generator = None, N: int = None, iters: int = None,
                      T: int = None, m: int = None, K: int = None, sigma=None,
                      dtype=torch.float32, *, key: torch.Generator = None,
                      sigma_arr=None) -> torch.Tensor:
    """One normal draw directly in kernel layout (iters*T*m, N, K), scaled by
    sigma per row: no transpose, a different stream from the plain route's
    (statistically equivalent, not element-equal). Arguments as
    :func:`eps_kernel_layout`."""
    generator, sigma = _layout_args(generator, key, sigma, sigma_arr,
                                    dict(N=N, iters=iters, T=T, m=m, K=K))
    R = iters * T * m
    scale = torch.tensor(sigma_tuple(sigma, m) * (iters * T), dtype=dtype,
                         device=generator.device)
    return torch.randn((R, N, K), generator=generator, dtype=dtype,
                       device=generator.device) * scale[:, None, None]


def _clip(u, u_lo, u_hi):
    if u_lo is None and u_hi is None:
        return u
    return torch.clamp(u, u_lo, u_hi)


def mppi_fused_reference(f, cost_rows, x0s, eps_all, us0, *, T: int, iters: int, m: int,
                         lam: float, sigma, u_lo=None, u_hi=None):
    """Plain PyTorch version of the kernel, on (N, K) tensors: the same
    arguments and results as :func:`mppi_fused`, with the cost in its
    component-rows form cost_rows(x_rows, u_rows_or_None, t) (lists of (N, K)
    tensors; models/mppi.quadratic_mppi_cost attaches one as ``.rows``), for
    any plant f that indexes the last axis. Per round: the rollout of every
    candidate u = clip(u_nom + eps), the stage and terminal costs, the
    coupling (cand - u_nom) * (sigma^-2 u_nom) summed over t then a, the
    weights exp(-(S - min S) / lam) normalized, the ESS 1 / sum w^2, and
    u_nom <- clip(u_nom + sum_k w (cand - u_nom)) (kernels/mppi.py:49-105 of
    the JAX package). Works in x0s's dtype and device."""
    _, N, K = eps_all.shape
    n = x0s.shape[1]
    inv_sig2 = tuple(1.0 / (s * s) for s in sigma_tuple(sigma, m))
    us0 = torch.as_tensor(us0, dtype=x0s.dtype, device=x0s.device).reshape(T * m)
    u_nom = [us0[r].expand(N, 1) for r in range(T * m)]
    ess = []
    for it in range(iters):
        x = x0s[:, None, :].expand(N, K, n)
        S = torch.zeros((N, K), dtype=x0s.dtype, device=x0s.device)
        cand = []
        for t in range(T):
            u_rows = [_clip(u_nom[t * m + a] + eps_all[(it * T + t) * m + a], u_lo, u_hi)
                      for a in range(m)]
            cand.append(u_rows)
            S = S + cost_rows(list(x.unbind(-1)), u_rows, t)
            x = f(x, torch.stack(u_rows, dim=-1))
        S = S + cost_rows(list(x.unbind(-1)), None, T)
        couple = None
        for t in range(T):
            for a in range(m):
                term = (cand[t][a] - u_nom[t * m + a]) * (inv_sig2[a] * u_nom[t * m + a])
                couple = term if couple is None else couple + term
        S = S + lam * couple
        Smin = torch.amin(S, dim=1, keepdim=True)
        w = torch.exp(-(S - Smin) * (1.0 / lam))
        w = w / torch.sum(w, dim=1, keepdim=True)
        ess.append(1.0 / torch.sum(w * w, dim=1))
        for t in range(T):
            for a in range(m):
                r = t * m + a
                du = torch.sum(w * (cand[t][a] - u_nom[r]), dim=1, keepdim=True)
                u_nom[r] = _clip(u_nom[r] + du, u_lo, u_hi)
    return torch.cat(u_nom, dim=1).reshape(N, T, m), torch.stack(ess, dim=1)


def packed_constants(cost_fn, sigma, n: int, m: int):
    """Q, R, QF, x_goal and sigma^-2 of a quadratic cost packed in the
    order K13 copies them into its parameters: a host array of float32
    (ctypes), made once per cost and sigma and kept on the cost (its
    ``.kernel`` form is read once, when the cost is made). ValueError for a
    cost without that form or with shapes other than (n, m)."""
    form = getattr(cost_fn, "kernel", None)
    if form is None:
        raise ValueError("the MPPI kernel needs a cost with a kernel form (cost_fn.kernel, "
                         "models/mppi.quadratic_mppi_cost attaches one); use method='xla'")
    key = (sigma_tuple(sigma, m), n, m)
    cache = getattr(cost_fn, "__dict__", {}).setdefault("_k13_constants", {})
    hit = cache.get(key)
    if hit is not None and hit[0] is form:
        return hit[1]
    Q, R, QF, goal = (np.asarray(a, np.float32) for a in form)
    for name, a, shape in (("Q", Q, (n, n)), ("R", R, (m, m)), ("QF", QF, (n, n)),
                           ("x_goal", goal, (n,))):
        if a.shape != shape:
            raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    inv_sig2 = np.array([1.0 / (s * s) for s in key[0]], np.float32)
    packed = np.concatenate([Q.ravel(), R.ravel(), QF.ravel(), goal, inv_sig2])
    consts = (ctypes.c_float * packed.size)(*packed.tolist())
    cache[key] = (form, consts)
    return consts


def kernel_operands(f, cost_fn, x0s, eps_all, us0, *, T: int, iters: int, m: int, sigma):
    """The registered plant, its parameter floats, the packed constants
    (:func:`packed_constants`, on the host), the checked float32 operands
    (x0s, eps, us0) on x0s's device and the empty outputs (us, ess) of a
    launch of K13; ValueError for what the kernel does not take."""
    from numpower_tpu_torch.kernels.ekf import plant_floats
    from numpower_tpu_torch.models.plants import kernel_plant

    plant = kernel_plant(f)
    if plant is None:
        raise ValueError(f"plant {f!r} is not registered for the MPPI kernel "
                         "(numpower_tpu_torch.models.plants.kernel_plant); use method='xla'")
    if getattr(cost_fn, "kernel", None) is None:
        raise ValueError("the MPPI kernel needs a cost with a kernel form (cost_fn.kernel, "
                         "models/mppi.quadratic_mppi_cost attaches one); use method='xla'")
    device = x0s.device
    R_, N, K = eps_all.shape
    n = x0s.shape[1]
    if (n, m) != (plant.n, plant.m):
        raise ValueError(f"the plant is ({plant.n}, {plant.m}), the operands ({n}, {m})")
    if R_ != iters * T * m:
        raise ValueError(f"eps has {R_} rows, expected iters*T*m = {iters * T * m}")
    if K < 1 or T * m > WIDE_MAX_TM or T < 1 or iters < 1:
        raise ValueError(f"K = {K}, T*m = {T * m}: the MPPI kernel takes 1 <= K and "
                         f"T*m <= WIDE_MAX_TM = {WIDE_MAX_TM} (T, iters >= 1)")
    consts = packed_constants(cost_fn, sigma, n, m)
    us0 = torch.as_tensor(us0, dtype=torch.float32, device=device).reshape(T * m).contiguous()
    for name, t, shape in (("x0s", x0s, (N, n)), ("eps", eps_all, (R_, N, K))):
        _check_operand(name, t, device, shape)
    outs = (torch.empty((N, T, m), dtype=torch.float32, device=device),
            torch.empty((N, iters), dtype=torch.float32, device=device))
    return plant, plant_floats(plant), consts, (x0s, eps_all, us0), outs


def kernel_function(K: int, T: int, m: int) -> str:
    """The library function that launches K13 for K samples, horizon T and m
    inputs: ``npt_mppi`` (the narrow form) or ``npt_mppi_wide``."""
    return "npt_mppi" if is_narrow(K, T, m) else "npt_mppi_wide"


def kernel_args(f, cost_fn, x0s, eps_all, us0, *, T: int, iters: int, m: int, sigma,
                lam: float, u_lo=None, u_hi=None) -> tuple:
    """The arguments of one launch of K13 (those of :func:`kernel_function`'s
    function but its stream) and the tensors they point to (x0s, eps, us0,
    us, ess; the outputs last), for the caller to hold while the launch
    runs."""
    plant, floats, consts, ins, outs = kernel_operands(f, cost_fn, x0s, eps_all, us0, T=T,
                                                      iters=iters, m=m, sigma=sigma)
    N, K = eps_all.shape[1:]
    clip = int(u_lo is not None or u_hi is not None)
    lo = -float("inf") if u_lo is None else float(u_lo)
    hi = float("inf") if u_hi is None else float(u_hi)
    head = (plant.plant_id, *floats, ctypes.addressof(consts))
    tail = (N, K, T, iters, float(lam), float(1.0 / lam), clip, lo, hi)
    tensors = (*ins, *outs)
    ptrs = tuple(t.data_ptr() for t in tensors)
    if is_narrow(K, T, m):
        threads, spt, tc, _, resident = chunk_plan(K, T, m)
        return (*head, *ptrs, *tail, threads, spt, tc, int(resident)), tensors
    threads, spt, _ = wide_plan(K)
    return (*head, *ptrs, *tail, threads, spt), tensors


def mppi_fused(f, cost_fn, x0s, eps_all, us0, *, T: int, iters: int, m: int, lam: float,
               sigma, u_lo=None, u_hi=None):
    """Whole-solve batched MPPI in one kernel launch: the narrow K13 for
    K <= MAX_K samples and T*m <= MAX_TM, the wide one for any other K >= 1
    and T*m <= WIDE_MAX_TM (:func:`kernel_function`).

    f a registered plant (models/plants.kernel_plant) or a partial of one;
    cost_fn a quadratic cost with ``.kernel`` and ``.rows`` forms
    (models/mppi.quadratic_mppi_cost); x0s (N, n); eps_all (iters*T*m, N, K)
    pre-scaled perturbations (:func:`eps_kernel_layout`,
    :func:`eps_direct_layout`); us0 (T*m,) the shared warm start (zeros for
    cold); lam the temperature; sigma the std-dev (scalar or per input), here
    only for the coupling's sigma^-2; u_lo/u_hi an optional box on the
    candidates and the nominal. Returns us (N, T, m) and ess (N, iters).

    On a CPU tensor this is :func:`mppi_fused_reference`. Each kernel launch,
    of either form, adds one to ``mppi_fused.launches``."""
    if x0s.device.type == "cpu":
        return mppi_fused_reference(f, cost_fn.rows, x0s, eps_all, us0, T=T, iters=iters, m=m,
                                    lam=lam, sigma=sigma, u_lo=u_lo, u_hi=u_hi)
    args, tensors = kernel_args(f, cost_fn, x0s, eps_all, us0, T=T, iters=iters, m=m,
                                sigma=sigma, lam=lam, u_lo=u_lo, u_hi=u_hi)
    name = kernel_function(eps_all.shape[2], T, m)
    _build.check(_build.launch(name, x0s.device, *args), "mppi_fused kernel launch")
    mppi_fused.launches += 1
    return tensors[-2:]


mppi_fused.launches = 0


def mppi_pallas(f, cost_rows, x0s, eps_all, us0, *, T: int, iters: int, m: int, lam: float,
                sigma, u_lo, u_hi, sc: int = 8, interpret: bool = False):
    """K13 by the JAX package's name (numpower_tpu/kernels/mppi.py):
    :func:`mppi_fused` with the cost in the JAX call's form, the
    component-rows callable (``cost.rows`` of models/mppi.quadratic_mppi_cost,
    which carries the cost's kernel form as ``.kernel`` for the card).
    Returns us (N, T, m), ess (N, iters). sc and interpret have no effect:
    x0s's device chooses the route. As the JAX kernel, it raises ValueError
    unless K = eps_all.shape[2] is a multiple of 128 (:func:`mppi_fused` takes
    any K >= 1), at any K up to T*m <= WIDE_MAX_TM. A rows callable without a kernel form runs the
    plain version on a CPU tensor; on the card :func:`mppi_fused` raises
    ValueError for it."""
    del sc, interpret
    if eps_all.shape[2] % 128 != 0:
        raise ValueError(f"kernel path needs K % 128 == 0, got {eps_all.shape[2]}")
    kw = dict(T=T, iters=iters, m=m, lam=lam, sigma=sigma, u_lo=u_lo, u_hi=u_hi)
    if x0s.device.type == "cpu" and not hasattr(cost_rows, "rows"):
        return mppi_fused_reference(f, cost_rows, x0s, eps_all, us0, **kw)
    return mppi_fused(f, cost_rows, x0s, eps_all, us0, **kw)
