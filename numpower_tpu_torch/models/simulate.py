"""Closed-loop simulation: plant + estimator + controller (port of
numpower_tpu/models/simulate.py).

The glue a deployment needs around the solver and estimator families:

    per tick t:   u_t     = controller(ctrl_state, x_hat_t, t)
                  x_{t+1} = f(x_t, u_t) + w_t              [process noise]
                  y_{t+1} = h(x_{t+1}) + v_t               [measurement]
                  x_hat   = estimator(est_state, y_{t+1}, u_t)

N closed loops run side by side: every callback and the plant take the
(N, .) batch at once, so a tick is a fixed number of launches whatever N is.
The noise comes from a torch.Generator (reproducible from its seed), drawn on
the states' device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from numpower_tpu_torch.models.estimation import _filter_step
from numpower_tpu_torch.utils.device import follow, seeded_generator, state_tensor


class SimResult(NamedTuple):
    xs: torch.Tensor                 # (steps+1, N, n) true states
    us: torch.Tensor                 # (steps, N, m) applied controls
    ys: Optional[torch.Tensor]       # (steps, N, p) measurements (None if h is None)
    xhats: Optional[torch.Tensor]    # (steps, N, n) estimates (None if estimator is None)


def simulate_closed_loop(
    f: Callable,              # f(x (N, n), u (N, m)) -> x_next (N, n)
    controller: Callable,     # (ctrl_state, x (N, n), t) -> (u (N, m), ctrl_state)
    ctrl_state0,
    x0s: torch.Tensor,        # (N, n) true initial states
    steps: int,
    generator: Optional[torch.Generator] = None,
    w_std=0.0,                # process noise std (scalar or (n,))
    h: Optional[Callable] = None,   # h(x (N, n)) -> y (N, p)
    v_std=0.0,                # measurement noise std (scalar or (p,))
    estimator: Optional[Callable] = None,
    # (est_state, y (N, p), u_prev (N, m)) -> (xhat (N, n), est_state)
    est_state0=None,
    xhat0: Optional[torch.Tensor] = None,  # initial estimates (default: x0s)
    *,
    key: Optional[torch.Generator] = None,  # the JAX package's name of generator
) -> SimResult:
    """Run N closed loops for `steps` ticks.

    With estimator=None the controller sees the true state (full-state
    feedback); with an estimator it sees x_hat (output feedback). generator
    drives the noise (default: a generator seeded 0 on x0s's device); per
    tick it draws the process noise, then the measurement noise. f and h take
    the whole batch (the house style of models/plants.py). A numpy x0s goes
    to the card as float32 (utils.state_tensor); xhat0 follows x0s's device
    and dtype."""
    x0s = state_tensor(x0s)
    (xhat0,) = follow(x0s, xhat0)
    if estimator is not None and h is None:
        raise ValueError("estimator requires a measurement model h "
                         "(the estimator consumes y = h(x) + noise)")
    N, n = x0s.shape
    kw = dict(dtype=x0s.dtype, device=x0s.device)
    generator = seeded_generator(generator, x0s.device, key)
    w_std = torch.as_tensor(w_std, **kw).expand(n)
    v_std = torch.as_tensor(v_std, **kw)
    x, xh = x0s, (x0s if xhat0 is None else xhat0)
    cs, es = ctrl_state0, est_state0
    xs, us, ys, xhats = [x0s], [], [], []
    for t in range(steps):
        u, cs = controller(cs, xh if estimator is not None else x, t)
        x = f(x, u) + w_std * torch.randn((N, n), generator=generator, **kw)
        us.append(u)
        xs.append(x)
        if h is not None:
            y = h(x)
            y = y + v_std * torch.randn(y.shape, generator=generator, **kw)
            ys.append(y)
            if estimator is not None:
                xh, es = estimator(es, y, u)
                xhats.append(xh)
    return SimResult(xs=torch.stack(xs), us=torch.stack(us),
                     ys=torch.stack(ys) if h is not None else None,
                     xhats=torch.stack(xhats) if estimator is not None else None)


def lqr_feedback(u_lo=None, u_hi=None) -> Callable:
    """Static-gain controller callback: u = clip(-K x). The gain K rides the
    ctrl_state (pass ctrl_state0=K, (m, n), on the states' device)."""
    def fn(state, x, t):
        u = -(x @ state.T)
        if u_lo is not None or u_hi is not None:
            u = torch.clamp(u, u_lo, u_hi)
        return u, state

    return fn


def kalman_estimator(A, C, Q, R, P0, B=None):
    """Batched Kalman estimator callback for simulate_closed_loop.

    Returns (make_state, update): make_state(xhat0 (N, n)) builds the state,
    the filter matrices (on xhat0's device and in its dtype) with the (means,
    covariances) of every loop; update consumes one measurement batch per
    tick (estimation._filter_step, batched over the loops). A numpy xhat0
    goes to the card as float32 (utils.state_tensor)."""

    def make_state(xhat0: torch.Tensor):
        xhat0 = state_tensor(xhat0)
        kw = dict(dtype=xhat0.dtype, device=xhat0.device)
        A_, C_, Q_, R_, P0_ = (torch.as_tensor(M, **kw) for M in (A, C, Q, R, P0))
        B_ = None if B is None else torch.as_tensor(B, **kw)
        N, n = xhat0.shape
        return ((A_, C_, Q_, R_, B_), (xhat0, P0_.expand(N, n, n)))

    def update(state, y, u_prev):
        (A_, C_, Q_, R_, B_), (xh, P) = state
        u_term = u_prev @ B_.T if B_ is not None else torch.zeros_like(xh)
        x_f, P_f, _, _, _ = _filter_step(A_, C_, Q_, R_, xh, P, y, u_term)
        return x_f, ((A_, C_, Q_, R_, B_), (x_f, P_f))

    return make_state, update
