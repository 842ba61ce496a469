"""Random number generation (the port's counterpart of
numpower_tpu/ops/random.py).

Where the JAX functions take a counter-based key, the port takes a
``torch.Generator`` (``key=`` or its alias ``generator=``); ``key(s)`` makes
one seeded with s. Without one, a draw takes the global generator of its
device: one per device, created at the first draw there (not at import,
which would initialise CUDA, as the JAX module keeps its key from
initialising its backend), seeded from the clock unless ``seed(s)`` set the
seed; ``seed(s)`` resets every device's stream to s. Draws land on
``device`` (None: the generator's device, else the card,
``utils.default_device``). The values cannot match jax.random's; the tests
compare distributions, as the JAX package's own tests do.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional, Sequence, Union

import torch

from numpower_tpu_torch.ops.dtypes import canonical, resolve_dtype
from numpower_tpu_torch.utils.config import default_dtype
from numpower_tpu_torch.utils.device import default_device

Shape = Union[int, Sequence[int]]


def _normalize_shape(shape: Shape) -> tuple:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


class _GlobalStreams:
    """One generator per device, created lazily; seed(s) resets them all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seed: Optional[int] = None
        self._generators: dict = {}

    def seed(self, s: int) -> None:
        with self._lock:
            self._seed = int(s)
            self._generators.clear()

    def generator(self, device: torch.device) -> torch.Generator:
        with self._lock:
            g = self._generators.get(device)
            if g is None:
                g = torch.Generator(device=device)
                g.manual_seed(time.time_ns() % (2 ** 31) if self._seed is None else self._seed)
                self._generators[device] = g
            return g


_streams = _GlobalStreams()


def seed(s: int) -> None:
    """Seed the global streams (every device's)."""
    _streams.seed(s)


def key(s: int, device=None) -> torch.Generator:
    """A generator seeded with s on `device` (the card where None), the
    port's counterpart of jax.random.PRNGKey."""
    dev = default_device() if device is None else torch.device(device)
    return torch.Generator(device=dev).manual_seed(int(s))


def _stream(key, generator, device):
    """(generator, device) of one draw: the given generator (key= or
    generator=) or the global one of `device`."""
    g = key if key is not None else generator
    if g is not None:
        dev = g.device if device is None else torch.device(device)
        return g, dev
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _streams.generator(dev), dev


def _dtype(dtype) -> torch.dtype:
    return canonical(resolve_dtype(dtype) or default_dtype())


def uniform(shape: Shape = (), low: float = 0.0, high: float = 1.0, *, key=None, dtype=None,
            generator=None, device=None) -> torch.Tensor:
    """nd::uniform: draws in [low, high)."""
    g, dev = _stream(key, generator, device)
    dt = _dtype(dtype)
    u = torch.rand(_normalize_shape(shape), generator=g, device=dev, dtype=dt)
    return torch.clamp(u * (high - low) + low, min=low)


def normal(shape: Shape = (), loc: float = 0.0, scale: float = 1.0, *, key=None, dtype=None,
           generator=None, device=None) -> torch.Tensor:
    """nd::normal: loc + scale N(0, 1)."""
    return loc + scale * standard_normal(shape, key=key, dtype=dtype, generator=generator,
                                         device=device)


def standard_normal(shape: Shape = (), *, key=None, dtype=None, generator=None,
                    device=None) -> torch.Tensor:
    """nd::standard_normal."""
    g, dev = _stream(key, generator, device)
    return torch.randn(_normalize_shape(shape), generator=g, device=dev, dtype=_dtype(dtype))


def poisson(shape: Shape = (), lam: float = 1.0, *, key=None, dtype=None, generator=None,
            device=None) -> torch.Tensor:
    """nd::poisson: integer counts of rate `lam`, as float32 by default."""
    g, dev = _stream(key, generator, device)
    rate = torch.full(_normalize_shape(shape), float(lam), dtype=torch.float32, device=dev)
    return torch.poisson(rate, generator=g).to(_dtype(dtype))


def random_binomial(shape: Shape = (), n: int = 1, p: float = 0.5, *, key=None, dtype=None,
                    generator=None, device=None) -> torch.Tensor:
    """nd::random_binomial: the number of successes of n Bernoulli(p)
    trials, as float32 by default."""
    g, dev = _stream(key, generator, device)
    shape = _normalize_shape(shape)
    count = torch.full(shape, float(n), dtype=torch.float32, device=dev)
    prob = torch.full(shape, float(p), dtype=torch.float32, device=dev)
    return torch.binomial(count, prob, generator=g).to(_dtype(dtype))


def randint(shape: Shape = (), low: int = 0, high: int = 2, *, key=None, dtype=torch.int32,
            generator=None, device=None) -> torch.Tensor:
    """Integers in [low, high), int32 by default."""
    g, dev = _stream(key, generator, device)
    return torch.randint(int(low), int(high), _normalize_shape(shape), generator=g, device=dev,
                         dtype=canonical(resolve_dtype(dtype)))


def truncated_normal(shape: Shape = (), lower: float = -2.0, upper: float = 2.0, *, key=None,
                     dtype=None, generator=None, device=None) -> torch.Tensor:
    """N(0, 1) truncated to (lower, upper), by jax.random.truncated_normal's
    inverse-CDF steps: a uniform draw between erf(lower / sqrt 2) and
    erf(upper / sqrt 2), mapped by sqrt 2 erfinv, clipped inside the bounds."""
    dt = _dtype(dtype)
    g, dev = _stream(key, generator, device)
    lo = torch.tensor(lower, dtype=dt, device=dev)
    hi = torch.tensor(upper, dtype=dt, device=dev)
    sqrt2 = math.sqrt(2.0)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    u = torch.rand(_normalize_shape(shape), generator=g, device=dev, dtype=dt)
    u = torch.clamp(u * (b - a) + a, min=a)
    out = sqrt2 * torch.erfinv(u)
    return torch.clamp(out, torch.nextafter(lo, hi), torch.nextafter(hi, lo))
