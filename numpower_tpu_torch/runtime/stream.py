"""The native scenario stream (port of numpower_tpu/runtime/stream.py).

Iterates batches of scenarios (disturbance sequences, initial states)
generated by C++ worker threads into an aligned ring buffer
(runtime/src/scenario_stream.cpp, built into the port's native library): the
generation overlaps with device compute, so a 65k-scenario tube-MPC sweep
(BASELINE config #5) does not stall on host random numbers. Batches are
deterministic per (seed, batch_index), whatever ``n_threads`` and ``n_slots``
are.

    with ScenarioStream(batch=4096, shape=(30, 12), seed=0,
                        dist="normal", scale=0.01) as stream:
        for _, w in zip(range(16), stream):
            result = sweep_step(w)   # w: (4096, 30, 12) float32 on the card

Batches come out as float32 tensors on ``device`` (default: the card,
utils.default_device; ``device="cpu"`` gives CPU tensors). On the card each
ready slot is copied into one of two pinned staging buffers, the ring slot is
released at once, and the host-to-device copy runs on a side stream with
``non_blocking=True``; the consumer's stream waits on the copy's event, so
the batch is ready for whatever the caller enqueues next, while the host goes
on to the next batch. A staging buffer is refilled only after its previous
copy's event has completed.

Where the native library cannot be built, batches come from numpy's
``default_rng((seed, index))`` (the JAX package's fallback: the same
statistics, other values); ``native`` reports which of the two ran.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from numpower_tpu_torch import runtime as _rt
from numpower_tpu_torch.utils.device import default_device

_DISTS = {"normal": 0, "uniform": 1}


class ScenarioStream:
    def __init__(self, batch: int, shape: Sequence[int], seed: int = 0,
                 dist: str = "normal", scale: float = 1.0,
                 n_slots: int = 3, n_threads: int = 2, device=None):
        if dist not in _DISTS:
            raise ValueError(f"dist must be one of {sorted(_DISTS)}")
        self.batch = int(batch)
        self.shape = tuple(int(s) for s in shape)
        self.dim = int(np.prod(self.shape)) if self.shape else 1
        self.seed = int(seed)
        self.dist = dist
        self.scale = float(scale)
        self.device = default_device() if device is None else torch.device(device)
        self._lib = _rt._load()
        self._handle = None
        self._fallback_index = 0
        # the card's pipeline: two pinned staging buffers, the event of each
        # one's last copy, and the side stream of the copies (made at first use)
        self._staging = []
        self._copied: list[Optional[torch.cuda.Event]] = [None, None]
        self._next_staging = 0
        self._copy_stream = None
        if self._lib is not None:
            self._handle = self._lib.nptpu_stream_create(
                self.batch, self.dim, self.seed, _DISTS[dist], self.scale,
                int(n_slots), int(n_threads),
            )

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def __next__(self) -> torch.Tensor:
        if self._handle is not None:
            idx = ctypes.c_int64(0)
            slot = self._lib.nptpu_stream_acquire(self._handle, ctypes.byref(idx))
            if slot < 0:
                raise StopIteration
            ptr = self._lib.nptpu_stream_data(self._handle, slot)
            view = np.ctypeslib.as_array(ptr, shape=(self.batch * self.dim,))
            try:
                return self._deliver(view)
            finally:
                self._lib.nptpu_stream_release(self._handle, slot)
        # numpy fallback (same statistics; values differ from the native RNG)
        rng = np.random.default_rng((self.seed, self._fallback_index))
        self._fallback_index += 1
        if self.dist == "uniform":
            arr = rng.uniform(-self.scale, self.scale, size=(self.batch,) + self.shape)
        else:
            arr = self.scale * rng.standard_normal((self.batch,) + self.shape)
        return self._deliver(arr.astype(np.float32).reshape(-1))

    def _deliver(self, flat: np.ndarray) -> torch.Tensor:
        """The batch held by ``flat`` (float32, batch * dim) as a tensor on the
        stream's device. Every host read of ``flat`` is done on return, so
        the caller may release its ring slot then."""
        shape = (self.batch,) + self.shape
        if self.device.type != "cuda":
            return torch.from_numpy(flat.copy()).reshape(shape)
        k = self._next_staging
        self._next_staging ^= 1
        if not self._staging:
            self._staging = [torch.empty(flat.size, dtype=torch.float32, pin_memory=True)
                             for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(device=self.device)
        if self._copied[k] is not None:
            self._copied[k].synchronize()  # its previous copy may still read it
        np.copyto(self._staging[k].numpy(), flat)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = torch.empty(shape, dtype=torch.float32, device=self.device)
            out.view(-1).copy_(self._staging[k], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._copied[k] = event
        consumer.wait_event(event)
        out.record_stream(consumer)  # allocated on the side stream, used on the consumer's
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.nptpu_stream_destroy(self._handle)
            self._handle = None
        for event in self._copied:
            if event is not None:
                event.synchronize()
        self._copied = [None, None]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
