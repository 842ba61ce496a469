"""numpower_tpu_torch.runtime.stream.ScenarioStream against the JAX package's
(CPU).

The twins of tests/test_runtime_stream.py's six tests on the port's stream
(device="cpu": batches are CPU tensors), then the port against the JAX
package on the same arguments: the native batches equal JAX's native ones bit
for bit (both libraries build the same scenario_stream.cpp) for the normal
and uniform distributions, 1 and 3 worker threads, 2 and 4 ring slots and
batches 0-5; the numpy fallback equals JAX's fallback bit for bit.
"""

import numpy as np
import pytest
import torch

from numpower_tpu_torch import runtime
from numpower_tpu_torch.runtime.stream import ScenarioStream


def _stream(**kw):
    return ScenarioStream(device="cpu", **kw)


def test_native_lib_builds():
    assert runtime.native_available()


def test_stream_normal_statistics():
    with _stream(batch=512, shape=(16,), seed=1, dist="normal", scale=2.0) as s:
        assert s.native
        batches = [next(s) for _ in range(4)]
    all_data = torch.cat(batches).numpy()
    assert all_data.shape == (2048, 16)
    assert abs(all_data.mean()) < 0.15
    assert abs(all_data.std() - 2.0) < 0.15


def test_stream_uniform_bounds():
    with _stream(batch=256, shape=(8, 4), seed=2, dist="uniform", scale=0.5) as s:
        w = next(s).numpy()
    assert w.shape == (256, 8, 4)
    assert w.min() >= -0.5 and w.max() < 0.5
    assert abs(w.mean()) < 0.05


def test_stream_deterministic_per_seed():
    with _stream(batch=64, shape=(4,), seed=7) as s1:
        a1, a2 = next(s1), next(s1)
    with _stream(batch=64, shape=(4,), seed=7) as s2:
        b1, b2 = next(s2), next(s2)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2)  # different batches differ


def test_stream_many_batches_ordered():
    # the ring buffer across many acquire/release cycles
    with _stream(batch=32, shape=(2,), seed=3, n_slots=2, n_threads=3) as s:
        sums = [float(next(s).sum()) for _ in range(50)]
    with _stream(batch=32, shape=(2,), seed=3, n_slots=4, n_threads=1) as s:
        sums2 = [float(next(s).sum()) for _ in range(50)]
    # order and content independent of the slot/thread configuration
    np.testing.assert_allclose(sums, sums2, rtol=1e-6)


def test_stream_fallback_when_no_native(monkeypatch):
    monkeypatch.setattr(runtime, "_load", lambda: None)
    with _stream(batch=16, shape=(3,), seed=0) as s:
        assert not s.native
        w = next(s)
    assert w.shape == (16, 3) and w.dtype == torch.float32


# -- the port against the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_stream():
    pytest.importorskip("jax")
    from numpower_tpu import runtime as jax_runtime
    from numpower_tpu.runtime.stream import ScenarioStream as JaxStream

    assert jax_runtime.native_available()
    return JaxStream


@pytest.mark.parametrize("n_slots", [2, 4])
@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_native_batches_equal_jax_bit_for_bit(jax_stream, dist, n_threads, n_slots):
    kw = dict(batch=96, shape=(5, 3), seed=11, dist=dist, scale=0.7, n_slots=n_slots,
              n_threads=n_threads)
    with jax_stream(**kw) as js, _stream(**kw) as ts:
        assert js.native and ts.native
        for _ in range(6):  # batches 0-5
            want, got = next(js), next(ts)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert got.shape == want.shape == (96, 5, 3)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_fallback_equals_jax_fallback(jax_stream, monkeypatch, dist):
    from numpower_tpu import runtime as jax_runtime

    monkeypatch.setattr(jax_runtime, "_load", lambda: None)
    monkeypatch.setattr(runtime, "_load", lambda: None)
    kw = dict(batch=40, shape=(6,), seed=5, dist=dist, scale=1.5)
    with jax_stream(**kw) as js, _stream(**kw) as ts:
        assert not js.native and not ts.native
        for _ in range(3):
            np.testing.assert_array_equal(next(ts).numpy(), next(js))


def test_batches_are_cpu_tensors_that_own_their_memory():
    """device="cpu": each batch is a CPU tensor of its own, not a view of a
    ring slot that the next batches overwrite."""
    with _stream(batch=8, shape=(2, 2), seed=4, n_slots=2) as s:
        first = next(s)
        kept = first.clone()
        for _ in range(5):
            next(s)
    assert first.device.type == "cpu" and first.dtype == torch.float32
    assert torch.equal(first, kept)


def test_closed_stream_and_bad_dist():
    with pytest.raises(ValueError):
        _stream(batch=4, shape=(2,), dist="cauchy")
    s = _stream(batch=4, shape=(2,), seed=1)
    assert s.native
    next(s)
    s.close()
    assert not s.native
    s.close()  # a second close does nothing


def test_default_device_is_the_card():
    """With no device the batches are meant for the card: the stream names
    it, and on a machine without CUDA the first batch raises instead of
    falling back to the CPU."""
    s = ScenarioStream(batch=4, shape=(2,), seed=1)
    try:
        assert s.device == torch.device("cuda")
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                next(s)
    finally:
        s.close()
