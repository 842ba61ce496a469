"""The port's random draws, persistence, image bridge and native runtime
(numpower_tpu_torch.ops.random, ops.io, ops.image, numpower_tpu_torch.runtime)
against the JAX package's, on the CPU: the twin of tests/test_random_io.py.

- Random draws cannot match jax.random's values (a torch.Generator in place
  of a key), so, as the JAX tests do, they are compared by distribution:
  each draw's mean and standard deviation against the distribution's and
  against the JAX draw's of the same size, within 6 standard errors (a
  false alarm once in ~10^9 runs), bounds and integer values exactly, and
  the same draws after the same seed or key.
- io: EXACT (the same bytes of data both ways: a file JAX writes the port
  reads and the reverse, small and past the native reader's 1 MiB).
- image: EXACT (uint8 images, half-to-even rounding as jnp.round).
- runtime: the registry's counters and the .npy paths, through the native
  library and through the Python registry that serves where it cannot be
  built.
"""

import hashlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_ops_twins import assert_same, check, to_port

from numpower_tpu import ops as jops
from numpower_tpu.ops import random as jrand
from numpower_tpu_torch import ops as tops
from numpower_tpu_torch import runtime
from numpower_tpu_torch.ops import random as trand

REPO = Path(__file__).resolve().parents[1]
N = 200_000  # draws a moment check takes


def _moments_agree(x: np.ndarray, mean: float, std: float, what=""):
    """x's mean and standard deviation within 6 standard errors of the
    distribution's (the std's standard error from the fourth moment)."""
    n = x.size
    m4 = float(np.mean((x - mean) ** 4))
    assert abs(x.mean() - mean) <= 6 * std / math.sqrt(n), (what, x.mean(), mean)
    se_var = math.sqrt(max(m4 - std ** 4, 1e-12) / n)
    assert abs(x.var() - std ** 2) <= 6 * se_var, (what, x.var(), std ** 2)


DRAWS = {
    # name: (port call, JAX call, mean, std)
    "uniform": (lambda g: trand.uniform((N,), 2.0, 4.0, key=g),
                lambda k: jrand.uniform((N,), 2.0, 4.0, key=k), 3.0, 2 / math.sqrt(12)),
    "normal": (lambda g: trand.normal((N,), 5.0, 2.0, key=g),
               lambda k: jrand.normal((N,), 5.0, 2.0, key=k), 5.0, 2.0),
    "standard_normal": (lambda g: trand.standard_normal((N,), key=g),
                        lambda k: jrand.standard_normal((N,), key=k), 0.0, 1.0),
    "poisson": (lambda g: trand.poisson((N,), 4.0, key=g),
                lambda k: jrand.poisson((N,), 4.0, key=k), 4.0, 2.0),
    "random_binomial": (lambda g: trand.random_binomial((N,), 10, 0.3, key=g),
                        lambda k: jrand.random_binomial((N,), 10, 0.3, key=k), 3.0,
                        math.sqrt(10 * 0.3 * 0.7)),
    "randint": (lambda g: trand.randint((N,), -3, 7, key=g),
                lambda k: jrand.randint((N,), -3, 7, key=k), 1.5, math.sqrt((10 ** 2 - 1) / 12)),
    # N(0, 1) truncated to (-2, 2): mean 0, variance 1 - 4 phi(2) / (2 Phi(2) - 1)
    "truncated_normal": (lambda g: trand.truncated_normal((N,), -2.0, 2.0, key=g),
                         lambda k: jrand.truncated_normal((N,), -2.0, 2.0, key=k), 0.0,
                         math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                                   / math.erf(2 / math.sqrt(2)))),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_match_the_distribution_and_the_jax_draws(name, seed):
    port, jax_, mean, std = DRAWS[name]
    got = port(trand.key(seed, device="cpu"))
    want = np.asarray(jax_(jrand.key(seed)))
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    x = got.double().numpy()
    _moments_agree(x, mean, std, name)
    _moments_agree(want.astype(np.float64), mean, std, f"JAX {name}")
    # the two samples against each other: their means within 6 standard
    # errors of a difference of two independent means
    assert abs(x.mean() - want.mean()) <= 6 * std * math.sqrt(2 / N)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_respect_their_bounds(name):
    x = DRAWS[name][0](trand.key(3, device="cpu")).double().numpy()
    if name in ("poisson", "random_binomial", "randint"):
        np.testing.assert_array_equal(x, np.round(x))
    bounds = {"uniform": (2.0, 4.0), "random_binomial": (0, 10), "randint": (-3, 6),
              "truncated_normal": (-2.0, 2.0), "poisson": (0, np.inf)}
    if name in bounds:
        lo, hi = bounds[name]
        assert x.min() >= lo and x.max() <= hi
    if name == "uniform":
        assert x.max() < 4.0
    if name == "truncated_normal":
        assert x.min() > -2.0 and x.max() < 2.0


def test_moments_of_the_jax_tests():
    """tests/test_random_io.py's own moment bounds, on the port's draws."""
    x = trand.standard_normal((200, 200), key=trand.key(0, device="cpu")).numpy()
    assert x.shape == (200, 200) and abs(x.mean()) < 0.02 and abs(x.std() - 1.0) < 0.02
    x = trand.normal((100, 100), loc=5.0, scale=2.0, key=trand.key(1, device="cpu")).numpy()
    assert abs(x.mean() - 5.0) < 0.1 and abs(x.std() - 2.0) < 0.1
    x = trand.uniform((100, 100), low=2.0, high=4.0, key=trand.key(2, device="cpu")).numpy()
    assert x.min() >= 2.0 and x.max() < 4.0 and abs(x.mean() - 3.0) < 0.05
    x = trand.poisson((100, 100), lam=4.0, key=trand.key(3, device="cpu")).numpy()
    assert abs(x.mean() - 4.0) < 0.15 and abs(x.var() - 4.0) < 0.3
    x = trand.random_binomial((100, 100), n=10, p=0.3, key=trand.key(4, device="cpu")).numpy()
    assert abs(x.mean() - 3.0) < 0.1 and x.min() >= 0 and x.max() <= 10


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_seeded_global_stream_reproduces(name):
    """seed(s) resets the global stream: the same draws after the same seed
    (a capability NumPower's rand() lacks), others after another."""
    trand.seed(123)
    a = _global_draw(name)
    trand.seed(123)
    b = _global_draw(name)
    trand.seed(124)
    c = _global_draw(name)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def _global_draw(name):
    shape = (1000,)
    kwargs = {"device": "cpu"}
    return {"uniform": lambda: trand.uniform(shape, **kwargs),
            "normal": lambda: trand.normal(shape, **kwargs),
            "standard_normal": lambda: trand.standard_normal(shape, **kwargs),
            "poisson": lambda: trand.poisson(shape, 3.0, **kwargs),
            "random_binomial": lambda: trand.random_binomial(shape, 5, 0.5, **kwargs),
            "randint": lambda: trand.randint(shape, 0, 100, **kwargs),
            "truncated_normal": lambda: trand.truncated_normal(shape, **kwargs)}[name]()


def test_explicit_keys_and_generators_reproduce():
    a = trand.normal((5,), key=trand.key(7, device="cpu"))
    b = trand.normal((5,), key=trand.key(7, device="cpu"))
    c = trand.normal((5,), generator=trand.key(7, device="cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    g = torch.Generator().manual_seed(7)
    torch.testing.assert_close(a, trand.normal((5,), generator=g), rtol=0, atol=0)


def test_draw_dtypes_and_shapes():
    """float32 by default, int32 for randint, the JAX names' 64-bit types
    held as 32-bit ones; an int shape is a vector's length."""
    g = trand.key(0, device="cpu")
    assert trand.uniform(4, key=g).shape == (4,)
    assert trand.uniform((2, 3), key=g, dtype="float64").dtype == torch.float32
    assert trand.normal((2,), key=g, dtype="float16").dtype == torch.float16
    assert trand.randint((3,), 0, 5, key=g).dtype == torch.int32
    assert trand.poisson((3,), key=g).dtype == torch.float32
    assert trand.standard_normal((), key=g).shape == ()
    assert jrand.randint((3,), 0, 5, key=jrand.key(0)).dtype == np.int32


def test_global_generators_are_created_lazily():
    """Importing creates no generator (a CUDA one would initialise the
    card, as JAX's PRNGKey would its backend); a draw creates its device's."""
    import subprocess
    import sys

    code = ("import torch, numpower_tpu_torch; from numpower_tpu_torch.ops import random as r; "
            "assert not r._streams._generators; "
            "assert not torch.cuda.is_initialized(); "
            "r.uniform((2,), device='cpu'); "
            "assert list(r._streams._generators) == [torch.device('cpu')]")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_draws_default_to_the_card():
    """With no key and no device a draw lands on the card; without CUDA it
    raises (there is no fallback to the CPU)."""
    if torch.cuda.is_available():
        assert trand.uniform((2,)).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            trand.uniform((2,))


# -- io ----------------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    a = tops.array([[1.5, -2.5], [3.0, 4.0]], device="cpu")
    p = str(tmp_path / "x.npy")
    tops.save(p, a)
    b = tops.load(p, device="cpu")
    assert_same(np.asarray(jops.array([[1.5, -2.5], [3.0, 4.0]])), b)


@pytest.mark.parametrize("shape", [(2, 3), (100, 1000), (512, 1024)], ids=["small", "400KB", "2MB"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "float16"])
def test_files_cross_between_the_packages(tmp_path, shape, dtype):
    """A file the JAX package writes, the port reads, and the reverse; and
    numpy reads both. EXACT."""
    x = (np.random.default_rng(0).standard_normal(shape) * 50).astype(dtype)
    pj, pt = str(tmp_path / "jax.npy"), str(tmp_path / "port.npy")
    jops.save(pj, x)
    tops.save(pt, to_port(x))
    assert_same(np.asarray(jops.load(pt)), tops.load(pj, device="cpu"))
    np.testing.assert_array_equal(np.load(pt), x)
    np.testing.assert_array_equal(np.asarray(jops.load(pt)), x)
    assert_same(np.asarray(jops.load(pj)), tops.load(pt, device="cpu"))


def test_load_takes_the_jax_dtypes(tmp_path):
    """A float64 file loads as float32 and an int64 one as int32, in both."""
    for x in (np.arange(6, dtype=np.float64) / 3, np.arange(6, dtype=np.int64)):
        p = str(tmp_path / "wide.npy")
        np.save(p, x)
        assert_same(jops.load(p), tops.load(p, device="cpu"))


def test_load_large_uses_the_native_reader(tmp_path, monkeypatch):
    """A file of 1 MiB or more is read by runtime.npy_read_fast."""
    arr = np.random.default_rng(0).standard_normal((512, 1024)).astype(np.float32)  # 2 MB
    p = str(tmp_path / "big.npy")
    np.save(p, arr)
    assert runtime.native_available()
    fast = runtime.npy_read_fast(p)
    assert fast is not None and fast.dtype == np.float32
    np.testing.assert_array_equal(fast, arr)
    calls = []
    real = runtime.npy_read_fast
    monkeypatch.setattr(runtime, "npy_read_fast", lambda path: calls.append(path) or real(path))
    np.testing.assert_array_equal(tops.load(p, device="cpu").numpy(), arr)
    assert calls == [p]
    small = str(tmp_path / "small.npy")
    np.save(small, arr[:4])
    tops.load(small, device="cpu")
    assert calls == [p]  # below 1 MiB: numpy's reader


def test_save_large_is_numpy_readable(tmp_path):
    a = tops.arange(100000, device="cpu").reshape((100, 1000))
    p = str(tmp_path / "big.npy")
    tops.save(p, a)
    np.testing.assert_array_equal(np.load(p), a.numpy())
    np.testing.assert_array_equal(tops.load(p, device="cpu").numpy(), a.numpy())


def test_npy_read_fast_rejects_fortran(tmp_path):
    arr = np.asfortranarray(np.arange(12.0, dtype=np.float32).reshape(3, 4))
    p = str(tmp_path / "f.npy")
    np.save(p, arr)
    assert runtime.npy_read_fast(p) is None  # the caller takes np.load
    big = np.asfortranarray(np.ones((600, 600), np.float32))
    np.save(p, big)
    assert runtime.npy_read_fast(p) is None
    np.testing.assert_array_equal(tops.load(p, device="cpu").numpy(), big)


def test_load_without_the_suffix_and_missing_files(tmp_path):
    p = tmp_path / "x.npy"
    np.save(p, np.ones(3, np.float32))
    assert tops.load(str(tmp_path / "x"), device="cpu").tolist() == [1.0, 1.0, 1.0]
    with pytest.raises((FileNotFoundError, OSError)):
        tops.load(str(tmp_path / "missing.npy"), device="cpu")


def test_load_defaults_to_the_card(tmp_path):
    p = str(tmp_path / "x.npy")
    np.save(p, np.ones(3, np.float32))
    if torch.cuda.is_available():
        assert tops.load(p).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tops.load(p)


def test_serialize_roundtrip_and_across_packages():
    a = np.array([[1.0, 2.0]], np.float32)
    data = tops.serialize(to_port(a))
    assert_same(jops.deserialize(data), tops.deserialize(data, device="cpu"))
    assert_same(jops.deserialize(jops.serialize(a)),
                tops.deserialize(jops.serialize(a), device="cpu"))
    assert data == jops.serialize(a)


@pytest.mark.parametrize("x", [[[1, 2], [3, 4]], [1.5, -2.0], 3.0, [[True, False]]])
def test_to_list(x):
    assert tops.to_list(tops.array(x, device="cpu")) == jops.to_list(jops.array(x))
    arr = np.array(x, np.int32)
    assert tops.to_list(to_port(arr)) == jops.to_list(arr)


# -- image -------------------------------------------------------------------------------


IMG = (np.arange(2 * 3 * 3) * 37 % 256).reshape(2, 3, 3).astype(np.uint8)


@pytest.mark.parametrize("channel_first", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("img", ["rgb", "rgba", "gray"])
def test_image_roundtrip(channel_first, normalize, img):
    x = {"rgb": IMG, "rgba": np.concatenate([IMG, IMG[..., :1]], -1), "gray": IMG[..., 0]}[img]
    t = check("from_image", x, channel_first=channel_first, normalize=normalize,
              port_kwargs={"device": "cpu"})
    back = tops.to_image(t, channel_first=channel_first, denormalize=normalize)
    want = jops.to_image(jops.from_image(x, channel_first, normalize), channel_first, normalize)
    assert back.dtype == np.uint8 and back.shape == want.shape
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(back, x)


def test_to_image_rounds_half_to_even_and_clips():
    """A trap: jnp.round rounds half to even (ops.round rounds half away
    from zero): 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 254.5 -> 254; then the clip
    to [0, 255]."""
    x = np.array([[[0.5, 1.5, 2.5, 254.5, 255.5, -0.5, 300.0, -7.0]]], np.float32)
    got = tops.to_image(to_port(x))
    np.testing.assert_array_equal(got, jops.to_image(x))
    np.testing.assert_array_equal(got, [[0, 2, 2, 254, 255, 0, 255, 0]])
    assert tops.round(to_port(x)).numpy()[0, 0, 2] == 3.0


def test_to_image_of_a_gray_2d_tensor():
    x = np.array([[0.2, 0.7], [1.0, 0.0]], np.float32)
    for cf in (True, False):
        np.testing.assert_array_equal(tops.to_image(to_port(x), cf, True),
                                      jops.to_image(x, cf, True))


# -- runtime -------------------------------------------------------------------------------


def test_runtime_library_builds_into_build_not_the_jax_package():
    jax_lib = REPO / "numpower_tpu" / "runtime" / "libndruntime.so"
    before = hashlib.sha256(jax_lib.read_bytes()).hexdigest() if jax_lib.exists() else None
    assert runtime.native_available()
    path = runtime.library_path()
    assert path.parent == REPO / "build" / "numpower_tpu_torch" and path.is_file()
    assert (REPO / "numpower_tpu_torch" / "runtime" / "src" / "ndruntime.cpp").is_file()
    after = hashlib.sha256(jax_lib.read_bytes()).hexdigest() if jax_lib.exists() else None
    assert before == after


def test_native_registry_counts():
    before = runtime.stats()
    ids = [runtime.register(64) for _ in range(5)]
    mid = runtime.stats()
    assert mid["total_registered"] == before["total_registered"] + 5
    assert mid["live_count"] == before["live_count"] + 5
    assert mid["live_bytes"] == before["live_bytes"] + 320
    assert mid["peak_bytes"] >= mid["live_bytes"]
    for i in ids:
        runtime.unregister(i, 64)
    after = runtime.stats()
    assert after["live_count"] == before["live_count"]
    assert after["total_freed"] == before["total_freed"] + 5
    assert runtime.leak_check() == after["live_count"]


def test_python_registry_serves_without_the_library(monkeypatch, tmp_path):
    """Where the library cannot be built, the Python registry keeps the
    same counters and the .npy paths report themselves unavailable."""
    monkeypatch.setattr(runtime, "_load", lambda: None)
    monkeypatch.setattr(runtime, "_py_registry", runtime._PyRegistry())
    assert not runtime.native_available()
    ids = [runtime.register(16) for _ in range(3)]
    assert runtime.stats() == {"total_registered": 3, "total_freed": 0, "live_count": 3,
                               "live_bytes": 48, "peak_bytes": 48}
    runtime.unregister(ids[0], 16)
    runtime.unregister(ids[0], 16)  # a second free of one uuid is ignored
    assert runtime.stats()["live_count"] == 2 and runtime.leak_check() == 2
    arr = np.ones((600, 600), np.float32)
    p = str(tmp_path / "x.npy")
    assert runtime.npy_save_fast(p, arr) is False
    assert runtime.npy_read_fast(p) is None
    tops.save(p, to_port(arr))
    np.testing.assert_array_equal(tops.load(p, device="cpu").numpy(), arr)
