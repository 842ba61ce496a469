"""The port's creation functions and dtype registry (numpower_tpu_torch.ops)
against the JAX package's (numpower_tpu.ops) on the same inputs, on the CPU:
the twin of tests/test_creation.py. Tolerance: exact (values, shapes and
dtypes equal). The port's creation functions take device="cpu" here; their
default, the card, is checked in tests/test_torch_ops_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch_ops_twins import EXACT, assert_same, check, to_port

from numpower_tpu import ops as jops
from numpower_tpu_torch import ops as tops

CPU = {"device": "cpu"}


@pytest.mark.parametrize("obj", [
    [[1, 2], [3, 4]], 5, 2.5, True, [1.5, -2.0, 3.25], [[0.1, 0.2, 0.3]],
], ids=["nested", "int", "float", "bool", "list", "row"])
@pytest.mark.parametrize("name", ["array", "asarray"])
def test_array_from_python_natives(name, obj):
    check(name, obj, port_kwargs=CPU)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.uint8,
                                   np.int8, np.int16, np.float16, np.bool_])
def test_asarray_keeps_numpy_dtypes_as_jax_holds_them(dtype):
    """float64 and int64 become float32 and int32 (the JAX package runs with
    64-bit types off); the others stay."""
    x = (np.random.default_rng(0).standard_normal((3, 4)) * 10).astype(dtype)
    check("asarray", x)


@pytest.mark.parametrize("dtype", [None, "float32", "float64", "double64", "int32", "int64",
                                   "int16", "int8", "uint8", "float16", "bfloat16", "bool",
                                   np.float32, np.int32])
@pytest.mark.parametrize("name,args", [
    ("zeros", ((2, 3),)), ("ones", (4,)), ("full", ((2, 2), 7.5)), ("empty", ((3, 2),)),
    ("identity", (3,)), ("eye", (2, 4)), ("tri", (3,)), ("arange", (5,)),
    ("array", ([[1.5, 2.0], [3.0, 4.0]],)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_creation_dtypes(name, args, dtype):
    """Every creation function at every named dtype: "float64" and
    "double64" give float32, "int64" int32, as in the JAX package (a bool
    arange longer than 2 raises in both, as in numpy)."""
    if name == "arange" and dtype == "bool":
        for ops in (jops, tops):
            with pytest.raises(TypeError):
                ops.arange(*args, dtype=dtype, **({} if ops is jops else CPU))
        return
    check(name, *args, dtype=dtype, port_kwargs=CPU)


@pytest.mark.parametrize("kw", [{}, {"k": 1}, {"k": -1}, {"m": 5}, {"m": 2, "k": 1}])
@pytest.mark.parametrize("name", ["eye", "tri"])
def test_eye_tri_offsets(name, kw):
    check(name, 4, **kw, port_kwargs=CPU)


@pytest.mark.parametrize("args", [(5,), (1, 10, 2), (-3, 3), (0, 1, 0.1), (2.5, 7.1, 0.7),
                                  (10, 0, -3)])
def test_arange(args):
    check("arange", *args, port_kwargs=CPU)
    check("arange", *args, dtype="int32", port_kwargs=CPU)


@pytest.mark.parametrize("args", [(0, 1, 5), (-2.5, 3.7, 50), (1, 0, 7), (0, 10, 1),
                                  (0, 1, 0), (3, 9, 13), (-7, -3.3, 1000)])
@pytest.mark.parametrize("endpoint", [True, False])
def test_linspace(args, endpoint):
    """The one creation function that is not exact: both compute jnp.linspace's
    start (1 - s) + stop s, s = i / div, but XLA's CPU compiler rewrites the
    division into a product by 1 / div and contracts products into FMAs, so
    its values sit up to a few float32 ulps of max(|start|, |stop|) from the
    port's (ROADMAP queue 3). Bound: 4 ulps of that magnitude; the endpoints,
    shape and dtype exact. With an integer dtype (the floor of those values)
    the two agree but where a value lies within that bound of an integer,
    and there by one."""
    ulp = np.finfo(np.float32).eps * max(abs(args[0]), abs(args[1]), 1)
    want = jops.linspace(*args, endpoint=endpoint)
    got = tops.linspace(*args, endpoint=endpoint, device="cpu")
    assert_same(want, got, {"rtol": 0.0, "atol": 4 * ulp})
    if args[2] > 0:
        assert got[0].item() == np.asarray(want)[0]
        if endpoint:
            assert got[-1].item() == np.asarray(want)[-1]
    want_i = jops.linspace(*args, endpoint=endpoint, dtype="int32")
    got_i = tops.linspace(*args, endpoint=endpoint, dtype="int32", device="cpu")
    assert_same(want_i, got_i, {"rtol": 0.0, "atol": 1})
    apart = np.asarray(want_i) != got_i.numpy()
    values = np.asarray(want)[apart]
    assert (np.abs(values - np.round(values)) <= 4 * ulp).all()


@pytest.mark.parametrize("k", [0, 1, -2])
def test_diag_diagonal(k):
    rng = np.random.default_rng(k + 5)
    v = rng.standard_normal(4).astype(np.float32)
    m = rng.standard_normal((4, 5)).astype(np.float32)
    check("diag", v, k=k)
    check("diag", m, k=k)
    check("diagonal", m, offset=k)
    b = rng.standard_normal((2, 3, 4)).astype(np.float32)
    check("diagonal", b, offset=k, axis1=1, axis2=2)
    check("diagonal", b, offset=k, axis1=2, axis2=0)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_likes_fill_copy(dtype):
    x = (np.random.default_rng(1).standard_normal((3, 4)) * 5).astype(dtype)
    for name in ("empty_like", "zeros_like", "ones_like"):
        check(name, x)
        check(name, x, dtype="float32")
        check(name, x, dtype="float64")
    check("fill", x, 3.0)
    check("copy", x)
    check("full", (2, 3), np.arange(3, dtype=dtype), port_kwargs=CPU)


def test_copy_is_a_new_buffer():
    x = torch.ones(3)
    y = tops.copy(x)
    y[0] = 5.0
    assert x[0] == 1.0


def test_dtype_registry():
    """NumPower's "float32" / "double64" descriptors: sizes and identity as
    the JAX package names them (the type itself, 8 bytes for double64)."""
    names = ["float32", "double64", "float64", "bfloat16", "float16", "int32", "int64", "int16",
             "int8", "uint8", "bool"]
    for a in names:
        assert tops.get_type_size(a) == jops.get_type_size(a), a
        for b in names:
            assert tops.is_type(a, b) == jops.is_type(a, b), (a, b)
    assert tops.resolve_dtype("double64") is torch.float64
    assert tops.resolve_dtype(np.float32) is torch.float32
    assert tops.resolve_dtype(torch.int8) is torch.int8
    assert tops.resolve_dtype(None) is None
    with pytest.raises(ValueError):
        jops.zeros((2,), dtype="floatX")
    with pytest.raises(ValueError):
        tops.zeros((2,), dtype="floatX", device="cpu")


def test_scalar_is_0d():
    assert_same(jops.array(5), tops.array(5, device="cpu"), EXACT)
    assert tops.array(5, device="cpu").shape == ()


def test_tensor_keeps_dtype_and_device():
    """A tensor operand keeps its dtype and device; dtype= converts it as
    JAX's asarray would (float64 held as float32)."""
    t = torch.arange(4, dtype=torch.int16)
    assert tops.asarray(t) is t
    assert tops.asarray(t, dtype="float64").dtype == torch.float32
    assert to_port(np.zeros(2)).device.type == "cpu"
