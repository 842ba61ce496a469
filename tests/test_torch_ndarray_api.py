"""The port's NDArray (numpower_tpu_torch.ndarray) against the JAX package's
(numpower_tpu.ndarray) on the CPU: the twin of tests/test_ndarray_api.py and
tests/test_api_surface.py.

- The surface: every name of NumPower's method table (the JAX test's
  REFERENCE_METHODS, imported, not copied) has a counterpart on the port's
  NDArray or ops; the ops namespace and the package's exports are compared
  with the JAX package's, with no list typed here.
- The behaviour: each test of tests/test_ndarray_api.py runs against the
  port's NDArray and runtime (that module's globals pointed at them), but
  test_device_shims, whose gpu() returns a copy without an accelerator
  where the port's raises (a deliberate difference, tested here); and every
  method of the class against the JAX class's on the same data: EXACT for
  the exact ops, TRANSCENDENTAL (rtol 1e-6, atol 1e-7) for the
  transcendentals, SOLVE (rtol 1e-5, atol 1e-5) for the reductions and
  linear algebra, results compared through toArray().
- The port's own rules: indexing bounds, the iterator protocol, pickling
  through the registry, the device shims on the CPU, and where an NDArray
  lands.

The port's default device (the card) is pointed at the CPU for these tests
(torch_ops_twins.port_default_device_cpu) but where a test checks it.
"""

import pickle

import numpy as np
import pytest
import test_api_surface
import test_ndarray_api
import torch
from torch_ops_twins import (
    EXACT, SOLVE, TRANSCENDENTAL, assert_orthonormal_columns, assert_reconstructs,
    port_default_device_cpu,
)

import numpower_tpu
import numpower_tpu.ndarray as jnd
import numpower_tpu.runtime  # noqa: F401  (the JAX package's runtime attribute)
import numpower_tpu_torch
import numpower_tpu_torch.ndarray as tnd
from numpower_tpu import ops as jops
from numpower_tpu_torch import NDArray, ops, runtime

J, T = jnd.NDArray, tnd.NDArray
M = [[1.0, 2.0], [3.0, 4.0]]
SPD = [[4.0, 2.0], [2.0, 3.0]]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, request):
    if "on_the_card" not in request.node.name:
        port_default_device_cpu(monkeypatch)


# -- the surface ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(set(test_api_surface.REFERENCE_METHODS)))
def test_reference_method_has_counterpart(name):
    """Every NumPower method has a counterpart on the port's NDArray or ops
    (offsetUnset, PHP-only, on neither package)."""
    if name in test_api_surface.EXEMPT:
        assert not hasattr(J, name) and not hasattr(T, name)
        return
    target = test_api_surface.PROTOCOL_EQUIVALENTS.get(name, name)
    assert hasattr(T, target) or hasattr(ops, target), name
    assert hasattr(T, target) == hasattr(J, target)


def test_every_method_of_the_jax_class_is_on_the_port():
    names = {n for n in dir(J) if not n.startswith("_") or n in (
        "__getitem__", "__setitem__", "__iter__", "__contains__", "__getstate__",
        "__setstate__", "__array__", "__float__", "__int__", "__len__", "__matmul__",
        "__mod__", "__rmod__", "__pow__", "__rpow__", "__truediv__", "__rtruediv__")}
    missing = sorted(n for n in names if not hasattr(T, n))
    assert missing == [], missing


def test_the_ops_namespace_is_the_jax_one():
    """numpower_tpu_torch.ops exports every name of numpower_tpu.ops,
    `random` included, and no other."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    assert public(ops) == public(jops)
    assert public(ops.random) >= {n for n in public(jops.random)
                                  if callable(getattr(jops.random, n))} - {
                                      "Optional", "Sequence", "Union"}


def test_the_package_exports_the_jax_ones():
    """NDArray, nd, ArithmeticOperand, runtime, ops and ndarray, as the JAX
    package exports them."""
    jax_names = {n for n in dir(numpower_tpu) if not n.startswith("_")}
    assert {"NDArray", "nd", "ArithmeticOperand", "runtime", "ops"} <= jax_names
    port_names = {n for n in dir(numpower_tpu_torch) if not n.startswith("_")}
    assert jax_names - {"jax"} <= port_names, sorted(jax_names - port_names)
    assert numpower_tpu_torch.nd is NDArray and numpower_tpu_torch.NDArray is tnd.NDArray


def test_functional_layer_covers_class_math(monkeypatch):
    monkeypatch.setattr(test_api_surface, "ops", ops)
    test_api_surface.test_functional_layer_covers_class_math()


def test_arithmetic_operand_class_registered():
    from numpower_tpu_torch import ArithmeticOperand

    ArithmeticOperand()


# -- the JAX tests, run on the port -----------------------------------------------------------

JAX_TESTS = sorted(n for n in dir(test_ndarray_api) if n.startswith("test_")
                   and n != "test_device_shims")


@pytest.mark.parametrize("name", JAX_TESTS)
def test_jax_ndarray_test_on_the_port(name, monkeypatch, tmp_path):
    monkeypatch.setattr(test_ndarray_api, "NDArray", NDArray)
    monkeypatch.setattr(test_ndarray_api, "runtime", runtime)
    fn = getattr(test_ndarray_api, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


# -- every method against the JAX class's ---------------------------------------------------------

DATA = np.random.default_rng(0).uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
POS = np.random.default_rng(1).uniform(1.1, 3.0, (3, 4)).astype(np.float32)


def _same(want, got, tol=EXACT):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for w, g in zip(want, got):
            _same(w, g, tol)
        return
    if isinstance(want, (float, int, bool)):
        assert type(got) is type(want)
        np.testing.assert_allclose(got, want, **tol)
        return
    assert isinstance(got, T) and isinstance(want, J)
    assert got.shape == want.shape and got.value.device.type == "cpu"
    assert str(got.dtype).removeprefix("torch.") == np.dtype(want.dtype).name
    np.testing.assert_allclose(np.asarray(got.toArray(), np.float64),
                               np.asarray(want.toArray(), np.float64), equal_nan=True, **tol)


UNARY_EXACT = ["abs", "square", "floor", "ceil", "trunc", "fix", "rint", "round", "negative",
               "positive", "sign", "copy", "flatten", "transpose", "sort", "argsort"]
UNARY_TRANSCENDENTAL = ["sqrt", "rsqrt", "exp", "exp2", "expm1", "log", "log2", "log10",
                        "log1p", "logb", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
                        "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "degrees",
                        "radians", "sinc", "reciprocal"]


@pytest.mark.parametrize("name", UNARY_EXACT + UNARY_TRANSCENDENTAL)
def test_unary_methods(name):
    x = POS if name in ("log", "log2", "log10", "logb", "sqrt", "rsqrt", "arccosh") else DATA
    tol = EXACT if name in UNARY_EXACT else TRANSCENDENTAL
    _same(getattr(J(x), name)(), getattr(T(torch.from_numpy(x)), name)(), tol)


BINARY = ["add", "subtract", "multiply", "divide", "pow", "mod", "maximum", "minimum",
          "arctan2", "equal", "not_equal", "greater", "greater_equal", "less", "less_equal"]


@pytest.mark.parametrize("name", BINARY)
@pytest.mark.parametrize("other", ["array", "row", "scalar"])
def test_binary_methods(name, other):
    o = {"array": POS, "row": POS[0], "scalar": 1.5}[other]
    tol = TRANSCENDENTAL if name in ("pow", "arctan2", "divide") else EXACT
    jo = J(o) if other != "scalar" else o
    to = T(torch.from_numpy(o)) if other != "scalar" else o
    _same(getattr(J(DATA), name)(jo), getattr(T(torch.from_numpy(DATA)), name)(to), tol)


OPERATORS = {"+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
             "/": lambda a, b: a / b, "**": lambda a, b: a ** b, "%": lambda a, b: a % b,
             "@": lambda a, b: a @ b, "r+": lambda a, b: 2 + a, "r-": lambda a, b: 2 - a,
             "r*": lambda a, b: 2 * a, "r/": lambda a, b: 2 / a, "r**": lambda a, b: 2 ** a,
             "r%": lambda a, b: 2 % a, "neg": lambda a, b: -a, "pos": lambda a, b: +a,
             "abs": lambda a, b: abs(a)}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_operators_return_ndarrays(op):
    fn = OPERATORS[op]
    b = POS.T.copy() if op == "@" else POS
    _same(fn(J(POS), J(b)), fn(T(torch.from_numpy(POS)), T(torch.from_numpy(b))),
          TRANSCENDENTAL if op in ("**", "r**", "/", "r/", "@") else EXACT)


@pytest.mark.parametrize("name", ["sum", "prod", "mean", "median", "min", "max", "argmin",
                                  "argmax", "std", "variance"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reduction_methods(name, axis):
    _same(getattr(J(DATA), name)(axis), getattr(T(torch.from_numpy(DATA)), name)(axis), SOLVE)


def test_other_reductions_and_logic():
    jx, tx = J(DATA), T(torch.from_numpy(DATA))
    _same(jx.quantile(0.3), tx.quantile(0.3), SOLVE)
    _same(jx.quantile([0.1, 0.9], 1), tx.quantile([0.1, 0.9], 1), SOLVE)
    _same(jx.average(0, POS[:, 0]), tx.average(0, POS[:, 0]), SOLVE)
    _same(jx.all(), tx.all())
    _same(jx.all(0), tx.all(0))
    assert tx.allclose(tx) is True and tx.allclose(tx + 1.0) is False
    _same(jx.clip(-0.5, 0.5), tx.clip(-0.5, 0.5))


@pytest.mark.parametrize("name,args", [
    ("reshape", ((4, 3),)), ("transpose", ((1, 0),)), ("flip", (0,)), ("expand_dims", (1,)),
    ("squeeze", (None,)), ("swapaxes", (0, 1)), ("rollaxis", (1,)), ("moveaxis", (0, 1)),
    ("slice", ([0, 2], [1, 4, 2])), ("diagonal", (1,)), ("append", ([[9.0] * 4], 0)),
])
def test_manipulation_methods(name, args):
    _same(getattr(J(DATA), name)(*args), getattr(T(torch.from_numpy(DATA)), name)(*args))


@pytest.mark.parametrize("name", ["concatenate", "vstack", "hstack", "dstack", "column_stack",
                                  "atleast_1d", "atleast_2d", "atleast_3d"])
def test_static_manipulation(name):
    if name.startswith("atleast"):
        _same(getattr(J, name)(J(DATA[0])), getattr(T, name)(T(torch.from_numpy(DATA[0]))))
        return
    _same(getattr(J, name)([J(DATA), J(POS)]),
          getattr(T, name)([T(torch.from_numpy(DATA)), T(torch.from_numpy(POS))]))


@pytest.mark.parametrize("name", ["matmul", "dot", "inner", "outer", "solve", "lstsq"])
def test_binary_linalg_methods(name):
    b = np.array([[1.0, -1.0], [0.5, 2.0]], np.float32)
    _same(getattr(J(M), name)(J(b)), getattr(T(M), name)(T(b)), SOLVE)


@pytest.mark.parametrize("name", ["trace", "inv", "det", "norm", "cond", "cholesky"])
def test_unary_linalg_methods(name):
    _same(getattr(J(SPD), name)(), getattr(T(SPD), name)(), SOLVE)


def test_factorization_methods():
    """lu, qr, svd and eig: NDArray triples and pairs, held by
    reconstruction (FACTORIZATION)."""
    a = np.array(M, np.float32)
    P, L, U = T(a).lu()
    assert all(isinstance(x, T) for x in (P, L, U))
    assert_reconstructs(a, (P @ L @ U).value)
    Q, R = T(a).qr()
    assert_reconstructs(a, (Q @ R).value)
    assert_orthonormal_columns(Q.value)
    U_, S, Vt = T(a).svd()
    assert_reconstructs(a, (U_.value * S.value) @ Vt.value)
    w, v = T(SPD).eig()
    jw, _ = J(SPD).eig()
    np.testing.assert_allclose(sorted(w.toArray()), sorted(jw.toArray()), **SOLVE)
    assert_reconstructs(np.array(SPD) @ np.array(v.toArray()), v.value * w.value)
    assert T(a).matrix_rank() == J(a).matrix_rank() == 2


def test_cholesky_of_a_non_positive_definite_matrix_raises():
    for cls in (J, T):
        with pytest.raises(ValueError, match="not positive definite"):
            cls([[1.0, 5.0], [5.0, 1.0]]).cholesky()
    assert torch.isnan(ops.cholesky(torch.tensor([[1.0, 5.0], [5.0, 1.0]]))).any()


def test_signal_and_dnn_methods():
    k = np.array([[1.0, 0.5], [0.0, -1.0]], np.float32)
    for mode in ("full", "same", "valid"):
        _same(J(DATA).convolve2d(J(k), mode), T(torch.from_numpy(DATA)).convolve2d(T(k), mode),
              SOLVE)
        _same(J(DATA).correlate2d(J(k), mode, "symm"),
              T(torch.from_numpy(DATA)).correlate2d(T(k), mode, "symm"), SOLVE)
    x = np.random.default_rng(2).standard_normal((1, 2, 5, 5)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((3, 2, 3, 3)).astype(np.float32)
    g = np.ones((1, 3, 5, 5), np.float32)
    _same(J.dnn_conv2d_forward(x, w, None, 2), T.dnn_conv2d_forward(torch.from_numpy(x),
                                                                     torch.from_numpy(w), None, 2),
          SOLVE)
    _same(J.dnn_conv2d_backward(x, w, g), T.dnn_conv2d_backward(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g)), SOLVE)
    x1, w1 = x[:, :, 0], w[:, :, 0]
    _same(J.dnn_conv1d_forward(x1, w1, 1, "causal"),
          T.dnn_conv1d_forward(torch.from_numpy(x1), torch.from_numpy(w1), 1, "causal"), SOLVE)


def test_constructors_and_conversions(tmp_path):
    for name, args in (("zeros", ((2, 3),)), ("ones", ((2,),)), ("full", ((2, 2), 7.0)),
                       ("identity", (3,)), ("arange", (5, 1)), ("diag", ([1.0, 2.0],))):
        _same(getattr(J, name)(*args), getattr(T, name)(*args))
    for name, args in (("uniform", ((64, 64),)), ("normal", ((64, 64),)),
                       ("standard_normal", ((64, 64),)), ("poisson", ((64, 64), 2.0)),
                       ("random_binomial", ((64, 64), 4, 0.5))):
        x = getattr(T, name)(*args)
        assert isinstance(x, T) and x.shape == (64, 64) and x.dtype == torch.float32
    a = T(DATA)
    assert a.astype("int32").dtype == torch.int32 and a.astype("double64").dtype == torch.float32
    assert T([2.5]).item() == 2.5
    assert float(T(3.0)) == 3.0 and int(T(3.7)) == 3
    np.testing.assert_array_equal(np.asarray(a), DATA)
    assert np.asarray(a, dtype=np.float64).dtype == np.float64
    p = str(tmp_path / "a.npy")
    a.save(p)
    _same(J.load(p), T.load(p))
    img = (np.arange(12) * 20 % 256).astype(np.uint8).reshape(2, 2, 3)
    _same(J.fromImage(img), T.fromImage(img))
    np.testing.assert_array_equal(T.fromImage(img).toImage(), img)
    assert "float32" in T(DATA).dump() and "device: cpu" in T(DATA).dump()
    assert repr(T(M)) == repr(J(M))
    assert "cuda_device_count" in T.dumpDevices()


def test_fill_and_sort_rebind():
    a = T(DATA)
    assert a.fill(2.0) is a and a.toArray() == [[2.0] * 4] * 3
    _same(J(DATA).sort(0), T(torch.from_numpy(DATA)).sort(0))


# -- the port's own rules -------------------------------------------------------------------------


@pytest.mark.parametrize("idx", [5, -4, (0, 7), (3, 0), (0, -5)])
def test_index_past_an_axis_raises(idx):
    """NumPower's offsetGet bounds check, in both packages (JAX would clamp
    inside jit; the card's indexing would assert in a kernel)."""
    for cls in (J, T):
        a = cls(DATA)
        with pytest.raises(IndexError):
            a[idx]
        with pytest.raises(IndexError):
            a[idx] = 1.0


@pytest.mark.parametrize("idx", [0, -1, (1, 2), (slice(None), 1), (slice(0, 2), slice(1, 3))])
def test_getitem_and_setitem(idx):
    ja, ta = J(DATA), T(torch.from_numpy(DATA.copy()))
    _same(ja[idx], ta[idx])
    value = np.float32(9.5) if isinstance(ja[idx], float) else np.full(ja[idx].shape, 9.5,
                                                                      np.float32)
    ja[idx] = value.tolist() if hasattr(value, "tolist") else value
    ta[idx] = value.tolist() if hasattr(value, "tolist") else value
    _same(ja, ta)


def test_setitem_rebinds_and_leaves_other_views():
    t = torch.from_numpy(DATA.copy())
    a = T(t)
    a[0, 0] = 100.0
    assert a[0, 0] == 100.0 and t[0, 0].item() != 100.0


def test_iterator_protocol():
    for cls in (J, T):
        a = cls([[1, 2], [3, 4], [5, 6]])
        a.rewind()
        seen = []
        while a.valid():
            seen.append((a.key(), a.current().toArray()))
            a.next()
        assert seen == [(0, [1, 2]), (1, [3, 4]), (2, [5, 6])]
        assert [r.toArray() for r in a] == [[1, 2], [3, 4], [5, 6]]
        assert len(a) == a.count() == 3
    assert T(2.0).count() == 0


def test_pickle_keeps_the_device_and_registers():
    a = T([[1, 2], [3, 4]])
    before = runtime.stats()["total_registered"]
    b = pickle.loads(pickle.dumps(a))
    assert b.toArray() == a.toArray() and b.value.device.type == "cpu" and b.dtype == a.dtype
    assert runtime.stats()["total_registered"] == before + 1
    state = a.__getstate__()
    assert state["data"] == jops.serialize(np.array([[1, 2], [3, 4]], np.float32))


def test_registry_counts_rise_and_fall():
    import gc

    gc.collect()
    before = runtime.stats()
    arrays = [T.zeros((4, 4)) for _ in range(10)]
    mid = runtime.stats()
    assert mid["live_count"] == before["live_count"] + 10
    assert mid["live_bytes"] == before["live_bytes"] + 10 * 64
    del arrays
    gc.collect()
    after = runtime.stats()
    assert after["live_count"] == before["live_count"]
    assert after["total_freed"] >= before["total_freed"] + 10


def test_device_shims_on_the_cpu():
    a = T([[1, 2], [3, 4]])
    c = a.cpu()
    assert c.toArray() == a.toArray() and not c.isGPU() and c.value.device.type == "cpu"


def test_gpu_raises_without_cuda(monkeypatch):
    """A deliberate difference: without CUDA the JAX class's gpu() returns a
    copy, the port's raises (nothing hides the device)."""
    assert J([1.0]).gpu().toArray() == [1.0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T([1.0]).gpu()


def test_set_device_selects_the_card_modulo_the_count(monkeypatch):
    """setDevice(i) picks cuda:(i mod device_count) for later gpu() calls,
    as the JAX class wraps its index."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    try:
        T.setDevice(1)
        assert tnd._accel_device() == torch.device("cuda", 1)
        T.setDevice(5)
        assert tnd._accel_device() == torch.device("cuda", 2)
    finally:
        T.setDevice(0)


def test_an_ndarray_from_a_tensor_keeps_its_device():
    t = torch.ones(2, 2)
    assert T(t).value.device.type == "cpu" and T(T(t)).value.device.type == "cpu"


def test_an_ndarray_from_a_list_lands_on_the_card_on_the_card():
    """An NDArray from a list or numpy array goes to the card (without CUDA
    it raises: there is no fallback to the CPU)."""
    if torch.cuda.is_available():
        assert T([1.0, 2.0]).isGPU() and T(np.ones(2, np.float32)).isGPU()
    else:
        for x in ([1.0, 2.0], np.ones(2, np.float32)):
            with pytest.raises((RuntimeError, AssertionError)):
                T(x)
