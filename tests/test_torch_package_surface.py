"""The port's public surface against the JAX package's (CPU).

For every Python module of numpower_tpu (not the shared library its runtime
builds at first use, libndruntime.so, which is no module of the package
and comes and goes with the build): the module of the same name in
numpower_tpu_torch; every public name the JAX module defines or takes from
the package (functions, classes, constants; imports from outside the package
left out); every public attribute of each such class (its fields too); and
every parameter of each such function, class constructor and method, which
the port's counterpart takes by the same name (or through **kwargs). A gap is
either repaired or stands in EXCEPTIONS with its reason, and an exception
that is no longer a gap fails too, so the list stays the set of deliberate
differences (ROADMAP queue 3).
"""

import importlib
import importlib.util
import inspect
import pkgutil
import types

import pytest

pytest.importorskip("jax")
import numpower_tpu  # noqa: E402
import numpower_tpu_torch  # noqa: E402

EXCEPTIONS = {
    ("name", ".ops.signal", "asarray"):
        "the JAX module's import of ops.creation.asarray, not a signal op; the port's "
        "ops.asarray is the same function",
    ("name", ".models.particle", "RESAMPLE_ONEHOT_MAX_N"):
        "the JAX package's one-hot rule (N <= 8192) was measured on a TPU; the port's "
        "route_resample takes K14 on the card and 'gather' elsewhere",
    ("param", ".utils.flops", "RooflineCost.sol_seconds", "vpu_tf"):
        "the H100's rate outside the tensor cores, fp32_tf in the same position: the card "
        "has no VPU",
    ("param", ".utils.flops", "RooflineCost.bound", "vpu_tf"):
        "as sol_seconds: fp32_tf in the same position; the bound reads 'bytes' or "
        "'operations' where the JAX package's reads 'HBM' or 'VPU'",
}


def _modules(pkg) -> dict:
    """{relative name: module name} of every Python module under the
    package (a built extension, whose presence depends on the build, is
    left out, so that every test process collects the same cases)."""
    found = {"": pkg.__name__}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if info.ispkg or importlib.util.find_spec(info.name).origin.endswith(".py"):
            found[info.name[len(pkg.__name__):]] = info.name
    return found


JAX_MODULES = _modules(numpower_tpu)


def _public_names(module) -> dict:
    """The public names of a module that belong to its package: every
    function and class defined in the package, and every other value but
    modules."""
    root = module.__name__.split(".")[0]
    names = {}
    for name, value in vars(module).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if callable(value) and not (getattr(value, "__module__", None) or "").startswith(root):
            continue
        names[name] = value
    return names


def _signature(fn):
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def _missing_parameters(jax_fn, port_fn) -> list:
    want, have = _signature(jax_fn), _signature(port_fn)
    if want is None or have is None:
        return []
    if any(p.kind == p.VAR_KEYWORD for p in have.parameters.values()):
        return []
    return [name for name, p in want.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and name not in have.parameters]


def _class_gaps(rel: str, name: str, jax_cls, port_cls) -> list:
    gaps = []
    fields = set(getattr(port_cls, "__dataclass_fields__", {})) | set(
        getattr(port_cls, "_fields", ()))
    for attr in vars(jax_cls):
        if not attr.startswith("_") and not hasattr(port_cls, attr) and attr not in fields:
            gaps.append(("attr", rel, name, attr))
    for attr, value in vars(jax_cls).items():
        if (attr.startswith("_") and attr != "__init__") or not callable(value):
            continue
        port_fn = getattr(port_cls, attr, None)
        if port_fn is not None:
            gaps += [("param", rel, f"{name}.{attr}", p)
                     for p in _missing_parameters(value, port_fn)]
    return gaps


def surface_gaps(rel: str) -> list:
    """The gaps of the port's module against the JAX module `rel`."""
    port_modules = _modules(numpower_tpu_torch)
    if rel not in port_modules:
        return [("module", rel)]
    jax_mod = importlib.import_module(JAX_MODULES[rel])
    port_mod = importlib.import_module(port_modules[rel])
    gaps = []
    for name, value in _public_names(jax_mod).items():
        if not hasattr(port_mod, name):
            gaps.append(("name", rel, name))
            continue
        port_value = getattr(port_mod, name)
        if isinstance(value, type):
            gaps += _class_gaps(rel, name, value, port_value)
        elif callable(value):
            gaps += [("param", rel, name, p) for p in _missing_parameters(value, port_value)]
    return gaps


@pytest.mark.parametrize("rel", sorted(JAX_MODULES), ids=lambda r: r or "numpower_tpu")
def test_port_module_has_the_jax_modules_surface(rel):
    gaps = surface_gaps(rel)
    unexplained = [g for g in gaps if g not in EXCEPTIONS]
    assert not unexplained, f"the port lacks: {unexplained}"
    stale = [e for e in EXCEPTIONS if e[1] == rel and e not in gaps]
    assert not stale, f"exceptions that are no longer gaps: {stale}"


def test_every_exception_names_a_jax_module_and_a_reason():
    for key, reason in EXCEPTIONS.items():
        assert key[1] in JAX_MODULES and len(reason) > 20, key
