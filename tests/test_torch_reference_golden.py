"""NumPower's phpt cases (tests/test_reference_golden.py) against the port's
NDArray, on the CPU.

The JAX package's golden file stays as it is: this file imports its
PHPT_MAP and its case functions, points the module's `nd` at the port's
NDArray (and the port's default device, the card, at the CPU, for the
test's duration only; the port has no such switch), and runs every case the
map names, each parametrisation of a parametrised case included, with the
case's own tolerance. No mapped case reaches jax itself (the module's
`import jax` serves none of them), so none needs a port version of its own.
"""

import itertools

import pytest
import test_reference_golden as golden
from torch_ops_twins import port_default_device_cpu

from numpower_tpu_torch import NDArray


def _parametrisations(fn):
    """Every keyword set of fn's parametrize marks (their product), as
    (id, kwargs)."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    if not marks:
        return [("", {})]
    axes = []
    for mark in marks:
        names = [n.strip() for n in mark.args[0].split(",")] if isinstance(mark.args[0], str) \
            else list(mark.args[0])
        values = [v if len(names) > 1 else (v,) for v in mark.args[1]]
        axes.append([dict(zip(names, v)) for v in values])
    out = []
    for combo in itertools.product(*axes):
        kwargs = {k: v for part in combo for k, v in part.items()}
        ident = "-".join(str(next(iter(part.values()))) for part in combo)
        out.append((ident, kwargs))
    return out


MAPPED = sorted({name.split("[")[0] for names in golden.PHPT_MAP.values() for name in names})
CASES = [(name, ident, kwargs) for name in MAPPED
         for ident, kwargs in _parametrisations(getattr(golden, name))]


def test_every_phpt_file_is_mapped_to_cases_that_exist():
    assert len(golden.PHPT_MAP) == 67
    assert all(callable(getattr(golden, name, None)) for name in MAPPED)
    unary = {kw["method"] for _, _, kw in CASES if "method" in kw}
    for names in golden.PHPT_MAP.values():
        for name in names:
            if "[" in name:
                assert name[name.index("[") + 1:-1] in unary


@pytest.mark.parametrize("name,ident,kwargs", CASES,
                         ids=[f"{n}[{i}]" if i else n for n, i, _ in CASES])
def test_phpt_case_on_the_port(name, ident, kwargs, monkeypatch):
    port_default_device_cpu(monkeypatch)
    monkeypatch.setattr(golden, "nd", NDArray)
    getattr(golden, name)(**kwargs)
