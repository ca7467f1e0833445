"""The benchmark's own tests (``portbench/tests/test_portbench_*.py``),
collected here so that a run of ``tests/`` runs them too: one class a
module, holding its tests; each module's fixtures, all of them autouse
there, are renamed after their module and used by its class alone, so
that one module's fixtures do not reach another's tests. Run them in
place with ``python -m pytest portbench/tests``."""

import importlib
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1] / "portbench" / "tests"


@pytest.fixture(autouse=True)
def _benchmark_process(monkeypatch):
    """The module table as the benchmark's own process has it, without
    JAX or the JAX package: ``tests/conftest.py`` loads JAX into this
    process, and the benchmark's tests read the table
    (``harness.forbidden_modules``). Restored after each test."""
    from portbench import harness

    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)


def _bring(name):
    mod = importlib.import_module(f"portbench.tests.{name}")
    attrs, uses = {"__module__": __name__}, []
    for key, obj in vars(mod).items():
        if key.startswith("test_") and callable(obj):
            attrs[key] = staticmethod(obj)
        elif hasattr(obj, "_fixture_function"):  # a pytest fixture
            fixture = f"{name}.{key}"
            globals()[fixture.replace(".", "__")] = pytest.fixture(
                name=fixture)(obj.__wrapped__)
            uses.append(fixture)
    title = name[len("test_portbench_"):].title().replace("_", "")
    cls = type("Test" + title, (), attrs)
    return pytest.mark.usefixtures(*uses)(cls) if uses else cls


for _path in sorted(HERE.glob("test_portbench_*.py")):
    _cls = _bring(_path.stem)
    globals()[_cls.__name__] = _cls
