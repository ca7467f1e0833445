"""The port and chip_smoke.py stand alone: no jax, no flax, nothing of the
JAX package (spatiotemporalentropymodel_tpu), and no PIL (the card's
machine has none; data/png.py reads and writes the images); and
chip_smoke.py fails, with no result line, where it cannot run the port on
a card."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spatiotemporalentropymodel_tpu_torch"
FORBIDDEN = ("jax", "flax", "spatiotemporalentropymodel_tpu", "PIL")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing jax,
    flax or PIL fails, and none of them pulls in the JAX package."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\nsys.modules['flax'] = None\n"
        "sys.modules['PIL'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "assert 'spatiotemporalentropymodel_tpu' not in sys.modules\n"
        "import chip_smoke\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_port(alone, tmp_path):
    """In the checkout on a machine without CUDA, and copied alone into an
    empty directory, chip_smoke.py exits non-zero and prints no result."""
    if torch_cuda_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def torch_cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.mark.parametrize("entry", ["train_image", "train_stem"])
def test_trainers_raise_without_card(entry, tmp_path):
    """The trainers run on cuda unless told device="cpu": with no card
    they raise at once rather than train on the CPU."""
    if torch_cuda_available():
        pytest.skip("a card is present; the trainer would run for real")
    import importlib

    mod = importlib.import_module(
        f"spatiotemporalentropymodel_tpu_torch.training.{entry}")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(["--workdir", str(tmp_path)])
