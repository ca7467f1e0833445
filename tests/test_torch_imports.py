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


def test_the_checks_cover_the_image_ar_modules():
    """The modules the autoregressive image models brought are among those
    checked above and below."""
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if p.is_relative_to(PORT)}
    assert {"layers/blocks.py", "models/waseda.py", "zoo/convert.py",
            "models/priors.py"} <= names


def test_the_checks_cover_the_roi_modules():
    """The modules the ROI family brought, data/qmap.py (NumPy only, copied
    rather than imported from the JAX package) among them, are among those
    checked above and below."""
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if p.is_relative_to(PORT)}
    assert {"models/stem_roi.py", "training/train_stem_roi.py",
            "eval/eval_stem_roi.py", "data/qmap.py", "data/vimeo.py",
            "zoo/__init__.py", "zoo/convert.py"} <= names


@pytest.mark.parametrize("name", ["stem_baseline", "stem_baselinev2",
                                  "stem_roi", "stem_roi_wo_gsc",
                                  "stem_roi_i"])
def test_roi_models_raise_without_card(name, tmp_path):
    """The ROI family and the video checkpoint loader are built on cuda
    unless told device="cpu": with no card they raise."""
    if torch_cuda_available():
        pytest.skip("a card is present; the model would be built on it")
    import torch

    from spatiotemporalentropymodel_tpu_torch import zoo

    with pytest.raises((RuntimeError, AssertionError)):
        zoo.roi_models[name](entropy_bottleneck_channels=16, in_channels=12)
    path = tmp_path / "m.pth.tar"
    torch.save({}, path)
    with pytest.raises((RuntimeError, AssertionError)):
        zoo.load_video_torch_checkpoint(name, str(path),
                                        entropy_bottleneck_channels=16,
                                        in_channels=12)
    assert zoo.roi_models[name](entropy_bottleneck_channels=16,
                                in_channels=12, device="cpu").device.type \
        == "cpu"


@pytest.mark.parametrize("name", ["mbt2018", "cheng2020-anchor",
                                  "cheng2020-attn"])
def test_ar_models_raise_without_card(name, tmp_path):
    """The zoo's autoregressive models and the checkpoint loader are built
    on cuda unless told device="cpu": with no card they raise."""
    if torch_cuda_available():
        pytest.skip("a card is present; the model would be built on it")
    import torch

    from spatiotemporalentropymodel_tpu_torch import zoo

    with pytest.raises((RuntimeError, AssertionError)):
        zoo.create_model(name, 1)
    path = tmp_path / "m.pth.tar"
    torch.save({}, path)
    with pytest.raises((RuntimeError, AssertionError)):
        zoo.load_torch_checkpoint(name, str(path))


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


@pytest.mark.parametrize("entry", ["train_image", "train_stem",
                                   "train_stem_roi"])
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
