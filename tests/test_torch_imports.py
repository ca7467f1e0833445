"""The port stands alone: no jax, no flax, nothing of the JAX package
(spatiotemporalentropymodel_tpu), and no PIL (the card's machine has none;
data/png.py reads and writes the images) but inside the functions of
eval/bench_codecs.py, whose Pillow codecs need it. The port's sub-packages
export the JAX package's public names."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spatiotemporalentropymodel_tpu_torch"
FORBIDDEN = ("jax", "flax", "spatiotemporalentropymodel_tpu", "PIL")


def _sources():
    return sorted(PORT.rglob("*.py"))


# the one place PIL may be imported: inside the functions of this file
PIL_USER = PORT / "eval" / "bench_codecs.py"


def _imports(path):
    """(module, inside a function?) of every import in ``path``."""
    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            nested = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                yield from ((a.name, in_function) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, in_function
            yield from walk(child, nested)

    yield from walk(ast.parse(path.read_text(), str(path)), False)


def _imported_modules(path):
    return (m for m, _ in _imports(path))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m, in_function in _imports(path)
           if m.split(".")[0] in FORBIDDEN
           and not (m.split(".")[0] == "PIL" and in_function
                    and path == PIL_USER)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_pil_only_inside_bench_codecs_functions():
    """PIL is imported by eval/bench_codecs.py alone, only inside a
    function, and not at all by any other file (the check above would
    pass a module-level import nowhere)."""
    users = {p: [f for m, f in _imports(p) if m.split(".")[0] == "PIL"]
             for p in _sources()}
    assert {p for p, found in users.items() if found} == {PIL_USER}
    assert all(users[PIL_USER])


def test_bench_codecs_raise_without_pil(tmp_path):
    """With PIL blocked the whole port imports and a Pillow codec raises
    ImportError naming Pillow, as an absent codec program raises
    RuntimeError."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\nsys.modules['jax'] = None\n"
        "import spatiotemporalentropymodel_tpu_torch.eval as ev\n"
        "from spatiotemporalentropymodel_tpu_torch.eval import bench_codecs\n"
        "for name in ('jpeg', 'webp', 'jpeg2000'):\n"
        "    try:\n"
        f"        bench_codecs.get_codec(name).run({str(tmp_path / 'a.png')!r},"
        " 30)\n"
        "    except ImportError as e:\n"
        "        assert 'Pillow' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit(name + ' ran without PIL')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _all_names(init):
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return set()


@pytest.mark.parametrize("package", ["parallel", "eval", "data", "layers",
                                     "ops"])
def test_public_names_match_the_jax_package(package):
    """Every name of the JAX sub-package's ``__all__`` (read with ast, not
    imported) is in the port's ``__all__`` and importable from it."""
    import importlib

    want = _all_names(ROOT / "spatiotemporalentropymodel_tpu" / package
                      / "__init__.py")
    have = _all_names(PORT / package / "__init__.py")
    assert want and not want - have, sorted(want - have)
    mod = importlib.import_module(
        f"spatiotemporalentropymodel_tpu_torch.{package}")
    assert all(hasattr(mod, name) for name in have)


def test_the_checks_cover_the_parallel_and_eval_tool_modules():
    """The modules of the last slice (the meshes, spatial splitting, the
    eval tools, the colour transforms) are among those checked above and
    below."""
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if p.is_relative_to(PORT)}
    assert {"parallel/mesh.py", "parallel/spatial.py",
            "parallel/train_step.py", "eval/update_model.py",
            "eval/bench_codecs.py", "eval/find_close.py", "eval/plot.py",
            "eval/rd_data.py", "data/transforms.py", "layers/gdn.py",
            "ops/bound.py"} <= names


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


def test_the_checks_cover_the_charm_modules():
    """The modules charm, the coders and the GOP eval's CLI brought,
    coders/_numpy_rans.py (copied rather than imported from the JAX
    package) among them, are among those checked above and below."""
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if p.is_relative_to(PORT)}
    assert {"models/charm.py", "coders/_numpy_rans.py", "coders/__init__.py",
            "coders/rans.py", "entropy/transport.py", "eval/eval_stem.py",
            "eval/video_codec.py", "utils/config.py"} <= names


def test_charm_and_eval_stem_raise_without_card(tmp_path):
    """The zoo's charm and eval_stem's CLI run on cuda unless told
    device="cpu": with no card they raise rather than run on the CPU."""
    if torch_cuda_available():
        pytest.skip("a card is present; the model would be built on it")
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.eval import eval_stem

    with pytest.raises((RuntimeError, AssertionError)):
        zoo.stem_models["stpm_charm"](entropy_bottleneck_channels=16,
                                      in_channels=16)
    with pytest.raises((RuntimeError, AssertionError)):
        eval_stem.main(["--dataset-root", str(tmp_path)])
    assert zoo.stem_models["stpm_charm"](
        entropy_bottleneck_channels=16, in_channels=16,
        device="cpu").device.type == "cpu"


def test_update_model_raises_without_card(tmp_path, monkeypatch):
    """update_model's CLI builds its model on cuda unless told --device
    cpu: with no card it raises, and with --device cpu it exports."""
    if torch_cuda_available():
        pytest.skip("a card is present; the model would be built on it")
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.eval import update_model
    from spatiotemporalentropymodel_tpu_torch.training import (
        save_checkpoint,
    )

    arch = "bmshj2018-factorized"
    monkeypatch.setitem(zoo.cfgs[arch], 1, (8, 12))
    ckpt = tmp_path / "m.pkl"
    save_checkpoint({"model": zoo.create_model(arch, 1, device="cpu")
                     .state_tree()}, ckpt)
    argv = [str(ckpt), "-a", arch, "-d", str(tmp_path / "out")]
    with pytest.raises((RuntimeError, AssertionError)):
        update_model.main(argv)
    update_model.main(argv + ["--device", "cpu"])
    assert len(list((tmp_path / "out").glob(f"{arch}-*.pkl"))) == 1


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
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


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
