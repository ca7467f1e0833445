"""The port's training loops against the JAX package's on the CPU:
``train_image`` and ``train_stem`` in both step modes, 2 iterations on
their synthetic batches, from the same initial weights and with the same
fed noise (tests/test_torch_train_step.py); a resumed run against an
uninterrupted one; the checkpoint round trip; ``parse_config``.

Small widths: MSH(16, 16), STEM (EB 16, M 16), 64×64 crops, batch 2; seed 3
subsamples the septuplets to frames (0, 3, 6) twice, so per_frame takes 4
updates. The loops cannot be synced between updates, so the first
update's sign-flipped near-zero gradients (see the step tests) move the
two models apart a little, and Adam turns any gradient difference into an
update difference of up to lr: the final metrics are held within 1e-4
relative, the parameters within 2·lr per update entry by entry and within
2 % of lr on average (MEAN_TOL), and the share past 1e-6 is printed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    STEMModule as JaxSTEM,
)
from spatiotemporalentropymodel_tpu.training.train_image import (
    train_image as jax_train_image,
)
from spatiotemporalentropymodel_tpu.training.train_stem import (
    train_stem as jax_train_stem,
)
from spatiotemporalentropymodel_tpu.utils import config as jax_config
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_param_paths, jax_tree, load_jax_leaves, load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior, STEMModule,
)
from spatiotemporalentropymodel_tpu_torch.training import (
    load_checkpoint, load_trees,
)
from spatiotemporalentropymodel_tpu_torch.training.train_image import (
    train_image,
)
from spatiotemporalentropymodel_tpu_torch.training.train_stem import (
    train_stem,
)
from spatiotemporalentropymodel_tpu_torch.utils import config as port_config

from torch_port_util import (  # noqa: F401 (fed_noise: a fixture)
    export_jax_tree, fed_noise, paths as _paths,
)

N = M = EBC = 16
LR = 1e-4
SEED = 3
METRIC_RTOL = 1e-4
# mean |Δparameter| over lr: measured 6e-6 (train_image), 5e-4
# (per_sequence) and 6e-3 (per_frame, 4 updates); a skipped update or
# another batch moves it to the order of 1
MEAN_TOL = 0.02


def _image_config(cls, workdir, **kw):
    return cls(cropsize=64, batch_size=2, seed=SEED, workdir=str(workdir),
               **kw)


def _stem_config(cls, workdir, **kw):
    return cls(in_channels=M, entropy_bottleneck_channels=EBC, cropsize=64,
               batch_size=2, seed=SEED, workdir=str(workdir), **kw)


def _assert_close_params(port_module, jax_params, updates):
    """Every entry within 2·lr per update (Adam moves an entry by about lr
    whatever its gradient), and the mean |Δ| within MEAN_TOL·lr; returns
    the share of entries past 1e-6."""
    port, ref = _paths(jax_tree(port_module)), _paths(jax_params)
    assert port.keys() == ref.keys()
    far = total = 0
    err_sum = 0.0
    for key, r in ref.items():
        err = np.abs(port[key] - r)
        assert float(err.max()) <= 2 * LR * updates, key
        far += int((err > 1e-6).sum())
        total += err.size
        err_sum += float(err.astype(np.float64).sum())
    assert err_sum / total <= MEAN_TOL * LR, err_sum / total
    return far / total


def _assert_metrics(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(port[k]), float(ref[k]),
                                   rtol=METRIC_RTOL)


@pytest.fixture(scope="module")
def i_params():
    """MSH(16, 16) weights drawn by the port, as the JAX tree."""
    return export_jax_tree(MeanScaleHyperprior(N, M, device="cpu").module)


def _jax_msh(params):
    model = JaxMSH(N, M)
    model.params = jax.tree_util.tree_map(jnp.asarray, params)
    return model


def _port_msh(params):
    model = MeanScaleHyperprior(N, M, device="cpu")
    load_jax_params(model.module, params)
    return model


@pytest.fixture(scope="module")
def stem_init():
    """The JAX train_stem's own STEM init (its first key split), carried
    into the port."""
    rng = jax.random.PRNGKey(SEED)
    _, k = jax.random.split(rng)
    d = jnp.zeros((1, 4, 4, M))
    module = JaxSTEM(variant="res", entropy_bottleneck_channels=EBC,
                     in_channels=M)
    params = jax.jit(lambda k: module.init({"params": k, "noise": k}, d, d,
                                           train=True)["params"])(k)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_stem(params):
    module = STEMModule("res", EBC, M)
    load_jax_params(module, params)
    return module


def test_train_image_matches_jax(fed_noise, i_params, tmp_path):
    state, metrics = jax_train_image(
        _image_config(jax_config.TrainImageConfig, tmp_path / "jax"),
        max_steps=2, model=_jax_msh(i_params))
    port = _port_msh(i_params)
    pstate, pmetrics = train_image(
        _image_config(port_config.TrainImageConfig, tmp_path / "port",
                      device="cpu"),
        max_steps=2, model=port)
    _assert_metrics(pmetrics, metrics)
    assert pstate.step == int(state.step) == 2
    far = _assert_close_params(port.module, state.params, 2)
    print(f"train_image: {far:.4%} of the entries past 1e-6")


@pytest.mark.parametrize("mode", ["per_frame", "per_sequence"])
def test_train_stem_matches_jax(fed_noise, i_params, stem_init, mode,
                                tmp_path):
    state, metrics = jax_train_stem(
        _stem_config(jax_config.TrainStemConfig, tmp_path / "jax",
                     step_mode=mode),
        max_steps=2, i_model=_jax_msh(i_params))
    module = _port_stem(stem_init)
    pstate, pmetrics = train_stem(
        _stem_config(port_config.TrainStemConfig, tmp_path / "port",
                     step_mode=mode, device="cpu"),
        max_steps=2, i_model=_port_msh(i_params), module=module)
    updates = 4 if mode == "per_frame" else 2
    assert pstate.step == int(state.step) == updates
    _assert_metrics(pmetrics, metrics)
    far = _assert_close_params(module, state.params, updates)
    print(f"train_stem {mode}: {far:.4%} of the entries past 1e-6")
    # both wrote their validation's checkpoint: the port's reads back
    ckpt = load_trees(tmp_path / "port" / "ckpt" / "stem_latest.pkl")
    assert int(ckpt["counters"]["iteration"]) == 2
    assert float(ckpt["scheduler"]["best"]) < np.inf


@pytest.mark.parametrize("mode", ["per_frame", "per_sequence"])
def test_train_stem_resume_equals_uninterrupted(i_params, mode, tmp_path):
    """3 iterations in one run, and 2 then a resumed 3rd from the
    checkpoint, with real noise draws: equal parameters and metrics."""
    cfg = dict(step_mode=mode, device="cpu")
    whole = _port_stem_run(i_params, tmp_path / "whole", 3, **cfg)
    _port_stem_run(i_params, tmp_path / "parts", 2, **cfg)
    parts = _port_stem_run(i_params, tmp_path / "parts", 3, resume=True,
                           **cfg)
    (ws, wm), (ps, pm) = whole, parts
    assert ws.step == ps.step
    for k in wm:
        assert torch.equal(wm[k], pm[k]), k
    for (name, a), b in zip(ws.module.named_parameters(),
                            ps.module.parameters()):
        assert torch.equal(a, b), name
    for opt_w, opt_p in zip(ws.optimizers[:2], ps.optimizers[:2]):
        for pw, pp in zip(opt_w.param_groups[0]["params"],
                          opt_p.param_groups[0]["params"]):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt_w.state[pw][key],
                                   opt_p.state[pp][key])


def _port_stem_run(i_params, workdir, steps, **kw):
    module = STEMModule("res", EBC, M, torch.Generator().manual_seed(1))
    return train_stem(
        _stem_config(port_config.TrainStemConfig, workdir, **kw),
        max_steps=steps, i_model=_port_msh(i_params), module=module)


def test_train_image_checkpoint_round_trip(i_params, tmp_path):
    """The checkpoint train_image writes reads back without jax: its
    train_state's first leaves load through load_jax_leaves to the trained
    parameters; the rest restores the optimizers; a resumed run goes on as
    an uninterrupted one."""
    cfg = _image_config(port_config.TrainImageConfig, tmp_path / "a",
                        device="cpu")
    port = _port_msh(i_params)
    state, _ = train_image(cfg, max_steps=2, model=port)
    path = tmp_path / "a" / "ckpt" / "image_latest.pkl"
    leaves = load_checkpoint(path)["train_state"]
    fresh = _port_msh(i_params)
    rest = load_jax_leaves(fresh.module, leaves)
    for (name, a), b in zip(port.module.named_parameters(),
                            fresh.module.parameters()):
        assert torch.equal(a, b), name
    assert len(rest) > len(jax_param_paths(fresh.module))  # Adam moments
    trees = load_trees(path)
    assert int(trees["train_state"][3]) == 2
    assert int(trees["counters"]["iteration"]) == 2

    resumed = dataclasses.replace(cfg, resume=True)
    _, m3 = train_image(resumed, max_steps=3, model=port)
    whole = _port_msh(i_params)
    _, w3 = train_image(dataclasses.replace(cfg, workdir=str(tmp_path / "b")),
                        max_steps=3, model=whole)
    for k in w3:
        assert torch.equal(w3[k], m3[k]), k
    for (name, a), b in zip(whole.module.named_parameters(),
                            port.module.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("cls", ["TrainImageConfig", "TrainStemConfig"])
def test_parse_config_matches_jax(cls):
    """The JAX package's fields and defaults, plus ``device`` (cuda), and
    the same command-line binding."""
    port_cls, jax_cls = getattr(port_config, cls), getattr(jax_config, cls)
    port_fields = {f.name: f.default for f in dataclasses.fields(port_cls)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(jax_cls)}
    assert port_fields.pop("device") == "cuda"
    assert port_fields == jax_fields
    assert port_config.parse_config(port_cls, []) == port_cls()
    argv = ["--cropsize", "128", "--learning-rate", "3e-5", "--resume",
            "true", "--seed", "7", "--device", "cpu"]
    got = port_config.parse_config(port_cls, argv)
    want = jax_config.parse_config(jax_cls, argv[:-2])
    assert {k: v for k, v in dataclasses.asdict(got).items()
            if k != "device"} == dataclasses.asdict(want)
    assert got.device == "cpu"
