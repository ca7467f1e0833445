"""The ROI family's evaluation, trainer, checkpoints and kernel dispatch
in the port against the JAX package's, on the CPU (the models of
tests/test_torch_roi.py: EB 16, M 12, the 128 trunk, tamed, random
biases).

  * ``eval_levels`` and ``eval_rc`` on a 2-frame GOP of 50 × 70 frames
    (padded centred to 64 × 128, cropped back): the same bpp (the same
    streams), PSNR within 1e-3 dB, the likelihoods' bpp within rtol 1e-3.
  * ``train_stem_roi`` runs both recipes for a step at 64² and writes a
    checkpoint whose first leaves load back to the trained I-model.
  * ``load_video_torch_checkpoint`` on a CompressAI-keyed state dict
    written from seeded weights through the JAX package's key maps
    (``stem``, ``stem-baseline``, ``stem-roi``): the port builds the JAX
    loader's parameters exactly and the same tables, and its compress
    gives the JAX loader's model's strings; the converter CLI writes a
    checkpoint the codec CLIs' loader reads back to the same parameters.
  * dispatch in bf16: each kernel wrapper called, at each width, where the
    JAX package's codec calls its Pallas kernel on a TPU; and at the
    workload's widths every layer pair stays within the port's kernels'
    gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatiotemporalentropymodel_tpu.models as jmodels
import spatiotemporalentropymodel_tpu.models.base as jax_base
import spatiotemporalentropymodel_tpu_torch.models as pmodels
from spatiotemporalentropymodel_tpu import zoo as jax_zoo
from spatiotemporalentropymodel_tpu.eval import eval_stem_roi as jeval
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch import zoo
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_leaves, jax_tree, load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.data import ArraySequence
from spatiotemporalentropymodel_tpu_torch.eval import eval_stem_roi as peval
from spatiotemporalentropymodel_tpu_torch.layers import (
    GDN, Conv, Deconv, Sequential,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_leaves
from spatiotemporalentropymodel_tpu_torch.training import (
    train_stem_roi as ptrain,
)
from spatiotemporalentropymodel_tpu_torch.training.checkpoints import (
    load_checkpoint,
)
from spatiotemporalentropymodel_tpu_torch.utils import config as pconfig
from spatiotemporalentropymodel_tpu_torch.zoo import convert as pconvert

from test_torch_image_ar_files import _compressai_state, _shape_init
from torch_port_util import (
    ROI_EBC, ROI_M, ROI_MODELS, bridge_roi, paths, roi_args, tame_roi,
    to_nchw,
)

DISPATCH_M, DISPATCH_HW = 192, (64, 128)


# ---- eval_stem_roi -------------------------------------------------------

@pytest.fixture(scope="module")
def roi_pair():
    """(JAX (I, P), port (I, P)): stem_roi_i and stem_roi."""
    ji, pi = bridge_roi("stem_roi_i", seed=3)
    jp, pp = bridge_roi("stem_roi", seed=4)
    return (ji, jp), (pi, pp)


def _gop():
    rng = np.random.default_rng(8)
    base = rng.random((50, 70, 3))
    frames = [np.clip(base + 0.03 * rng.standard_normal(base.shape), 0, 1)
              for _ in range(2)]
    return ArraySequence([(255 * f).astype(np.uint8) for f in frames], 2)


def _check_levels(got, want):
    assert got.keys() == want.keys()
    for level, ref in want.items():
        assert got[level]["bpp"] == ref["bpp"], level
        assert abs(got[level]["psnr"] - ref["psnr"]) <= 1e-3, level
        assert got[level]["estimate_bpp"] == pytest.approx(
            ref["estimate_bpp"], rel=1e-3), level


def test_eval_levels_matches_jax(roi_pair):
    """The horizontal gradient map (level −1; eval_rc below takes a uniform
    one): I-frame through stem_roi_i, P-frame conditioned on its padded
    reconstruction."""
    (ji, jp), (pi, pp) = roi_pair
    levels = [-1]
    want = jeval.eval_levels(ji, jp, [_gop()], levels)
    got = peval.eval_levels(pi, pp, [_gop()], levels)
    _check_levels(got, want)
    assert all(np.isfinite(v["psnr"]) and v["bpp"] > 0 for v in got.values())


def test_eval_rc_matches_jax(roi_pair):
    """The rate-control sweep at one target (0.45: the uniform map at
    level 45), in entropy-estimation mode (the forward's bpp, no coding)."""
    (ji, jp), (pi, pp) = roi_pair
    want = jeval.eval_rc(ji, jp, [_gop()], [0.45], entropy_estimation=True)
    got = peval.eval_rc(pi, pp, [_gop()], [0.45], entropy_estimation=True)
    assert list(got) == ["45.0"]
    for level, ref in want.items():
        assert got[level]["bpp"] == pytest.approx(ref["bpp"], rel=1e-3)
        assert abs(got[level]["psnr"] - ref["psnr"]) <= 1e-3


# ---- train_stem_roi ------------------------------------------------------

class _NullLogger:
    def __init__(self, workdir):
        pass

    def log(self, step, **metrics):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("mode", ["roi", "baseline"])
def test_train_stem_roi_runs_and_checkpoints(mode, tmp_path, monkeypatch):
    """One step of each recipe on the synthetic batches at 64²: finite
    metrics, and a checkpoint whose first leaves load back to the trained
    I-model. (The metrics logger is stubbed: its first use imports
    TensorBoard's writer, about 10 s here; tests/test_torch_train_loops.py
    covers it.)"""
    monkeypatch.setattr(ptrain, "MetricsLogger", _NullLogger)
    cfg = pconfig.TrainStemRoiConfig(
        mode=mode, in_channels=ROI_M, entropy_bottleneck_channels=ROI_EBC,
        cropsize=64, batch_size=1, device="cpu", workdir=str(tmp_path),
        loss_skip_threshold=1e9)
    modules = ptrain.build_modules(cfg, "cpu")
    for m in modules:
        tame_roi(m)
    (st_i, st_p), metrics = ptrain.train_stem_roi(cfg, 1, modules)
    assert st_i.step == st_p.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    leaves = load_checkpoint(tmp_path / "ckpt" / "stem_roi_latest.pkl")
    i_leaves = leaves["train_state_i"]
    mi = ptrain.build_modules(cfg, "cpu")[0]
    load_jax_leaves(mi, i_leaves)
    for a, b in zip(mi.parameters(), st_i.module.parameters()):
        assert torch.equal(a, b)


# ---- the video checkpoints -----------------------------------------------

# (zoo name, the JAX key map, constructor arguments)
VIDEO_CKPTS = {
    "stpm_res": ("stem", dict(entropy_bottleneck_channels=16,
                              in_channels=16)),
    "stem_baselinev2": ("stem-baseline",
                        dict(entropy_bottleneck_channels=ROI_EBC,
                             in_channels=ROI_M)),
    "stem_roi": ("stem-roi", dict(entropy_bottleneck_channels=ROI_EBC,
                                  in_channels=ROI_M)),
}


def _seeded(name, kw):
    model = zoo.stem_models.get(name) or zoo.roi_models[name]
    model = model(device="cpu", seed=9, **kw)
    if name.startswith("stem_"):
        tame_roi(model.module)
    model.update()
    return model


@pytest.mark.parametrize("name", VIDEO_CKPTS)
def test_load_video_checkpoint_matches_jax(name, tmp_path, monkeypatch):
    """The port's and the JAX package's load_video_torch_checkpoint on the
    same file (the tables shipped): the same parameters and tables, and the
    same strings."""
    monkeypatch.setattr(jax_base.CompressionModel, "init", _shape_init)
    key_map, kw = VIDEO_CKPTS[name]
    src = _seeded(name, kw)
    path = tmp_path / f"{name}.pth.tar"
    torch.save(_compressai_state(src, key_map, True), path)
    pm = zoo.load_video_torch_checkpoint(name, str(path), device="cpu", **kw)
    jm = jax_zoo.load_video_torch_checkpoint(name, str(path), **kw)
    got = {tuple(p): a for p, a in jax_leaves(pm.module)}
    want = paths(jm.params)
    assert got.keys() == want.keys()
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=str(key))
    assert pm.tables.keys() == jm.tables.keys()
    for k, t in jm.tables.items():
        for field, v in t.asdict().items():
            np.testing.assert_array_equal(getattr(pm.tables[k], field), v)
    if name == "stpm_res":
        rng = np.random.default_rng(2)
        args = [rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
                for _ in range(2)]
    else:
        args = roi_args(name, seed=2)
    enc = pm.compress(*map(to_nchw, args))
    assert enc["strings"] == jm.compress(*map(jnp.asarray, args))["strings"]


def test_convert_cli_writes_a_loadable_checkpoint(tmp_path, capsys):
    """The converter CLI (--video stem_roi): its file's "model" entry loads
    through load_state_leaves to the source parameters and tables; it
    refuses stpm_charm as the JAX package's does."""
    key_map, kw = VIDEO_CKPTS["stem_roi"]
    src = _seeded("stem_roi", kw)
    path, out = tmp_path / "roi.pth.tar", tmp_path / "roi.ckpt"
    torch.save(_compressai_state(src, key_map, True), path)
    pconvert.main([str(path), "-o", str(out), "--video", "stem_roi",
                   "--in-channels", str(ROI_M), "--ebc", str(ROI_EBC),
                   "--device", "cpu"])
    assert "stem_roi:" in capsys.readouterr().out
    model = zoo.roi_models["stem_roi"](device="cpu", **kw)
    model.load_state_leaves(load_checkpoint(out)["model"])
    for (n, a), b in zip(src.module.named_parameters(),
                         model.module.parameters()):
        assert torch.equal(a, b), n
    assert model.tables.keys() == src.tables.keys()
    with pytest.raises(SystemExit):
        pconvert.main([str(path), "-o", str(out), "--video", "stpm_charm",
                       "--device", "cpu"])


# ---- dispatch and the kernels' gates -------------------------------------

KERNELS = ("gdn_fused", "quantize_and_index", "gdn_conv_fused",
           "igdn_deconv_wide_packed", "igdn_deconv_tail_packed")


def _spy(monkeypatch, module, calls):
    """Count each wrapper's calls by name and, for the unpacked ones, the
    input's channels (and gdn_conv_fused's output channels)."""
    port = module is kernels
    for name in KERNELS:
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name):
            key = (_name,)
            if "packed" not in _name:
                key += (a[0].shape[1 if port else -1],)
            if _name == "gdn_conv_fused":
                key += (a[3].shape[0 if port else -1],)
            calls[key] = calls.get(key, 0) + 1
            return _real(*a)

        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("name", ["stem_baselinev2", "stem_roi"])
def test_bf16_dispatch_matches_jax(name, monkeypatch):
    """A bf16 compress and decompress call each kernel wrapper, at each
    width, as often as the JAX package's codec traces it on a TPU (its
    Pallas gates opened here: on the CPU they stay shut and its nets run
    unfused): the pixel encoders' GDN → conv stages as gdn_conv_fused
    (128 → 128 twice, then 128 → M), the pixel decoder's last two stages
    as the packed g_s pair, every GDN and IGDN that ends a Sequential as
    gdn_fused, and quantize_and_index once per compress. At M = 192, the
    workload's (the port has no 128 → 12 kernel), on a 64 × 128 frame,
    whose stages meet the TPU's tiling gates (the JAX trace only: no
    Pallas kernel runs). stem_baseline's chains are v2's; stem_roi_wo_gsc's
    and stem_roi_i's are stem_roi's without the decoder SFT or the
    ConditionEncoder, which add no kernel call of their own."""
    kw = dict(entropy_bottleneck_channels=ROI_EBC, in_channels=DISPATCH_M)
    jcls, pcls = ROI_MODELS[name]
    pm = getattr(pmodels, pcls)(device="cpu", seed=2, **kw)
    load_jax_params(pm.module, jax_tree(tame_roi(pm.module)))
    pm.update()
    jm = getattr(jmodels, jcls)(**kw)
    jm.params = jax.tree_util.tree_map(jnp.asarray, jax_tree(pm.module))
    jm.update()
    jm.set_compute_dtype(jnp.bfloat16)
    pm.set_compute_dtype(torch.bfloat16)
    args = roi_args(name, seed=6, hw=DISPATCH_HW)

    jcalls, pcalls = {}, {}
    monkeypatch.setattr(pk, "pallas_enabled", lambda: True)
    _spy(monkeypatch, pk, jcalls)
    jargs = [jnp.asarray(a) for a in args]
    jax.eval_shape(jm._fused_encode_fn(), *jargs)
    y_shape, z_shape = jm._latent_shapes(args[0].shape)
    y_cond = jnp.zeros(y_shape, jnp.bfloat16)
    if name != "stem_roi_i":
        y_cond = jax.eval_shape(lambda a: jm._apply(a, method="cond_latent"),
                                jargs[1])
    z_sym = jnp.zeros(z_shape, jnp.int16)
    jax.eval_shape(jm._fused_params_fn(), z_sym, y_cond)
    jax.eval_shape(jm._fused_finish_fn(), jnp.zeros(y_shape, jnp.int16),
                   jnp.zeros(y_shape, jnp.float32), z_sym)

    _spy(monkeypatch, kernels, pcalls)
    enc = pm.compress(*map(to_nchw, args))
    cond = () if name == "stem_roi_i" else (to_nchw(args[1]),)
    pm.decompress(enc["strings"], enc["shape"], *cond)
    assert pcalls == jcalls
    assert pcalls[("quantize_and_index", DISPATCH_M)] == 1


def test_full_width_models_stay_within_the_kernels_gates():
    """At the ROI workload's widths (EB 256, M 192, the 128 trunk) every
    GDN is 128 wide (CUDA gdn_fused takes C ≤ 192), every GDN → k5 s2 conv
    has a gdn_conv_fused pair, and every IGDN → k5 s2 deconv pair that the
    packed g_s chain would take (N → N, then N → ≤ 4) is one the wide and
    tail kernels take."""
    for name, build in zoo.roi_models.items():
        m = build(device="cpu")
        gdns = [g for g in m.module.modules() if isinstance(g, GDN)]
        assert gdns and {g.channels for g in gdns} == {128}, name
        for seq in m.module.modules():
            if not isinstance(seq, Sequential):
                continue
            layers = list(seq.layers)
            for a, b in zip(layers, layers[1:]):
                if isinstance(a, GDN) and isinstance(b, Conv) and \
                        b.weight.shape[-1] == 5 and not a.inverse:
                    assert kernels.gdn_conv_supported(*b.weight.shape[1::-1])
                if isinstance(a, GDN) and isinstance(b, Deconv) and a.inverse:
                    c, o = b.weight.shape[:2]
                    assert kernels.igdn_deconv_wide_supported(c, o) or \
                        kernels.igdn_deconv_tail_supported(c, o), name
