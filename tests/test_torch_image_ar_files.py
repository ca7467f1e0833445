"""The files and checkpoints of the port's autoregressive image models
against the JAX package's, on the CPU.

The .bin files of eval/codec.py for mbt2018 (8, 12) and both Cheng2020
models (16) equal the JAX package's byte for byte, and each package
decodes the other's file (x̂ within 1e-4); their weights cross the bridge
both ways in jax's leaf order, and params_hash equals the JAX package's in
f32 and bf16. A .stemv file with an mbt2018
I-model equals the JAX package's in both wavefront wire orders, flag bit 0
set for the grouped one; each decoder takes the order from the header;
models that disagree on the order are refused. ``load_torch_checkpoint``
of the six image architectures from a CompressAI-keyed ``.pth.tar``
written here (from the port's seeded weights through the JAX package's key
maps), with and without shipped CDF tables: the JAX loader's parameters and
tables, and the same strings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu import zoo as jax_zoo
from spatiotemporalentropymodel_tpu.eval import codec as jax_codec
from spatiotemporalentropymodel_tpu.eval import video_codec as jvc
from spatiotemporalentropymodel_tpu.models import base as jax_base
from spatiotemporalentropymodel_tpu.models import (
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu.zoo import convert as jax_convert
from spatiotemporalentropymodel_tpu_torch import zoo
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_leaves,
    jax_tree,
    load_jax_leaves,
    load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.data.png import write_png
from spatiotemporalentropymodel_tpu_torch.eval import codec
from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
from spatiotemporalentropymodel_tpu_torch.models import (
    SpatioTemporalPriorModel,
)

from torch_port_util import AR_MODELS, ar_image, bridge_ar, paths, to_nchw

M = 12


@pytest.fixture(scope="module")
def pairs():
    """name → (JAX model, port model), shared so the JAX side compiles its
    codec once per model."""
    return {name: bridge_ar(name, seed=3) for name in AR_MODELS}


@pytest.mark.parametrize("name", AR_MODELS)
def test_bin_file_equals_jax_and_cross_decodes(pairs, name, tmp_path):
    jm, pm = pairs[name]
    img = tmp_path / "img.png"
    write_png(img, (ar_image(hw=62, seed=2)[0, :, :60] * 255).astype(
        np.uint8))
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    codec.encode(img, ours, name, quality=1, model=pm, device="cpu")
    jax_codec.encode(img, theirs, name, quality=1, model=jm)
    assert ours.read_bytes() == theirs.read_bytes()
    got = codec.decode(theirs, model=pm, device="cpu")
    want = jax_codec.decode(ours, model=jm)
    assert got.shape == (1, 62, 60, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", AR_MODELS)
def test_params_hash_and_leaves_match_jax(pairs, name):
    """The weight bridge both ways: the JAX tree's leaves in jax's flatten
    order load into a fresh port model (convert.load_jax_leaves), and
    params_hash (the .stemv header's, over convert.jax_leaves) equals the
    JAX package's in f32 and, after set_compute_dtype, in bf16."""
    jm, pm = pairs[name]
    fresh = AR_MODELS[name][1](seed=9)
    assert load_jax_leaves(fresh.module,
                           jax.tree_util.tree_leaves(jm.params)) == []
    for a, b in zip(fresh.module.parameters(), pm.module.parameters()):
        assert torch.equal(a, b)
    jm2, pm2 = AR_MODELS[name][0](), fresh
    jm2.params = jm.params
    assert vc.params_hash(pm2) == jvc.params_hash(jm2)
    jm2.set_compute_dtype(jnp.bfloat16)
    pm2.set_compute_dtype(torch.bfloat16)
    assert vc.params_hash(pm2) == jvc.params_hash(jm2)


# ---- .stemv with an AR I-model -------------------------------------------

@pytest.fixture(scope="module")
def stems():
    """A without_spm STEM (M 12, EB 16, its weights × 0.01 as
    tests/test_video_codec.py scales them) in both packages."""
    p_s = SpatioTemporalPriorModel(variant="without_spm",
                                   entropy_bottleneck_channels=16,
                                   in_channels=M, device="cpu", seed=5)
    tree = jax.tree_util.tree_map(lambda a: a * np.float32(0.01),
                                  jax_tree(p_s.module))
    load_jax_params(p_s.module, tree)
    p_s.update()
    j_s = JaxStem(variant="without_spm", entropy_bottleneck_channels=16,
                  in_channels=M)
    j_s.params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_s.update()
    return j_s, p_s


@pytest.mark.parametrize("fmt", ["lane", "grouped"])
def test_stemv_with_mbt2018_i_model_equals_jax(pairs, stems, tmp_path, fmt):
    """mbt2018 (8, 12) as the I-model of both packages, in the wire order
    ``fmt``: flag bit 0 records its y streams' order; each decoder takes
    the order from the header (its models set to the other) and restores
    its models' own."""
    (j_i, p_i), (j_s, p_s) = pairs["mbt2018"], stems
    for m in (j_i, p_i):
        m.wavefront_format = fmt
    base = ar_image(hw=62, seed=6)[0, :, :60]
    frames = [np.clip(base + 0.01 * t, 0, 1) for t in range(3)]
    meta = {"i_model": "mbt2018", "i_quality": 1}
    ours, theirs = tmp_path / "port.stemv", tmp_path / "jax.stemv"
    vc.encode_video(frames, p_i, p_s, ours, gop=3, meta=meta)
    jvc.encode_video(frames, j_i, j_s, theirs, gop=3, meta=meta)
    data = ours.read_bytes()
    assert data == theirs.read_bytes()
    assert data[15] == (fmt == "grouped")  # flags
    assert data[5] == list(codec.model_ids).index("mbt2018")
    other = "lane" if fmt == "grouped" else "grouped"
    for m in (p_i, j_i):
        m.wavefront_format = other
    got = vc.decode_video(theirs, p_i, p_s)
    want = jvc.decode_video(ours, j_i, j_s)
    assert p_i.wavefront_format == other
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=1e-4)
    j_i.wavefront_format = p_i.wavefront_format = "auto"


def test_stemv_refuses_models_that_disagree_on_wire_order(tmp_path):
    p_i = AR_MODELS["mbt2018"][1](seed=4)
    p_i.update()
    p_s = SpatioTemporalPriorModel(variant="res",
                                   entropy_bottleneck_channels=16,
                                   in_channels=M, device="cpu")
    p_s.update()
    p_i.wavefront_format, p_s.wavefront_format = "lane", "grouped"
    with pytest.raises(ValueError, match="disagree"):
        vc.encode_video([ar_image(hw=64)[0]], p_i, p_s,
                        tmp_path / "x.stemv", gop=1)


# ---- CompressAI checkpoints ----------------------------------------------

# quality per architecture: the 192-wide configurations, whose layer
# shapes the six share, so the JAX side compiles each shape once
CKPT_QUALITY = {"bmshj2018-factorized": 6, "bmshj2018-hyperprior": 6,
                "mbt2018-mean": 5, "mbt2018": 5, "cheng2020-anchor": 4,
                "cheng2020-attn": 4}
# CompressAI's buffer → the codec tables' field
TABLE_BUFFERS = {"_quantized_cdf": "cdf", "_cdf_length": "cdf_length",
                 "_offset": "offset"}


def _compressai_state(model, arch, with_tables):
    """The model's weights as a CompressAI state dict: each parameter's
    JAX path through the JAX package's key map, in torch's layout (its
    inverse transforms), under a DataParallel ``module.`` prefix; with
    ``with_tables`` the codec tables as the buffers CompressAI ships."""
    key_map = jax_convert.KEY_MAPS[arch]
    state = {}
    for path, arr in jax_leaves(model.module):
        key, kind = key_map(path)
        if kind == "conv":
            arr = jax_convert.invert_conv_weight(arr)
        elif kind == "deconv":
            arr = jax_convert.invert_deconv_weight(arr)
        state[f"module.{key}"] = torch.from_numpy(np.array(arr))
    if with_tables:
        for name, t in model.tables.items():
            for buf, field in TABLE_BUFFERS.items():
                state[f"module.{name}.{buf}"] = torch.from_numpy(
                    getattr(t, field))
        state["module.gaussian_conditional.scale_table"] = torch.from_numpy(
            model.tables["gaussian_conditional"].scale_table)
    return {"state_dict": state}


def _shape_init(self, *example_args):
    """The JAX model's parameters as zeros of their shapes: the JAX loader
    only takes the init's tree as the template it fills from the
    checkpoint (zoo/convert.py::convert_state_dict), and an eager init at
    full width costs 5-25 s here."""
    shapes = jax.eval_shape(lambda *a: self.module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        *a, train=False), *example_args)
    self.params = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes["params"])
    return self.params


@pytest.mark.parametrize("arch", list(CKPT_QUALITY))
def test_load_torch_checkpoint_matches_jax(arch, tmp_path, monkeypatch):
    """The port's and the JAX package's load_torch_checkpoint on the same
    file: the same parameters (the JAX layout, exactly), the same tables
    (shipped for half the architectures, rebuilt by update() for the
    others), and the same strings of one 64² picture."""
    monkeypatch.setattr(jax_base.CompressionModel, "init", _shape_init)
    q = CKPT_QUALITY[arch]
    with_tables = arch in ("bmshj2018-hyperprior", "mbt2018",
                           "cheng2020-attn")
    src = zoo.create_model(arch, q, device="cpu", seed=7)
    if with_tables:
        src.update()
    path = tmp_path / f"{arch}.pth.tar"
    torch.save(_compressai_state(src, arch, with_tables), path)
    pm = zoo.load_torch_checkpoint(arch, str(path), q, device="cpu")
    jm = jax_zoo.load_torch_checkpoint(arch, str(path), q)
    got = {tuple(p): a for p, a in jax_leaves(pm.module)}
    want = paths(jm.params)
    assert got.keys() == want.keys()
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=str(key))
    assert pm.tables.keys() == jm.tables.keys()
    for name, t in jm.tables.items():
        for field, arr in t.asdict().items():
            np.testing.assert_array_equal(pm.tables[name].asdict()[field],
                                          arr, err_msg=f"{name}.{field}")
    x = ar_image(hw=64, seed=8)
    assert (pm.compress(to_nchw(x))["strings"]
            == jm.compress(jnp.asarray(x))["strings"])


def test_load_torch_checkpoint_refuses_a_wrong_file(tmp_path):
    state = _compressai_state(zoo.create_model("mbt2018", 1, device="cpu"),
                              "mbt2018", False)["state_dict"]
    path = tmp_path / "m.pth.tar"
    torch.save({k: v for k, v in state.items()
                if "context_prediction" not in k}, path)
    with pytest.raises(KeyError, match="context_prediction"):
        zoo.load_torch_checkpoint("mbt2018", str(path), 1, device="cpu")
    torch.save(state, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        zoo.load_torch_checkpoint("mbt2018", str(path), 5, device="cpu")
