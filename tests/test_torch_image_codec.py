"""The image models and the image file codec of the port against the JAX
package's, on the CPU, with the JAX weights carried across.

FactorizedPrior, ScaleHyperprior and MeanScaleHyperprior at (N, M) =
(8, 12), f32: forward likelihoods within 1e-5 and x̂ within 1e-4; the .bin
file of eval/codec.py::encode equals the JAX package's byte for byte and
each package's decode of the other's file gives x̂ within 1e-4; eval_model
on a folder of two PNGs gives the JAX figures (bpp rtol 1e-3, PSNR within
1e-3 dB); the CLI with the hero I checkpoint installs its tables and
writes the JAX CLI's file. The zoo's ids and configurations, and the
compat coder shims' bytes, equal the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spatiotemporalentropymodel_tpu import zoo as jax_zoo
from spatiotemporalentropymodel_tpu.coders import compat as jax_compat
from spatiotemporalentropymodel_tpu.eval import codec as jax_codec
from spatiotemporalentropymodel_tpu.eval import eval_model as jax_eval
from spatiotemporalentropymodel_tpu_torch import zoo
from spatiotemporalentropymodel_tpu_torch.coders import compat
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.data.png import write_png
from spatiotemporalentropymodel_tpu_torch.eval import codec, eval_model
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    structured_frames,
)

from torch_port_util import jax_tree_numpy, to_nchw, to_nhwc

N, M = 8, 12
NAMES = ("bmshj2018-factorized", "bmshj2018-hyperprior", "mbt2018-mean")


def _pair(name):
    """The JAX model at its initialisation and the port's with its
    weights, both with their tables."""
    jm = jax_zoo.model_architectures[name](N, M)
    jm.init(jnp.zeros((1, 64, 64, 3)))
    jm.update()
    pm = zoo.model_architectures[name](N, M, device="cpu")
    load_jax_params(pm.module, jax_tree_numpy(jm.params))
    pm.update()
    return jm, pm


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in NAMES}


def _image(h, w, seed=0):
    return structured_frames(np.random.default_rng(seed), 1, (h, w))[0]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hw", [(64, 64), (60, 62)])
def test_forward_matches_jax(pairs, name, hw):
    jm, pm = pairs[name]
    x = (_image(*hw, seed=1).astype(np.float32) / 255.0)[None]
    want = jm.forward(jnp.asarray(x))
    got = pm.forward(to_nchw(x))
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for key, lk in want["likelihoods"].items():
        np.testing.assert_allclose(to_nhwc(got["likelihoods"][key]),
                                   np.asarray(lk), atol=1e-5)
    np.testing.assert_allclose(to_nhwc(got["x_hat"]),
                               np.asarray(want["x_hat"]), atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_bin_file_equals_jax_and_cross_decodes(pairs, name, tmp_path):
    jm, pm = pairs[name]
    img = tmp_path / "img.png"
    write_png(img, _image(60, 62, seed=2))
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    codec.encode(img, ours, name, quality=1, model=pm, device="cpu")
    jax_codec.encode(img, theirs, name, quality=1, model=jm)
    assert ours.read_bytes() == theirs.read_bytes()
    if name == "bmshj2018-factorized":  # one string group, y's shape
        assert ours.read_bytes()[10:22] == bytes.fromhex(
            "00000004" "00000004" "00000001")
    got = codec.decode(theirs, model=pm, device="cpu")
    want = jax_codec.decode(ours, model=jm)
    assert got.shape == (1, 60, 62, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_zoo_ids_and_cfgs_equal_jax():
    assert codec.model_ids == jax_codec.model_ids
    assert zoo.cfgs == jax_zoo.cfgs
    assert list(zoo.stem_models) == list(jax_zoo.stem_models)
    for name in ("mbt2018", "cheng2020-anchor", "cheng2020-attn"):
        model = zoo.create_model(name, 1, device="cpu")
        assert type(model).__name__ == type(
            jax_zoo.create_model(name, 1)).__name__
    with pytest.raises(NotImplementedError, match="charm"):
        zoo.stem_models["stpm_charm"](device="cpu")


@pytest.mark.parametrize("estimation", [False, True])
def test_eval_model_matches_jax(pairs, estimation, tmp_path):
    jm, pm = pairs["bmshj2018-hyperprior"]
    for i in range(2):
        write_png(tmp_path / f"im{i}.png", _image(64, 64, seed=3 + i))
    files = eval_model.collect_images(str(tmp_path))
    assert files == jax_eval.collect_images(str(tmp_path))
    got = eval_model.eval_model(pm, files, estimation)
    want = jax_eval.eval_model(jm, files, estimation)
    assert got["bpp"] == pytest.approx(want["bpp"], rel=1e-3)
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-3)
    assert np.isnan(got["ms-ssim"]) and np.isnan(want["ms-ssim"])  # < 161²


def test_eval_model_main_and_non_png(tmp_path):
    write_png(tmp_path / "a.png", _image(64, 64))
    res = eval_model.main([str(tmp_path), "-a", "bmshj2018-factorized",
                           "-q", "1", "--entropy-estimation",
                           "--device", "cpu"])
    assert res["name"] == "bmshj2018-factorized"
    assert np.isfinite(res["results"]["bpp"][0])
    (tmp_path / "b.jpg").write_bytes(b"")
    with pytest.raises(ValueError, match="PNG"):
        eval_model.main([str(tmp_path), "-a", "bmshj2018-factorized",
                         "--device", "cpu"])


def test_compat_shims_give_jax_bytes(pairs):
    _, pm = pairs["bmshj2018-hyperprior"]
    t = pm.tables["gaussian_conditional"]
    rng = np.random.default_rng(0)
    n = 500
    idx = rng.integers(0, t.rows, n)
    sym = np.clip(np.round(rng.standard_normal(n) * 3), -20, 20).astype(int)
    # the tables' padded rows (the JAX shim's ragged-list path needs a
    # NumPy that builds ragged object arrays; the port's takes both)
    args = (sym.tolist(), idx.tolist(), t.cdf.tolist(),
            t.cdf_length.tolist(), t.offset.tolist())
    ours = compat.RansEncoder().encode_with_indexes(*args)
    assert ours == jax_compat.RansEncoder().encode_with_indexes(*args)
    ragged = [list(map(int, r[:ln])) for r, ln in zip(t.cdf, t.cdf_length)]
    assert ours == compat.RansEncoder().encode_with_indexes(
        args[0], args[1], ragged, *args[3:])

    eb = pm.tables["entropy_bottleneck"]
    eb_args = ([0, 1, -1, 2] * 4, [0, 1, 2, 3] * 4, eb.cdf.tolist(),
               eb.cdf_length.tolist(), eb.offset.tolist())
    streams = []
    for mod in (compat, jax_compat):
        enc = mod.BufferedRansEncoder()
        enc.encode_with_indexes(*args)
        enc.encode_with_indexes(*eb_args)  # another table: merged rows
        streams.append(enc.flush())
    assert streams[0] == streams[1]

    dec_args = args[1:]
    assert (compat.RansDecoder().decode_with_indexes(ours, *dec_args)
            == jax_compat.RansDecoder().decode_with_indexes(ours, *dec_args)
            == sym.tolist())
    got, want = compat.RansDecoder(), jax_compat.RansDecoder()
    got.set_stream(ours)
    want.set_stream(ours)
    half = [a[:n // 2] if i == 0 else a for i, a in enumerate(dec_args)]
    assert got.decode_stream(*half) == want.decode_stream(*half) \
        == sym[:n // 2].tolist()


def test_bf16_round_trip():
    """After set_compute_dtype(bf16) the image models still code: a
    compress/decompress round trip with finite x̂ (the gates of the fused
    kernels run their plain versions on the CPU)."""
    import torch

    for name in NAMES:
        pm = zoo.create_model(name, 1, device="cpu")
        pm.update()
        pm.set_compute_dtype(torch.bfloat16)
        x = to_nchw((_image(64, 64).astype(np.float32) / 255.0)[None])
        enc = pm.compress(x)
        x_hat = pm.decompress(enc["strings"], enc["shape"])["x_hat"]
        assert x_hat.shape == (1, 3, 64, 64)
        assert bool(torch.isfinite(x_hat.float()).all())


def test_cli_with_the_hero_checkpoint_writes_the_jax_file(tmp_path):
    """``main`` with the hero I checkpoint (mbt2018-mean, quality 3): the
    checkpoint's parameters and its codec tables are installed, as the JAX
    CLI's load_state_dict installs them, and the .bin file equals the JAX
    CLI's byte for byte; its decode writes the PNG of x̂."""
    from spatiotemporalentropymodel_tpu_torch.data.png import read_png
    from spatiotemporalentropymodel_tpu_torch.eval.workload import HERO_DIR
    from spatiotemporalentropymodel_tpu_torch.training.checkpoints import (
        load_checkpoint,
    )

    ckpt = str(HERO_DIR / "ckpt_i_0.012.pkl.gz")
    model = codec._build_model("mbt2018-mean", 3, ckpt, "cpu")
    leaves = load_checkpoint(ckpt)["model"]
    tables = model.tables
    want = leaves[-8:]
    got = [tables["entropy_bottleneck"].cdf,
           tables["entropy_bottleneck"].cdf_length,
           tables["entropy_bottleneck"].medians,
           tables["entropy_bottleneck"].offset,
           tables["gaussian_conditional"].cdf,
           tables["gaussian_conditional"].cdf_length,
           tables["gaussian_conditional"].offset,
           tables["gaussian_conditional"].scale_table]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    img = tmp_path / "img.png"
    write_png(img, _image(64, 64, seed=6))
    args = ["--model", "mbt2018-mean", "--quality", "3", "--checkpoint", ckpt]
    codec.main(["encode", str(img), "-o", str(tmp_path / "port.bin"), *args,
                "--device", "cpu"])
    jax_codec.main(["encode", str(img), "-o", str(tmp_path / "jax.bin"),
                    *args])
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    codec.main(["decode", str(tmp_path / "jax.bin"), "-o",
                str(tmp_path / "rec.png"), "--checkpoint", ckpt, "--device",
                "cpu"])
    x_hat = codec.decode(tmp_path / "jax.bin", model=model, device="cpu")
    np.testing.assert_array_equal(read_png(tmp_path / "rec.png"),
                                  codec.to_png_array(x_hat[0]))
