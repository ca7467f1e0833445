"""The .stemv video codec of the port (eval/video_codec.py) against the JAX
package's, on the CPU.

The port's copies of the tests/test_video_codec.py cases it can run (dense
records, a round trip at 60×62, the weight-hash guard, the tiled res at
(2, 4)); ``params_hash`` equal to the JAX package's for MSH and every STEM
variant in f32 and bf16; each package decodes the other's files with the
hash check on (within 1e-4); on a 64×64 crop of the hero eval frames, f32,
GOP 3, the port's file equals the JAX package's byte for byte in families
0 and 1; family 2 (charm, records 4 and 5) byte for byte at 60×62 and
decoded by each package from the other's file; and the CLI's ``main``
round-trips a folder of PNGs, also with ``--stem-family charm``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval import video_codec as jvc
from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    SpatioTemporalPriorModel as JaxStem,
    SpatioTemporalPriorModelChannelAR as JaxCharm,
)
from spatiotemporalentropymodel_tpu.training.checkpoints import (
    load_checkpoint as jax_load_checkpoint,
)
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_tree,
    load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.data.png import read_png, write_png
from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    StemVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    HERO_DIR,
    hero_config,
    hero_gop_set,
    load_hero,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
    SpatioTemporalPriorModelChannelAR,
)
from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

from torch_port_util import jax_tree_numpy, to_nchw

M = 12
VARIANTS = ("without_spm_tpm", "without_spm", "without_tpm", "full", "res")


# ---- the port alone: copies of tests/test_video_codec.py -------------------

def _scale(model, factor):
    with torch.no_grad():
        for p in model.module.parameters():
            p.mul_(factor)


def _models(variant="without_spm", tile=None, scaled=True):
    """The small models of tests/test_video_codec.py (N 8, M 12, EB 16),
    weights scaled by 0.05 and 0.01 as there, on the CPU."""
    i_model = MeanScaleHyperprior(8, M, device="cpu")
    stem = SpatioTemporalPriorModel(
        variant=variant, entropy_bottleneck_channels=16, in_channels=M,
        wavefront_tile=tile, device="cpu", seed=1)
    if scaled:
        _scale(i_model, 0.05)
        _scale(stem, 0.01)
    i_model.update()
    stem.update()
    return i_model, stem


def _records(path, n):
    with open(path, "rb") as f:
        hdr = vc.read_header(f)
        return hdr, [vc._read_frame(f) for _ in range(n)]


def _padded(frame):
    return pad_centered(to_nchw(np.asarray(frame, np.float32)[None]), 64)[0]


def test_stemv_dense_fallback_records(tmp_path):
    """Unscaled models overflow int8 → P-frames file as dense records
    (ftype 2) and still decode, the carry taken from a decode."""
    i_model, stem = _models(scaled=False)
    rng = np.random.default_rng(3)
    frames = [rng.random((64, 64, 3)).astype(np.float32) for _ in range(3)]
    out = tmp_path / "dense.stemv"
    vc.encode_video(frames, i_model, stem, out, gop=3)
    _, records = _records(out, 3)
    assert [r[0] for r in records] == [0, 2, 2]
    decoded = vc.decode_video(out, i_model, stem)
    assert len(decoded) == 3 and all(np.isfinite(f).all() for f in decoded)


def test_stemv_roundtrip(tmp_path):
    """encode → file → decode at a non-×64 size across an I-frame refresh:
    the P record's streams and counts are the pipeline's, and the decoded
    PNGs are the decoded frames converted as decode_video converts them."""
    i_model, stem = _models()
    rng = np.random.default_rng(0)
    base = rng.random((60, 62, 3)).astype(np.float32)
    frames = [np.clip(base + 0.01 * t, 0, 1) for t in range(5)]
    out = tmp_path / "seq.stemv"
    stats = vc.encode_video(frames, i_model, stem, out, gop=3)
    assert stats["frames"] == 5 and stats["bytes"] == out.stat().st_size
    decoded = vc.decode_video(out, i_model, stem, output_dir=tmp_path / "rec")
    assert [f.shape for f in decoded] == [(60, 62, 3)] * 5
    names = sorted(p.name for p in (tmp_path / "rec").iterdir())
    assert names == [f"frame_{i:04d}.png" for i in range(5)]
    for name, fr in zip(names, decoded):
        np.testing.assert_array_equal(read_png(tmp_path / "rec" / name),
                                      (np.clip(fr, 0, 1) * 255)
                                      .astype(np.uint8))

    pipe = StemVideoPipeline(i_model, stem)
    enc0 = i_model.compress(_padded(frames[0]))
    y_cond = i_model.decompress(enc0["strings"], enc0["shape"])["y_hat"]
    enc1, _ = pipe.encode_frame(_padded(frames[1]), y_cond)
    hdr, records = _records(out, 2)
    assert (hdr["n_frames"], hdr["h"], hdr["w"]) == (5, 60, 62)
    ftype, _, counts, strings = records[1]
    assert ftype == 1
    assert strings[0][0] == enc1["strings"][0][0]
    assert strings[1][0] == enc1["strings"][1][0]
    np.testing.assert_array_equal(counts, np.asarray(enc1["counts"])[0])


def test_stemv_params_hash_guard(tmp_path):
    i_model, stem = _models()
    rng = np.random.default_rng(1)
    frames = [rng.random((64, 64, 3)).astype(np.float32) for _ in range(2)]
    out = tmp_path / "seq.stemv"
    vc.encode_video(frames, i_model, stem, out, gop=2)
    wrong = SpatioTemporalPriorModel(
        variant="without_spm", entropy_bottleneck_channels=16, in_channels=M,
        device="cpu", seed=1)
    _scale(wrong, 0.02)
    wrong.update()
    with pytest.raises(ValueError, match="--stem-checkpoint"):
        vc.decode_video(out, i_model, wrong)
    vc.decode_video(out, i_model, wrong, verify_params=False)
    vc.decode_video(out, i_model, stem)


def _api_chain(i_model, stem, frames):
    """The model-API chain: I compress/decompress, then per P-frame
    analysis, STEM compress/decompress and get_x, as (H, W, 3) arrays."""
    enc0 = i_model.compress(_padded(frames[0]))
    dec0 = i_model.decompress(enc0["strings"], enc0["shape"])
    y_cond, out = dec0["y_hat"], [dec0["x_hat"]]
    for fr in frames[1:]:
        y_cur = i_model.analysis(_padded(fr))
        enc = stem.compress(y_cur, y_cond)
        y_cond = stem.decompress(enc["strings"], enc["shape"],
                                 y_cond)["y_hat"]
        out.append(i_model.get_x(y_cond))
    return [x[0].float().permute(1, 2, 0).numpy() for x in out]


def test_stemv_wavefront_tiled_flagship(tmp_path):
    i_model, stem = _models("res", tile=(2, 4))
    rng = np.random.default_rng(5)
    base = rng.random((64, 64, 3)).astype(np.float32)
    frames = [np.clip(base + 0.01 * t, 0, 1) for t in range(3)]
    out = tmp_path / "res.stemv"
    vc.encode_video(frames, i_model, stem, out, gop=3)
    hdr, records = _records(out, 3)
    assert hdr["stem_family"] == 1 and (hdr["cfg0"], hdr["cfg1"]) == (2, 4)
    assert [r[0] for r in records] == [0, 3, 3]
    decoded = vc.decode_video(out, i_model, stem)
    for got, want in zip(decoded, _api_chain(i_model, stem, frames)):
        np.testing.assert_array_equal(got, want)


# ---- against the JAX package -----------------------------------------------

def _jax_small(variant, tile=None):
    """JAX models of tests/test_video_codec.py's sizes (scaled as there) and
    the port's with their weights."""
    j_i = JaxMSH(8, M)
    j_i.init(jnp.zeros((1, 64, 64, 3)))
    j_i.params = jax.tree_util.tree_map(lambda p: p * 0.05, j_i.params)
    j_i.update()
    j_s = JaxStem(variant=variant, entropy_bottleneck_channels=16,
                  in_channels=M, wavefront_tile=tile)
    d = jnp.zeros((1, 4, 4, M))
    j_s.init(d, d)
    j_s.params = jax.tree_util.tree_map(lambda p: p * 0.01, j_s.params)
    j_s.update()
    p_i = MeanScaleHyperprior(8, M, device="cpu")
    p_s = SpatioTemporalPriorModel(
        variant=variant, entropy_bottleneck_channels=16, in_channels=M,
        wavefront_tile=tile, device="cpu")
    load_jax_params(p_i.module, jax_tree_numpy(j_i.params))
    load_jax_params(p_s.module, jax_tree_numpy(j_s.params))
    p_i.update()
    p_s.update()
    return (j_i, j_s), (p_i, p_s)


@pytest.mark.parametrize("variant", VARIANTS)
def test_params_hash_matches_jax(variant):
    """The STEM's hash, and with the first variant the I-model's, in f32
    and then after set_compute_dtype(bf16) on both packages' models."""
    (j_i, j_s), (p_i, p_s) = _jax_small(variant)
    pairs = [(p_s, j_s)] + ([(p_i, j_i)] if variant == VARIANTS[0] else [])
    for dtype in (None, "bf16"):
        for port, jax_model in pairs:
            if dtype:
                jax_model.set_compute_dtype(jnp.bfloat16)
                port.set_compute_dtype(torch.bfloat16)
            assert vc.params_hash(port) == jvc.params_hash(jax_model), dtype


@pytest.mark.parametrize("variant,tile,fmt", [("without_spm", None, None),
                                              ("res", (2, 4), "lane"),
                                              ("res", (2, 4), "grouped")])
def test_each_package_decodes_the_others_file(tmp_path, variant, tile, fmt):
    """With the grouped wavefront order the header's flag bit0 is set, and
    each decoder takes the order from it and restores its model's own."""
    (j_i, j_s), (p_i, p_s) = _jax_small(variant, tile)
    if fmt:
        p_s.wavefront_format = j_s.wavefront_format = fmt
    rng = np.random.default_rng(7)
    base = rng.random((60, 62, 3)).astype(np.float32)
    frames = [np.clip(base + 0.01 * t, 0, 1) for t in range(3)]
    ours, theirs = tmp_path / "port.stemv", tmp_path / "jax.stemv"
    vc.encode_video(frames, p_i, p_s, ours, gop=3)
    jvc.encode_video(frames, j_i, j_s, theirs, gop=3)
    assert ours.read_bytes()[15] == (fmt == "grouped")  # flags
    for m in (p_s, j_s):  # the other order: the header's must win
        m.wavefront_format = "lane" if fmt == "grouped" else "grouped"
    got = vc.decode_video(theirs, p_i, p_s)
    want = jvc.decode_video(ours, j_i, j_s)
    if fmt:
        assert p_s.wavefront_format == ("lane" if fmt == "grouped"
                                        else "grouped")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=1e-4)


# ---- family 2: charm -------------------------------------------------------

def _charm_pair(i_scale, scale):
    """tests/test_video_codec.py's MSH (N 8, M 12), JAX-initialised, its
    weights × i_scale, and a charm (G 4, EB 16) from the port's seed, its
    weights × scale, in both packages with the same weights."""
    j_i = JaxMSH(8, M)
    j_i.init(jnp.zeros((1, 64, 64, 3)))
    j_i.params = jax.tree_util.tree_map(lambda p: p * i_scale, j_i.params)
    j_i.update()
    p_i = MeanScaleHyperprior(8, M, device="cpu")
    load_jax_params(p_i.module, jax_tree_numpy(j_i.params))
    p_i.update()
    p_s = SpatioTemporalPriorModelChannelAR(
        groups=4, entropy_bottleneck_channels=16, in_channels=M,
        device="cpu", seed=3)
    _scale(p_s, scale)
    p_s.update()
    j_s = JaxCharm(groups=4, entropy_bottleneck_channels=16, in_channels=M)
    j_s.params = jax.tree_util.tree_map(jnp.asarray, jax_tree(p_s.module))
    j_s.update()
    return (j_i, j_s), (p_i, p_s)


@pytest.mark.parametrize("i_scale,scale,ftype", [
    (0.05, 0.02, vc.FTYPE_P_CHARM), (1.0, 1.0, vc.FTYPE_P_CHARM_DENSE)])
def test_stemv_charm_file_equals_jax_and_cross_decodes(tmp_path, i_scale,
                                                       scale, ftype):
    """At 60×62, GOP 3: the header's family 2, cfg0 the groups and cfg1
    lrp | residual << 1; P records of type 4 (sparse, with the groups'
    counts) for the scaled weights and 5 (dense) for unscaled ones, whose
    latents overflow the sparse transport; the port's
    file the JAX package's byte for byte; each package decodes the other's
    file (within 1e-4), and the port's decode equals the model-API chain
    with the carry the decoder's ŷ."""
    (j_i, j_s), (p_i, p_s) = _charm_pair(i_scale, scale)
    rng = np.random.default_rng(11)
    base = rng.random((60, 62, 3)).astype(np.float32)
    frames = [np.clip(base + 0.01 * t, 0, 1) for t in range(3)]
    ours, theirs = tmp_path / "port.stemv", tmp_path / "jax.stemv"
    vc.encode_video(frames, p_i, p_s, ours, gop=3)
    jvc.encode_video(frames, j_i, j_s, theirs, gop=3)
    with open(ours, "rb") as f:
        hdr = vc.read_header(f)
        records = [vc._read_frame(f, 4) for _ in range(3)]
    assert (hdr["stem_family"], hdr["cfg0"], hdr["cfg1"]) == (2, 4, 3)
    assert hdr["stem_variant_id"] == vc.UNSPECIFIED
    assert [r[0] for r in records] == [0, ftype, ftype]
    assert len(records[1][3][0][0]) == 4  # a y string per group
    assert (records[1][2] is None) == (ftype == vc.FTYPE_P_CHARM_DENSE)
    assert ours.read_bytes() == theirs.read_bytes()
    got = vc.decode_video(theirs, p_i, p_s)
    want = jvc.decode_video(ours, j_i, j_s)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=1e-4)
    for g, w in zip(got, _api_chain_charm(p_i, p_s, frames)):
        np.testing.assert_array_equal(g, w)


def _api_chain_charm(i_model, stem, frames):
    """The model-API chain of a charm: decompress with the encoder's
    transport and counts, ŷ the carry; cropped as decode_video crops."""
    enc0 = i_model.compress(_padded(frames[0]))
    dec0 = i_model.decompress(enc0["strings"], enc0["shape"])
    y_cond, out = dec0["y_hat"], [dec0["x_hat"]]
    for fr in frames[1:]:
        enc = stem.compress(i_model.analysis(_padded(fr)), y_cond)
        y_cond = stem.decompress(enc["strings"], enc["shape"], y_cond,
                                 transport_mode=enc["transport"],
                                 counts=enc.get("counts"))["y_hat"]
        out.append(i_model.get_x(y_cond))
    return [x[0].float().permute(1, 2, 0).numpy()[2:62, 1:63] for x in out]


# ---- the hero models, byte for byte ----------------------------------------

CFG = hero_config()["config"]


@pytest.fixture(scope="module")
def heroes():
    """The hero models of both packages, loaded once: the JAX ones as the
    JAX CLI loads the I checkpoint (``load_state_dict`` of ``["model"]``,
    its tables kept) and the P checkpoints' ``["params"]``; the port's
    through load_hero."""
    j_i = JaxMSH(CFG["N"], CFG["M"])
    j_i.init(jnp.zeros((1, 64, 64, 3)))
    j_i.load_state_dict(jax_load_checkpoint(
        str(HERO_DIR / f"ckpt_i_{CFG['lmbda']}.pkl.gz"))["model"])
    j_i.update()
    jax_models = {"i": j_i}
    for variant, tile in (("without_spm", None), ("res", (1, 4))):
        stem = JaxStem(variant=variant,
                       entropy_bottleneck_channels=CFG["EBC"],
                       in_channels=CFG["M"], wavefront_tile=tile)
        d = jnp.zeros((1, 4, 4, CFG["M"]))
        stem.init(d, d)
        stem.params = jax.tree_util.tree_map(jnp.asarray, jax_load_checkpoint(
            str(HERO_DIR / f"ckpt_p_{variant}_{CFG['lmbda']}.pkl.gz"))[
                "params"])
        stem.update(force=True)
        jax_models[variant] = stem
    return jax_models, load_hero(device="cpu", wavefront_tile=(1, 4))


@pytest.mark.parametrize("variant", ["without_spm", "res"])
def test_hero_crop_file_equals_jax(heroes, variant, tmp_path):
    jax_models, port = heroes
    frames = [f[:64, :64].astype(np.float32) / 255.0
              for f in hero_gop_set(1, 3)[0].frames]
    ours, theirs = tmp_path / "port.stemv", tmp_path / "jax.stemv"
    meta = {"i_model": "mbt2018-mean", "i_quality": 3}
    vc.encode_video(frames, port["i"], port[variant], ours, gop=3, meta=meta)
    jvc.encode_video(frames, jax_models["i"], jax_models[variant], theirs,
                     gop=3, meta=meta)
    hdr, records = _records(ours, 3)
    assert [r[0] for r in records] == ([0, 1, 1] if variant == "without_spm"
                                       else [0, 3, 3])
    assert ours.read_bytes() == theirs.read_bytes()


# ---- the CLI ---------------------------------------------------------------

def test_cli_round_trips_a_folder_of_pngs(tmp_path):
    """encode/decode through ``main`` with the zoo's mbt2018-mean at quality
    1 and a seeded STEM (EB 16): the decoded PNGs are decode_video's frames
    of the same file, through models built as the CLI builds them."""
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (60, 62, 3))
    for t in range(3):
        write_png(src / f"f{t}.png",
                  np.clip(base + 2 * t, 0, 255).astype(np.uint8))
    out = tmp_path / "seq.stemv"
    common = ["--i-quality", "1", "--stem-channels", "16", "--device", "cpu"]
    vc.main(["encode", str(src), "-o", str(out), "--gop", "2", *common])
    vc.main(["decode", str(out), "-o", str(tmp_path / "rec"), "--device",
             "cpu"])
    hdr = _records(out, 0)[0]
    assert (hdr["i_model_id"], hdr["i_quality"], hdr["n_frames"],
            hdr["stem_channels"]) == (2, 1, 3, 16)

    class Args:
        i_model, i_quality, i_checkpoint = "mbt2018-mean", 1, None
        stem_family, stem_variant, stem_channels = ("parallel",
                                                    "without_spm", 16)
        stem_checkpoint, wavefront_tile, device = None, None, "cpu"

    i_model, stem = vc._build_models(Args)
    want = vc.decode_video(out, i_model, stem)
    for t, fr in enumerate(want):
        np.testing.assert_array_equal(
            read_png(tmp_path / "rec" / f"frame_{t:04d}.png"),
            (np.clip(fr, 0, 1) * 255).astype(np.uint8))
    assert Path(out).stat().st_size > 45


def test_cli_charm_round_trips_a_folder_of_pngs(tmp_path):
    """``--stem-family charm --charm-groups 3 --no-charm-lrp``: the header
    records the family and (groups, lrp | residual << 1) = (3, 2), the
    decode rebuilds that charm from it, and its PNGs are decode_video's
    frames of the same file."""
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (64, 64, 3))
    for t in range(2):
        write_png(src / f"f{t}.png",
                  np.clip(base + 2 * t, 0, 255).astype(np.uint8))
    out = tmp_path / "charm.stemv"
    vc.main(["encode", str(src), "-o", str(out), "--gop", "2",
             "--i-quality", "1", "--stem-channels", "16", "--stem-family",
             "charm", "--charm-groups", "3", "--no-charm-lrp", "--device",
             "cpu"])
    vc.main(["decode", str(out), "-o", str(tmp_path / "rec"), "--device",
             "cpu"])
    with open(out, "rb") as f:
        hdr = vc.read_header(f)
        records = [vc._read_frame(f, hdr["cfg0"]) for _ in range(2)]
    assert (hdr["stem_family"], hdr["cfg0"], hdr["cfg1"],
            hdr["stem_channels"]) == (2, 3, 2, 16)
    assert records[1][0] in vc.CHARM_FTYPES
    assert len(records[1][3][0][0]) == 3

    class Args:
        i_model, i_quality, i_checkpoint = "mbt2018-mean", 1, None
        stem_family, stem_channels, stem_checkpoint = "charm", 16, None
        charm_groups, charm_lrp, device = 3, False, "cpu"

    i_model, stem = vc._build_models(Args)
    assert not stem.module.lrp and stem.groups == 3
    want = vc.decode_video(out, i_model, stem)
    for t, fr in enumerate(want):
        np.testing.assert_array_equal(
            read_png(tmp_path / "rec" / f"frame_{t:04d}.png"),
            (np.clip(fr, 0, 1) * 255).astype(np.uint8))
