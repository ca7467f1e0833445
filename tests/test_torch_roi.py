"""The ROI / pixel-domain STEM family of the port (stem_baseline,
stem_baselinev2, stem_roi, stem_roi_wo_gsc, stem_roi_i) against the JAX
package's, on the CPU, with the JAX weights carried across (convert.py).

Small widths as the JAX package's own tests: EB 16, M 12, the fixed
128-channel trunk, 64² frames (72² where the pool's resize branch runs).
The port draws the weights from a seed, tames the quality-map transforms
(``eval/workload.py::tame_roi``: at their initialisation x̂ overflows f32)
and gives every bias a random value (the initialiser's zeros would hide
where a bias is added), and both packages run them.

Tolerances:
  * ``adaptive_avg_pool``: f32 within 1e-6 (the two packages sum the
    blocks and the resize's products in other orders); bf16 bit for bit
    (the mean rounds once, the resize's two products in JAX's order).
  * ``SFT``, ``SFTResblk``: f32 within 1e-5 of the output's scale; bf16
    the JAX bits but at ≤ 2 % of the outputs, one bf16 step of the
    output's largest magnitude off there (the convs' sums round the last
    f32 bit differently, which moves a bf16 rounding now and then, and
    SFTResblk's second SFT sees those flips).
  * the forwards: x̂ within atol 1e-4, each likelihood and the bpp within
    rtol 1e-3 (tests/test_parity_reference.py:54, 772).
  * the codec: the streams of ``compress`` byte for byte, but where a σ
    lies within 1e-5 relative of a scale-table entry (the two packages'
    f32 sums round apart there: at seed 1 one index of stem_baselinev2's
    192): the symbols equal, such an index one apart, the ẑ stream equal;
    the port's decoder's ŷ its encoder's exactly, with no quality map at
    decode; the JAX decoder on its streams within 1e-4 of the port's ŷ
    and x̂.
  * the quality maps: byte for byte from the same ``random.Random``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.data import qmap as jqmap
from spatiotemporalentropymodel_tpu.eval import eval_stem_roi as jeval
from spatiotemporalentropymodel_tpu.layers import blocks as jblocks
from spatiotemporalentropymodel_tpu_torch import zoo
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_param_paths, jax_tree, load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.data import qmap as pqmap
from spatiotemporalentropymodel_tpu_torch.entropy.base import (
    unpack_symbol_buffer,
)
from spatiotemporalentropymodel_tpu_torch.eval import eval_stem_roi as peval
from spatiotemporalentropymodel_tpu_torch.layers import (
    SFT, SFTResblk, adaptive_avg_pool,
)

from torch_port_util import (
    ROI_EBC, ROI_HW, ROI_M, ROI_MODELS, bridge_roi, random_biases, roi_args,
    to_nchw, to_nhwc,
)

NAMES = list(ROI_MODELS)
SFT_FLIPS = 2e-2
# a CDF index may differ where σ is this close to a scale-table entry
BOUNDARY_RTOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    return {name: bridge_roi(name) for name in NAMES}


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---- layers --------------------------------------------------------------

POOL_CASES = {"divisible": ((64, 64), (4, 4)), "resize": ((72, 72), (5, 5)),
              "resize_1080": ((1080, 64), (68, 4)),
              "resize_rows": ((72, 64), (5, 64))}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_adaptive_avg_pool_matches_jax(case, dtype):
    """Both branches: the block mean where the sizes divide, JAX's
    antialiased linear resize where they do not (72 → 5, an unpadded
    1080-row frame's 1080 → 68)."""
    (h, w), out = POOL_CASES[case]
    x = np.random.default_rng(0).random((2, h, w, 3), dtype=np.float32)
    if dtype == "bf16":
        x = _bf16(x)
        want = np.asarray(jblocks.adaptive_avg_pool(
            jnp.asarray(x, jnp.bfloat16), out).astype(jnp.float32))
        got = to_nhwc(adaptive_avg_pool(to_nchw(x).bfloat16(), out).float())
        np.testing.assert_array_equal(got, want)
    else:
        want = np.asarray(jblocks.adaptive_avg_pool(jnp.asarray(x), out))
        got = to_nhwc(adaptive_avg_pool(to_nchw(x), out))
        assert got.shape == want.shape == (2, *out, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


SFT_LAYERS = {
    "sft": (lambda: jblocks.SFT(16, 8), lambda g: SFT(16, 8, generator=g)),
    "sftresblk": (lambda: jblocks.SFTResblk(16, 8),
                  lambda g: SFTResblk(16, 8, generator=g)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("qsize", [(16, 24), (9, 11)],
                         ids=["pooled", "resized"])
@pytest.mark.parametrize("name", SFT_LAYERS)
def test_sft_matches_jax(name, qsize, dtype):
    """SFT and SFTResblk on an 8×12 input conditioned on an 8-channel map
    twice its size (pooled) or of a size that does not divide (resized)."""
    jax_cls, port_cls = SFT_LAYERS[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    q = rng.random((2, *qsize, 8), dtype=np.float32)
    port = port_cls(torch.Generator().manual_seed(3))
    params = random_biases(jax_tree(port), 4)
    load_jax_params(port, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if dtype == "bf16":
        x, q = _bf16(x), _bf16(q)
        port = port.bfloat16()
        jparams = jax.tree_util.tree_map(
            lambda p: p.astype(jnp.bfloat16), jparams)
        cast = (lambda a: jnp.asarray(a, jnp.bfloat16),
                lambda t: t.bfloat16())
    else:
        cast = (jnp.asarray, lambda t: t)
    want = np.asarray(jax.jit(jax_cls().apply)(
        {"params": jparams}, cast[0](x), cast[0](q)).astype(jnp.float32))
    with torch.no_grad():
        got = to_nhwc(port(cast[1](to_nchw(x)), cast[1](to_nchw(q))).float())
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        assert (got != want).mean() <= SFT_FLIPS
        assert np.abs(got - want).max() <= 2.0 ** -7 * scale


# ---- the parameter trees -------------------------------------------------

def _jax_shapes(jm, name):
    """{JAX path: shape} of the JAX model's parameters, traced (no init)."""
    args = [jnp.zeros(a.shape) for a in roi_args(name)]
    tree = jax.eval_shape(lambda *a: jm.module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        *a, train=False), *args)["params"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(k.key for k in p), tuple(v.shape)) for p, v in flat]


@pytest.mark.parametrize("name", NAMES)
def test_parameter_trees_match_jax(bridged, name):
    """The port's parameters are the JAX model's tree, path for path and
    shape for shape (flax's names for the SFT layers built in setup,
    ``ga1_SFT`` …, and inside them ``mlp_shared`` …, ``norm_0`` …), so the
    bridge carries them both ways."""
    jm, pm = bridged[name]
    assert jax_param_paths(pm.module) == _jax_shapes(jm, name)
    if name in ("stem_roi_wo_gsc", "stem_roi_i"):
        keys = {p[0] for p, _ in jax_param_paths(pm.module)}
        assert ("wmap_generator" in keys) == (name == "stem_roi_i")
        assert ("TPM" in keys) == (name == "stem_roi_wo_gsc")


def test_wo_gsc_has_no_decoder_sft():
    """stem_roi_wo_gsc is stem_roi without the wmap generator and the
    decoder-side SFT layers, and has no wmap parameters."""
    kw = dict(entropy_bottleneck_channels=ROI_EBC, in_channels=ROI_M,
              device="cpu")
    tops = {name: {n.split(".")[0] for n, _ in
                   zoo.roi_models[name](**kw).module.named_parameters()}
            for name in ("stem_roi", "stem_roi_wo_gsc")}
    assert tops["stem_roi"] - tops["stem_roi_wo_gsc"] == {
        "wmap_generator", "gs0_SFTResB1", "gs0_SFTResB2", "gs1_SFT",
        "gs2_SFT", "gs3_SFT", "qmap_feature_gs0", "qmap_feature_gs1",
        "qmap_feature_gs2", "qmap_feature_gs3"}
    assert tops["stem_roi_wo_gsc"] < tops["stem_roi"]


# ---- forwards and the codec ----------------------------------------------

def _bpp(likelihoods, pixels):
    return sum(float(-np.log2(np.asarray(v, np.float64)).sum())
               for v in likelihoods.values()) / pixels


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(bridged, name):
    jm, pm = bridged[name]
    args = roi_args(name, seed=3)
    want = jax.jit(lambda p, *a: jm.module.apply({"params": p}, *a))(
        jm.params, *map(jnp.asarray, args))
    got = pm.forward(*map(to_nchw, args))
    np.testing.assert_allclose(to_nhwc(got["x_hat"]),
                               np.asarray(want["x_hat"]), atol=1e-4)
    np.testing.assert_allclose(to_nhwc(got["y_hat"]),
                               np.asarray(want["y_hat"]), atol=1e-4)
    for key in ("y", "z"):
        np.testing.assert_allclose(to_nhwc(got["likelihoods"][key]),
                                   np.asarray(want["likelihoods"][key]),
                                   rtol=1e-3, atol=1e-9)
    pixels = ROI_HW * ROI_HW
    assert _bpp({k: to_nhwc(v) for k, v in got["likelihoods"].items()},
                pixels) == pytest.approx(_bpp(want["likelihoods"], pixels),
                                         rel=1e-3)


def _encoder_symbols(jm, pm, args):
    """Both encoders' planes, unpacked from their fused buffers: ((y
    symbols, ẑ symbols, CDF indexes) of JAX, the same of the port, the
    port's σ), NHWC."""
    shapes = pm._latent_shapes(to_nchw(args[0]).shape)
    jplanes = unpack_symbol_buffer(
        np.asarray(jm._fused_encode_fn()(*map(jnp.asarray, args))), *shapes)
    targs = [to_nchw(a) for a in args]
    pplanes = unpack_symbol_buffer(
        pm.fused_encode_expr(*targs)[0].numpy(), *shapes)
    with torch.no_grad():
        y_cond = pm.module.encode_latents(*targs)[1]
        sigma = pm.module.entropy_params(
            pm._z_hat(to_nchw(pplanes[1].astype(np.float32))), y_cond)[0]
    return jplanes, pplanes, to_nhwc(sigma)


@pytest.mark.parametrize("name", NAMES)
def test_compress_streams_match_jax(bridged, name):
    """Both packages' compress give the same bytes, but where a σ lies on a
    scale-table entry: the symbols are the same, and a CDF index may differ
    only by one, where the port's σ is within BOUNDARY_RTOL of the table
    entry between the two (the packages' EPM sums round apart there);
    then only the y stream differs. The port decodes its stream, with no
    quality map, to its encoder's ŷ exactly, and the JAX decoder its own
    stream to the port's ŷ and x̂ within 1e-4 (the same symbols)."""
    jm, pm = bridged[name]
    args = roi_args(name, seed=4)
    jenc = jm.compress(*map(jnp.asarray, args))
    enc, y_enc = pm.encode_with_y_hat(*map(to_nchw, args))
    assert tuple(enc["shape"]) == tuple(jenc["shape"]) == (1, 1)
    (jy, jz, jidx), (py, pz, pidx), sigma = _encoder_symbols(jm, pm, args)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pz, jz)
    apart = pidx != jidx
    if apart.any():
        assert np.all(np.abs(pidx - jidx)[apart] == 1)
        table = np.asarray(pm.tables["gaussian_conditional"].scale_table)
        edge = table[np.minimum(pidx, jidx)[apart]]
        assert np.all(np.abs(sigma[apart] - edge) <= BOUNDARY_RTOL * edge)
        assert enc["strings"][1] == jenc["strings"][1]
    else:
        assert enc["strings"] == jenc["strings"]
    cond = () if name == "stem_roi_i" else (args[1],)
    dec = pm.decompress(enc["strings"], enc["shape"], *map(to_nchw, cond))
    assert torch.equal(dec["y_hat"], y_enc)
    assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1
    jdec = jm.decompress(jenc["strings"], jenc["shape"],
                         *map(jnp.asarray, cond))
    np.testing.assert_allclose(to_nhwc(dec["y_hat"]),
                               np.asarray(jdec["y_hat"]), atol=1e-4)
    np.testing.assert_allclose(to_nhwc(dec["x_hat"]),
                               np.asarray(jdec["x_hat"]), atol=1e-4)


def test_unpadded_frame_round_trip(bridged):
    """stem_roi on an unpadded 1080-row frame (1080 × 64): the latents are
    the convs' ceil-divided sizes (68 × 4, ẑ 17 × 1), the hyper-encoder's
    map is the resize of the 1080-row map (1080 → 68, 64 → 4), and the
    decoder's ŷ is the encoder's. The forward, the resize included, agrees
    with the JAX package's within the forward tolerances; its compress
    floors the latent sizes and raises here, where the port's codes
    (ROADMAP.md, Queue 3 items 2 and 3)."""
    jm, pm = bridged["stem_roi"]
    args = roi_args("stem_roi", seed=5, hw=(1080, 64))
    enc, y_enc = pm.encode_with_y_hat(*map(to_nchw, args))
    assert enc["shape"] == (17, 1) and y_enc.shape == (1, ROI_M, 68, 4)
    dec = pm.decompress(enc["strings"], enc["shape"], to_nchw(args[1]))
    assert torch.equal(dec["y_hat"], y_enc)
    assert dec["x_hat"].shape == (1, 3, 1088, 64)
    fwd = pm.forward(*map(to_nchw, args))
    want = jax.jit(lambda p, *a: jm.module.apply({"params": p}, *a))(
        jm.params, *map(jnp.asarray, args))
    np.testing.assert_allclose(to_nhwc(fwd["y_hat"]),
                               np.asarray(want["y_hat"]), atol=1e-4)
    np.testing.assert_allclose(to_nhwc(fwd["x_hat"]),
                               np.asarray(want["x_hat"]), atol=1e-4)
    for key in ("y", "z"):
        np.testing.assert_allclose(to_nhwc(fwd["likelihoods"][key]),
                                   np.asarray(want["likelihoods"][key]),
                                   rtol=1e-3, atol=1e-9)


# ---- the quality maps ----------------------------------------------------

def test_synthesize_qmap_matches_jax():
    """30 draws from one random.Random (every branch: uniform, gradient,
    Gaussian mixture) give the JAX package's maps byte for byte."""
    ra, rb = random.Random(7), random.Random(7)
    for _ in range(30):
        a = jqmap.synthesize_qmap(48, rng=ra)
        b = pqmap.synthesize_qmap(48, rng=rb)
        assert a.dtype == b.dtype == np.float32 and a.shape == (48, 48, 1)
        assert a.tobytes() == b.tobytes()
    assert ra.getstate() == rb.getstate()


@pytest.mark.parametrize("level", [0, 37, 100, -1, -2])
def test_eval_qmaps_match_jax(level):
    a = jeval._make_qmap((50, 70), level)
    b = peval._make_qmap((50, 70), level)
    assert a.shape == b.shape == (50, 70, 1)
    assert a.tobytes() == b.tobytes()
