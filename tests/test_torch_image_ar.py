"""The autoregressive image models of the port (mbt2018, Cheng2020 anchor
and attention) against the JAX package's, on the CPU, with the JAX
weights carried across (convert.py).

The layers (f32, atol 1e-6): pixel_shuffle, SubpelConv3x3 and each
residual and attention block at widths 16 and 32. The forwards of
JointAutoregressiveHierarchicalPriors(8, 12), Cheng2020Anchor(16) and
Cheng2020Attention(16), in eval mode and in train mode with the same fed
noise: likelihoods rtol 1e-4 (atol 1e-6), x̂ atol 1e-4, bpp rtol 1e-3. The
codec: the streams of ``compress`` byte for byte the JAX model API's in the
lane and grouped wavefront orders and the serial raster order; the
decoder's ŷ the encoder's exactly; serial and wavefront ŷ within 1e-4; a
picture's streams and ŷ the same alone as in a batch, f32 and bf16. bf16
against the JAX package's bf16 with tests/test_torch_bf16_wavefront.py's
criteria. The zoo builds the three architectures at every quality with the
JAX configurations, and no GDN there is wider than the port's kernels take.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.layers import blocks as jblocks
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu.zoo import cfgs as jax_cfgs
from spatiotemporalentropymodel_tpu_torch import zoo
from spatiotemporalentropymodel_tpu_torch.convert import (
    invert_conv_weight,
    jax_tree,
    load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.layers import (
    GDN,
    Deconv,
    LeakyReLU,
    SubpelConv3x3,
    blocks,
    pixel_shuffle,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import (  # noqa: F401 (fed_noise: a fixture)
    AR_MODELS, HW, ar_image, bridge_ar, fed_noise, random_biases, to_nchw,
    to_nhwc,
)

# the module: the JAX package's layers/__init__.py exports a function conv
jconv = importlib.import_module("spatiotemporalentropymodel_tpu.layers.conv")

MODELS = AR_MODELS
_bridge, _image, _random_biases = bridge_ar, ar_image, random_biases
# tests/test_torch_bf16_wavefront.py's criteria
LAYER_FLIPS = 1e-3
RATE_RTOL = 2e-2


@pytest.fixture(scope="module")
def bridged():
    return {name: _bridge(name) for name in MODELS}


def _jax_forward(jm, x, train=False):
    """The JAX module's forward, jitted (its eager dispatch compiles op by
    op: 20 s and more here); train mode draws from a fixed key, which the
    fed noise replaces."""
    fn = jax.jit(lambda p, v: jm.module.apply(
        {"params": p}, v, train=train,
        rngs={"noise": jax.random.PRNGKey(0)} if train else None))
    return fn(jm.params, jnp.asarray(x))


# ---- layers --------------------------------------------------------------

def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 12)).astype(
        np.float32)
    want = np.asarray(jconv.pixel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_array_equal(to_nhwc(pixel_shuffle(to_nchw(x), 2)),
                                  want)


BLOCKS = {
    "subpel_conv3x3": (lambda: jconv.SubpelConv3x3(8, 2),
                       lambda: SubpelConv3x3(16, 8, 2)),
    "residual_with_stride": (lambda: jblocks.ResidualBlockWithStride(32, 2),
                             lambda: blocks.ResidualBlockWithStride(16, 32,
                                                                    2)),
    "residual_upsample": (lambda: jblocks.ResidualBlockUpsample(16, 2),
                          lambda: blocks.ResidualBlockUpsample(16, 16, 2)),
    "residual": (lambda: jblocks.ResidualBlock(16),
                 lambda: blocks.ResidualBlock(16, 16)),
    "residual_skip": (lambda: jblocks.ResidualBlock(32),
                      lambda: blocks.ResidualBlock(16, 32)),
    "residual_unit": (lambda: jblocks._ResidualUnit(16),
                      lambda: blocks._ResidualUnit(16)),
    "attention": (lambda: jblocks.AttentionBlock(16),
                  lambda: blocks.AttentionBlock(16)),
}


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_jax(name):
    """Each layer at f32 on the port's initialisation with random biases, on
    an input of scale 0.25: the port's output within 1e-6. The two
    packages sum each conv in another order, which moves an output by
    about 2⁻²⁴ of the sum of its products' magnitudes: at unit scale up to
    2e-6 after a residual block's two convs."""
    jax_cls, port_cls = BLOCKS[name]
    x = 0.25 * np.random.default_rng(1).standard_normal(
        (2, 8, 12, 16)).astype(np.float32)
    port = port_cls()
    params = _random_biases(jax_tree(port), 2)
    load_jax_params(port, params)
    want = np.asarray(jax.jit(jax_cls().apply)(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(x)))
    with torch.no_grad():
        got = to_nhwc(port(to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---- forwards ------------------------------------------------------------

def _bpp(likelihoods, pixels):
    return sum(float(-np.log2(np.asarray(v, np.float64)).sum())
               for v in likelihoods.values()) / pixels


def _check_forward(got, want):
    assert set(got["likelihoods"]) == set(want["likelihoods"]) == {"y", "z"}
    for key, lk in want["likelihoods"].items():
        np.testing.assert_allclose(to_nhwc(got["likelihoods"][key]),
                                   np.asarray(lk), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_nhwc(got["x_hat"]),
                               np.asarray(want["x_hat"]), atol=1e-4)
    pixels = HW * HW
    assert _bpp({k: to_nhwc(v) for k, v in got["likelihoods"].items()},
                pixels) == pytest.approx(_bpp(want["likelihoods"], pixels),
                                         rel=1e-3)
    for key in ("scales_hat", "means_hat"):
        np.testing.assert_allclose(to_nhwc(got["entropy_params"][key]),
                                   np.asarray(want["entropy_params"][key]),
                                   atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(bridged, name):
    jm, pm = bridged[name]
    x = _image(seed=3)
    _check_forward(pm.forward(to_nchw(x)), _jax_forward(jm, x))


@pytest.mark.parametrize("name", MODELS)
def test_train_forward_matches_jax(bridged, name, fed_noise):
    """Train mode, the two packages fed the same noise in place of their
    draws (the bottleneck's, the context's and the Gaussian
    conditional's)."""
    jm, pm = bridged[name]
    x = _image(seed=4)
    with torch.no_grad():
        got = pm.forward(to_nchw(x), train=True)
    _check_forward(got, _jax_forward(jm, x, train=True))


# ---- the codec -----------------------------------------------------------

def _codec(model, fmt=None):
    if fmt:
        model.wavefront_format = fmt
    return model


@pytest.mark.parametrize("name,mode,fmt", [
    ("mbt2018", "wavefront", "lane"), ("mbt2018", "wavefront", "grouped"),
    ("mbt2018", "serial", None), ("cheng2020-anchor", "wavefront", "lane"),
    ("cheng2020-attn", "wavefront", "lane")])
def test_compress_streams_match_jax(bridged, name, mode, fmt):
    """The streams of both packages' compress are the same bytes; the
    port's decoder gives its encoder's ŷ exactly and the JAX decoder's
    within 1e-4."""
    jm, pm = bridged[name]
    x = _image(seed=5)
    jm.ar_mode = pm.ar_mode = mode
    for m in (jm, pm):
        m.wavefront_format = fmt or "auto"
    try:
        jenc = jm.compress(jnp.asarray(x))
        enc, y_enc = pm.encode_with_y_hat(to_nchw(x))
        assert tuple(enc["shape"]) == tuple(jenc["shape"])
        assert enc["strings"] == jenc["strings"]
        dec = pm.decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], y_enc)
        if mode == "serial":  # the JAX decoder's ŷ, by its slow path
            jdec = jm.decompress(jenc["strings"], jenc["shape"])
            np.testing.assert_allclose(to_nhwc(dec["y_hat"]),
                                       np.asarray(jdec["y_hat"]), atol=1e-4)
    finally:
        jm.ar_mode = pm.ar_mode = "wavefront"
        jm.wavefront_format = pm.wavefront_format = "auto"


def test_serial_matches_wavefront(bridged):
    _, pm = bridged["mbt2018"]
    x = to_nchw(_image(seed=6))
    wf = pm.decompress(*(lambda e: (e["strings"], e["shape"]))(
        pm.compress(x)))["y_hat"]
    pm.ar_mode = "serial"
    try:
        enc = pm.compress(x)
        serial = pm.decompress(enc["strings"], enc["shape"])["y_hat"]
    finally:
        pm.ar_mode = "wavefront"
    np.testing.assert_allclose(serial.numpy(), wf.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mbt2018", "cheng2020-attn"])
def test_batch_invariance(name, dtype):
    """Three pictures coded in one batch give each picture's streams and ŷ
    coded alone, exactly."""
    pm = MODELS[name][1](seed=1)
    pm.update()
    if dtype == torch.bfloat16:
        pm.set_compute_dtype(dtype)
    x = to_nchw(_image(b=3, seed=7))
    enc, y_hat = pm.encode_with_y_hat(x)
    dec = pm.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], y_hat)
    for i in range(3):
        solo, y_solo = pm.encode_with_y_hat(x[i:i + 1])
        assert solo["strings"][0][0] == enc["strings"][0][i]
        assert solo["strings"][1][0] == enc["strings"][1][i]
        assert torch.equal(y_solo[0], y_hat[i])


# ---- bf16 against the JAX package's bf16 ---------------------------------

@pytest.fixture(scope="module")
def bridged_bf16():
    out = {}
    for name in ("mbt2018", "cheng2020-attn"):
        jm, pm = _bridge(name, seed=2)
        jm.set_compute_dtype(jnp.bfloat16)
        pm.set_compute_dtype(torch.bfloat16)
        out[name] = (jm, pm)
    return out


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _assert_close_bits(got, ref, flips, what):
    """got equals ref bit for bit but at ≤ ``flips`` of the elements, and
    is off there by no more than one bf16 ulp at ref's largest magnitude."""
    diff = got != ref
    assert diff.mean() <= flips, f"{what}: {diff.mean():.2e} differ"
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max(), what


@pytest.mark.parametrize("name,net", [
    ("mbt2018", "g_a"), ("mbt2018", "g_s"), ("mbt2018", "h_s"),
    ("mbt2018", "entropy_parameters"), ("cheng2020-attn", "g_a"),
    ("cheng2020-attn", "g_s"), ("cheng2020-attn", "h_s")])
def test_bf16_layers_round_like_jax(bridged_bf16, name, net):
    """Each top-level layer of the net at bf16, fed the JAX layer's input:
    an activation gives JAX's bits, every other layer (convs, GDNs, the
    residual and attention blocks) its bits but at ≤ LAYER_FLIPS of the
    outputs, one ulp off there."""
    jm, pm = bridged_bf16[name]
    rng = np.random.default_rng(1)
    m, n = pm.M, pm.N
    x = {"g_a": _image(seed=8),
         "g_s": np.round(3 * rng.standard_normal((1, 4, 4, m))),
         "h_s": np.round(3 * rng.standard_normal((1, 2, 2, n))),
         "entropy_parameters": rng.standard_normal((1, 4, 4, 4 * m))}[net]
    x = _bf16(x.astype(np.float32))

    def run(mdl, x, train=False):
        outs = []
        for layer in getattr(mdl, net).layers:
            x = layer(x)
            outs.append(x)
        return outs

    outs = [np.asarray(o.astype(jnp.float32)) for o in jax.jit(
        lambda p, v: jm.module.apply({"params": p}, v, method=run))(
            jm.params, jnp.asarray(x, jnp.bfloat16))]
    with torch.no_grad():
        for layer, inp, ref in zip(getattr(pm.module, net).layers,
                                   [x] + outs[:-1], outs):
            got = to_nhwc(layer(to_nchw(inp).bfloat16()).float())
            if isinstance(layer, LeakyReLU):
                np.testing.assert_array_equal(got, ref)
            else:
                _assert_close_bits(got, ref, LAYER_FLIPS,
                                   f"{net} {type(layer).__name__}")


@pytest.mark.parametrize("name", ["mbt2018", "cheng2020-attn"])
def test_bf16_codec_matches_jax(bridged_bf16, name):
    """Both packages' bf16 codecs on the same two 128² pictures (8 × 8
    latents, streams of some hundred bytes: on one 4 × 4 latent one symbol
    is 2 % of the stream): the same ẑ streams; y streams of the same total
    size within RATE_RTOL; each ŷ within the
    quantizer's half step of its own package's latent, plus half a bf16
    step of y − μ, which both round to bf16 before the symbol's rounding:
    2⁻⁸·|y − μ|, bounded here by 2⁻⁸·(max|y| + max|ŷ|), μ lying within the
    latents' range (up to 0.0078 over the half step is seen). (The untiled
    plane is not held element by element: one μ ulp off moves every later
    pixel's context, tests/test_torch_bf16_wavefront.py.)"""
    jm, pm = bridged_bf16[name]
    x = _image(b=2, seed=9, hw=128)
    jenc = jm.compress(jnp.asarray(x))
    jhat = np.asarray(jm.decompress(jenc["strings"], jenc["shape"])["y_hat"],
                      np.float32)
    jy = np.asarray(jm._jitted("analysis", lambda v: jm._apply(
        v, method="analysis"))(jnp.asarray(x))[0], np.float32)
    enc, y_enc = pm.encode_with_y_hat(to_nchw(x))
    phat = pm.decompress(enc["strings"], enc["shape"])["y_hat"]
    assert torch.equal(phat, y_enc)
    assert enc["strings"][1] == jenc["strings"][1]
    np.testing.assert_allclose(sum(map(len, enc["strings"][0])),
                               sum(map(len, jenc["strings"][0])),
                               rtol=RATE_RTOL)
    # g_a runs once per picture in compress: its latents, picture by picture
    py = np.concatenate([to_nhwc(pm.analysis(to_nchw(x[i:i + 1])).float())
                         for i in range(len(x))])
    for y_hat, y in ((to_nhwc(phat), py), (jhat, jy)):
        assert np.abs(y_hat - y).max() <= 0.5 + 2**-8 * (
            np.abs(y).max() + np.abs(y_hat).max())


# ---- the zoo and the kernels' gates --------------------------------------

AR_NAMES = ("mbt2018", "cheng2020-anchor", "cheng2020-attn")


def test_zoo_builds_the_ar_models_at_every_quality():
    """create_model at every quality of the three architectures, with the
    JAX configurations' widths. Every GDN is at most 192 wide (the CUDA
    gdn_fused's limit) and every IGDN → k5 s2 transposed conv of g_s is
    N → N or N → 3 (the g_s kernels' pairs)."""
    assert {k: zoo.cfgs[k] for k in AR_NAMES} == {
        k: jax_cfgs[k] for k in AR_NAMES}
    for name in AR_NAMES:
        for q, args in zoo.cfgs[name].items():
            m = zoo.create_model(name, q, device="cpu")
            n, mm = (args * 2)[:2]
            assert (m.N, m.M) == (n, mm)
            assert m.module.context_prediction.weight.shape == (2 * mm, mm,
                                                                5, 5)
            assert m.module.entropy_parameters.layers[-1].weight.shape[0] \
                == 2 * mm
            gdns = [g for g in m.module.modules() if isinstance(g, GDN)]
            assert gdns and max(g.channels for g in gdns) <= 192
            layers = m.module.g_s.layers
            for a, b in zip(layers, layers[1:]):
                if isinstance(a, GDN) and isinstance(b, Deconv):
                    assert b.weight.shape[1] in (b.weight.shape[0], 3)


def test_gdn_conv_192_to_320_gate_and_plain_match_jax():
    """The (192, 320) pair has a kernel, and its plain version equals the
    JAX package's _gdn_conv_ref on a small plane (f32)."""
    assert kernels.gdn_conv_supported(192, 320)
    rng = np.random.default_rng(0)
    c, o = 192, 320
    x = (0.5 * rng.standard_normal((1, 6, 10, c))).astype(np.float32)
    gt = (0.02 * rng.random((c, c)) + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    kernel = (0.05 * rng.standard_normal((5, 5, c, o))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    want = pk._gdn_conv_ref(jnp.asarray(x), jnp.asarray(gt),
                            jnp.asarray(beta), jnp.asarray(kernel),
                            jnp.asarray(bias))
    got = kernels._gdn_conv_ref(
        to_nchw(x), torch.from_numpy(gt), torch.from_numpy(beta),
        torch.from_numpy(invert_conv_weight(kernel)), torch.from_numpy(bias))
    assert got.shape == (1, o, 3, 5)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5)


def test_mbt2018_q5_g_a_fuses_192_to_320(monkeypatch):
    """mbt2018 at quality 5 in bf16: g_a's three GDN → conv stages go
    through gdn_conv_fused, the last at (192, 320) (its plain version on
    the CPU)."""
    calls = []
    fused = kernels.gdn_conv_fused

    def spy(x, *args):
        calls.append((x.shape[1], args[2].shape[0]))
        return fused(x, *args)

    monkeypatch.setattr(kernels, "gdn_conv_fused", spy)
    m = zoo.create_model("mbt2018", 5, device="cpu")
    m.set_compute_dtype(torch.bfloat16)
    y = m.analysis(torch.rand((1, 3, 64, 64)))
    assert calls == [(192, 192), (192, 192), (192, 320)]
    assert y.shape == (1, 320, 4, 4) and y.dtype == torch.bfloat16
