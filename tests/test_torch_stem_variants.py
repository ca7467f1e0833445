"""The port's five STEM variants against the JAX package's, with the JAX
weights carried across, on the CPU in f32: the module functions, the
parallel codec and the AR codecs (wavefront untiled and tiled, serial,
and the grouped v2 wire format) stream for stream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.models import (
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.models import (
    STEM_VARIANTS,
    SpatioTemporalPriorModel,
)

from torch_port_util import jax_tree_numpy, to_nchw, to_nhwc

M, EBC = 24, 32
B, HW = 2, 8
SPM = ("without_tpm", "full", "res")
# (variant, ar_mode, wavefront_tile); the parallel variants have one codec
CODECS = [("without_spm_tpm", None, None), ("without_spm", None, None)] + [
    (v, mode, tile) for v in SPM
    for mode, tile in (("wavefront", None), ("wavefront", (1, 4)),
                       ("serial", None))
]


def _latents():
    rng = np.random.default_rng(0)
    y_cur = rng.standard_normal((B, HW, HW, M)).astype(np.float32)
    y_cond = (y_cur + 0.3 * rng.standard_normal(y_cur.shape)).astype(
        np.float32)
    return y_cur, y_cond


@pytest.fixture(scope="module")
def bridged():
    """variant → (JAX model, port model with its weights), built once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            jm = JaxStem(variant=variant, entropy_bottleneck_channels=EBC,
                         in_channels=M)
            d = jnp.zeros((1, 4, 4, M))
            jm.init(d, d)
            jm.update()
            pm = SpatioTemporalPriorModel(
                variant=variant, entropy_bottleneck_channels=EBC,
                in_channels=M, device="cpu")
            load_jax_params(pm.module, jax_tree_numpy(jm.params))
            pm.update()
            cache[variant] = (jm, pm)
        return cache[variant]

    return get


@pytest.fixture(scope="module")
def coded(bridged):
    """(variant, mode, tile, format) → (JAX enc, JAX ŷ, port enc, port ŷ),
    each package coding the same latents once."""
    cache = {}
    y_cur, y_cond = _latents()

    def get(variant, mode, tile, fmt="auto"):
        key = (variant, mode, tile, fmt)
        if key not in cache:
            jm, pm = bridged(variant)
            for m in (jm, pm):
                if mode is not None:
                    m.ar_mode, m.wavefront_tile = mode, tile
                    m.wavefront_format = fmt
            jenc = jm.compress(jnp.asarray(y_cur), jnp.asarray(y_cond))
            jhat = np.asarray(jm.decompress(jenc["strings"], jenc["shape"],
                                            jnp.asarray(y_cond))["y_hat"])
            penc = pm.compress(to_nchw(y_cur), to_nchw(y_cond))
            phat = to_nhwc(pm.decompress(penc["strings"], penc["shape"],
                                         to_nchw(y_cond))["y_hat"])
            cache[key] = (jenc, jhat, penc, phat)
        return cache[key]

    return get


@pytest.mark.parametrize("variant", STEM_VARIANTS)
def test_module_functions_match_jax(variant, bridged):
    """hyper_encode, then prior_feats (AR) or entropy_params (parallel), and
    ar_step on random crops: within atol 1e-5 of the JAX module."""
    jm, pm = bridged(variant)
    y_cur, y_cond = _latents()
    z = np.asarray(jm._apply(jnp.asarray(y_cur), jnp.asarray(y_cond),
                             method="hyper_encode"))
    z_hat = np.round(z)
    mod = pm.module
    with torch.no_grad():
        z_t = mod.hyper_encode(to_nchw(y_cur), to_nchw(y_cond))
        np.testing.assert_allclose(to_nhwc(z_t), z, atol=1e-5)
        if not mod.use_spm:
            ref = jm._apply(jnp.asarray(z_hat), jnp.asarray(y_cond),
                            method="entropy_params")
            got = mod.entropy_params(to_nchw(z_hat), to_nchw(y_cond))
            for g, r in zip(got, ref):
                np.testing.assert_allclose(to_nhwc(g), np.asarray(r),
                                           atol=1e-5)
            return
        ref = np.asarray(jm._apply(jnp.asarray(z_hat), jnp.asarray(y_cond),
                                   method="prior_feats"))
        got = to_nhwc(mod.prior_feats(to_nchw(z_hat), to_nchw(y_cond)))
        np.testing.assert_allclose(got, ref, atol=1e-5)

        rng = np.random.default_rng(1)
        n, p = 37, ref.shape[-1]
        crops = rng.standard_normal((n, 5, 5, M)).astype(np.float32)
        pvec = rng.standard_normal((n, 1, 1, p)).astype(np.float32)
        ref = jm._apply(jnp.asarray(crops), jnp.asarray(pvec),
                        method="ar_step")
        taps = mod.context_prediction.causal_taps(to_nchw(crops))
        got = mod.ar_step(taps, torch.from_numpy(pvec.reshape(n, p)))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
        # the centre entry is the masked conv's full-plane output there
        full = mod.context_prediction(to_nchw(crops))[:, :, 2, 2]
        np.testing.assert_allclose(mod.context_prediction.center(taps).numpy(),
                                   full.numpy(), atol=1e-5)


@pytest.mark.parametrize("variant,mode,tile", CODECS)
def test_compress_streams_match_jax(variant, mode, tile, coded):
    """The f32 y and z streams equal the JAX model API's byte for byte."""
    jenc, _, penc, _ = coded(variant, mode, tile)
    assert tuple(penc["shape"]) == tuple(jenc["shape"])
    assert penc["strings"][1] == jenc["strings"][1]
    assert penc["strings"][0] == jenc["strings"][0]


@pytest.mark.parametrize("variant,mode,tile", CODECS)
def test_decompress_matches_jax(variant, mode, tile, coded):
    """Decoded ŷ within atol 1e-4 of the JAX package's, and within half a
    step of the latent it coded (plus μ's shift)."""
    _, jhat, _, phat = coded(variant, mode, tile)
    np.testing.assert_allclose(phat, jhat, atol=1e-4)
    assert np.isfinite(phat).all()


@pytest.mark.parametrize("variant", SPM)
def test_serial_matches_wavefront(variant, coded):
    """JAX tests/test_stem.py:99-129: the wavefront schedule reproduces the
    serial AR decisions: ŷ within 1e-4, stream sizes within 2 %."""
    _, _, enc_wf, hat_wf = coded(variant, "wavefront", None)
    _, _, enc_s, hat_s = coded(variant, "serial", None)
    np.testing.assert_allclose(hat_wf, hat_s, atol=1e-4)
    for a, b in zip(enc_wf["strings"][0], enc_s["strings"][0]):
        assert abs(len(a) - len(b)) <= max(16, 0.02 * len(b))


@pytest.mark.parametrize("variant", SPM)
def test_grouped_format_roundtrips(variant, coded):
    """The v2 grouped wire format: the JAX package's bytes, different bytes
    from the lane format at about its size, and the same ŷ."""
    jenc, jhat, penc, phat = coded(variant, "wavefront", (1, 4), "grouped")
    _, _, lane, lane_hat = coded(variant, "wavefront", (1, 4))
    assert penc["strings"] == jenc["strings"]
    np.testing.assert_allclose(phat, jhat, atol=1e-4)
    np.testing.assert_allclose(phat, lane_hat, atol=1e-5)
    for g, ln in zip(penc["strings"][0], lane["strings"][0]):
        assert g != ln and abs(len(g) - len(ln)) <= max(16, 0.02 * len(ln))
