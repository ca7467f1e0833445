"""The I-frame codec (MeanScaleHyperprior.compress/decompress) of the port
against the JAX package's, on the small slice's bridged weights (N = M = 64,
2 × 64 × 64 frames), on the CPU.

f32: the streams equal the JAX package's byte for byte, x̂ and ŷ within
atol 1e-4 and bpp within rtol 1e-3 (ROADMAP's parity tolerances). bf16 (both
models after ``set_compute_dtype``), held to
tests/test_torch_bf16_pipeline.py's criteria: ŷ flips at ≤ 0.1 % of the
elements (|Δ| ≤ 1e-4 elsewhere, ≤ one step there), x̂ max |Δ| ≤ 6e-2 and
mean |Δ| ≤ 2e-3, bpp rtol 2e-2. Inside the port the encoder's ŷ equals the
decoder's exactly in both dtypes, under the default and the wide knobs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import B, H, W, build_slice, to_nchw, to_nhwc

DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bpp(enc):
    return sum(len(s) for g in enc["strings"] for s in g) * 8 / (B * H * W)


@pytest.fixture(scope="module", params=list(DTYPES))
def codecs(request):
    jax_i, _, port_i, _, xs, _ = build_slice(seed=0, surgery=True)
    jax_i.update(force=True)
    port_i.update(force=True)
    jd, td = DTYPES[request.param]
    if jd is not None:
        jax_i.set_compute_dtype(jd)
        port_i.set_compute_dtype(td)
    jenc = jax_i.compress(jnp.asarray(xs[0]))
    jdec = jax_i.decompress(jenc["strings"], jenc["shape"])
    return request.param, jax_i, port_i, xs[0], jenc, jdec


def test_iframe_codec_matches_jax(codecs):
    dtype, _, port_i, x, jenc, jdec = codecs
    enc = port_i.compress(to_nchw(x))
    dec = port_i.decompress(enc["strings"], enc["shape"])
    assert enc["shape"] == jenc["shape"] == (H // 64, W // 64)
    assert len(enc["strings"][0]) == len(enc["strings"][1]) == B
    x_hat, y_hat = to_nhwc(dec["x_hat"].float()), to_nhwc(dec["y_hat"])
    jx, jy = np.asarray(jdec["x_hat"], np.float32), np.asarray(jdec["y_hat"])
    assert dec["y_hat"].dtype == torch.float32
    if dtype == "f32":
        assert enc["strings"] == jenc["strings"]  # the JAX streams, bytewise
        np.testing.assert_allclose(y_hat, jy, atol=1e-4)
        np.testing.assert_allclose(x_hat, jx, atol=1e-4)
        np.testing.assert_allclose(_bpp(enc), _bpp(jenc), rtol=1e-3)
    else:
        assert dec["x_hat"].dtype == torch.bfloat16
        dy = np.abs(y_hat - jy)
        assert (dy > 1e-4).mean() <= 1e-3 and dy.max() <= 1 + 1e-4
        dx = np.abs(x_hat - jx)
        assert dx.max() <= 6e-2 and dx.mean() <= 2e-3
        np.testing.assert_allclose(_bpp(enc), _bpp(jenc), rtol=2e-2)
    assert 0 < _bpp(enc) < 16


@pytest.mark.parametrize("knob_set", ["default", "wide"])
def test_iframe_encoder_y_hat_equals_decoder_exactly(codecs, knob_set):
    """The ŷ the encoder expression forms equals the decoder's bit for bit,
    the streams repeat, and the wide knobs change nothing upstream of g_s."""
    _, _, port_i, x, _, _ = codecs
    xt = to_nchw(x)
    values = kernels.WIDE_KNOBS if knob_set == "wide" else {}
    with kernels.knobs(**values):
        enc = port_i.compress(xt)
        _, y_enc = port_i.fused_encode_expr(xt)
        dec = port_i.decompress(enc["strings"], enc["shape"])
        assert port_i.compress(xt)["strings"] == enc["strings"]
    assert torch.equal(y_enc, dec["y_hat"])
    assert dec["x_hat"].shape == (B, 3, H, W)
    assert bool(torch.isfinite(dec["x_hat"]).all())
    assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1


def test_iframe_decompress_rejects_bad_strings(codecs):
    _, _, port_i, _, jenc, _ = codecs
    with pytest.raises(ValueError):
        port_i.decompress(jenc["strings"][:1], jenc["shape"])
