"""The whole f32 P-frame slice through both packages' StemVideoPipeline on
the same bridged weights and frames, on the CPU: x̂ atol 1e-4 and bpp rtol
1e-3 (tests/test_parity_reference.py:54,772), and inside the port the
encoder's carried ŷ equals the decoder's ŷ exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval.pipeline import (
    StemVideoPipeline as JaxPipeline,
)
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    StemVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.utils import trace

from torch_port_util import B, H, W, build_slice, to_nchw, to_nhwc

BPP_RTOL = 1e-3


def _bpp(enc):
    n = sum(len(s) for g in enc["strings"] for s in g)
    n += np.asarray(enc["counts"]).nbytes if "counts" in enc else 0
    return n * 8 / (B * H * W)


@pytest.fixture(scope="module")
def served():
    """The serving workload at small size: surgery applied on both sides."""
    return build_slice(seed=0, surgery=True)


@pytest.fixture(scope="module")
def port_run(served):
    _, _, port_i, port_stem, xs, y_cond = served
    pipe = StemVideoPipeline(port_i, port_stem, transport_mode="sparse")
    encs = list(pipe.encode_frames([to_nchw(x) for x in xs],
                                   to_nchw(y_cond)))
    dec = list(pipe.decode_frames(encs, to_nchw(y_cond)))
    return pipe, encs, dec


def test_slice_matches_jax_pipeline(served, port_run):
    jax_i, jax_stem, _, _, xs, y_cond = served
    _, encs, dec = port_run
    jpipe = JaxPipeline(jax_i, jax_stem, transport_mode="sparse")
    jencs = list(jpipe.encode_frames([jnp.asarray(x) for x in xs],
                                     jnp.asarray(y_cond)))
    jdec = list(jpipe.decode_frames(jencs, jnp.asarray(y_cond)))
    assert [e["transport"] for e in encs] == ["sparse"] * len(xs)
    assert [e["transport"] for e in jencs] == ["sparse"] * len(xs)
    for enc, jenc, (x_hat, y_hat), (jx_hat, jy_hat) in zip(encs, jencs, dec,
                                                           jdec):
        np.testing.assert_allclose(to_nhwc(x_hat), np.asarray(jx_hat),
                                   atol=1e-4)
        np.testing.assert_allclose(to_nhwc(y_hat), np.asarray(jy_hat),
                                   atol=1e-4)
        np.testing.assert_allclose(_bpp(enc), _bpp(jenc), rtol=BPP_RTOL)
        assert 0 < _bpp(enc) < 1


def test_encoder_carry_equals_decoder_exactly(served, port_run):
    """encode_frame's carry, frame by frame, equals decode_frames' ŷ bit for
    bit, and encode_frame repeats encode_frames' streams."""
    _, _, _, _, xs, y_cond = served
    pipe, encs, dec = port_run
    carry = to_nchw(y_cond)
    for x, enc, (x_hat, y_dec) in zip(xs, encs, dec):
        enc2, carry = pipe.encode_frame(to_nchw(x), carry)
        assert enc2["strings"] == enc["strings"]
        assert torch.equal(carry, y_dec)
        assert x_hat.shape == (B, 3, H, W)
        assert torch.isfinite(x_hat).all()


def test_dense_transport_matches_model_api_and_sparse_decode(served,
                                                             port_run):
    _, _, port_i, port_stem, xs, y_cond = served
    _, _, dec = port_run
    pipe = StemVideoPipeline(port_i, port_stem, transport_mode="dense")
    yc = to_nchw(y_cond)
    enc, y_cur = pipe.encode_frame(to_nchw(xs[0]), yc)
    assert enc["transport"] == "dense"
    ref = port_stem.compress(y_cur, yc)
    assert enc["strings"] == ref["strings"]
    x_hat, y_hat = pipe.decode_frame(enc["strings"], enc["shape"], yc)
    assert torch.equal(y_hat, dec[0][1])
    assert torch.equal(x_hat, dec[0][0])


def test_sparse_overflow_falls_back_to_dense():
    """Untrained weights overflow the sparse layout; the frame is coded
    dense, as in the JAX package, counted under ``transport.dense``, and
    still decodes."""
    _, _, port_i, port_stem, xs, y_cond = build_slice(seed=2, surgery=False)
    pipe = StemVideoPipeline(port_i, port_stem, transport_mode="sparse")
    yc = to_nchw(y_cond)
    with trace.record() as rec:
        encs = list(pipe.encode_frames([to_nchw(xs[0])], yc))
    assert encs[0]["transport"] == "dense"
    assert dict(rec.counters).get("transport.dense") == 1
    assert "transport.sparse" not in rec.counters
    x_hat, _ = pipe.decode_frame(encs[0], y_cond=yc)
    assert x_hat.shape == (B, 3, H, W)


def test_latent_matches_the_benchmark_samplers_moments(served):
    """After match_latent_to_prior, g_a(x) has per channel the mean and
    standard deviation of bench.py's sampled latent μ + σ·ε."""
    from spatiotemporalentropymodel_tpu_torch.entropy.gaussian import (
        SCALES_MAX, SCALES_MIN,
    )

    _, _, port_i, port_stem, xs, y_cond = served
    yc = to_nchw(y_cond)
    with torch.no_grad():
        module = port_stem.module
        z = module.hyper_encode(yc, yc)
        z_hat = torch.round(z - port_stem._medians) + port_stem._medians
        scales, means = module.entropy_params(z_hat, yc)
        y = port_i.module.g_a(to_nchw(xs[0])).double()
    sigma = scales.double().abs().clamp(SCALES_MIN, SCALES_MAX)
    dims = (0, 2, 3)
    want_std = ((sigma ** 2).mean(dims)
                + means.double().var(dims, unbiased=False)).sqrt()
    np.testing.assert_allclose(y.mean(dims).numpy(),
                               means.double().mean(dims).numpy(), atol=1e-5)
    np.testing.assert_allclose(y.std(dims, unbiased=False).numpy(),
                               want_std.numpy(), rtol=1e-4)
    # the sampler's operating point: most channels sit at the σ floor
    assert float((want_std < 2 * SCALES_MIN).double().mean()) > 0.8
