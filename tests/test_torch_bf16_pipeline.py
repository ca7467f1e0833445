"""The bf16 slice: both packages' StemVideoPipeline with both models after
``set_compute_dtype(bf16)``, on the same bridged weights and frames, on the
CPU. The workload surgery runs at f32 before the cast, as it must
(``set_compute_dtype`` comes after ``update()``).

Tolerances, and why. The codec math is f32 on both sides, but the nets run
in bf16, where XLA and PyTorch round at other points. So μ may differ in its
last f32 bits (ŷ |Δ| ≤ 1e-4), and where y − μ lies within that of a .5
boundary a symbol rounds the other way: ŷ then differs by one step there, at
no more than 0.1 % of the elements per frame, and x̂ moves near it. x̂:
max |Δ| ≤ 6e-2 and mean |Δ| ≤ 2e-3 (the repo's bf16 atol,
tests/test_pallas.py); bpp: rtol 2e-2. Inside the port the encoder's carried
ŷ equals the decoder's ŷ exactly, as at f32.
"""

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

from torch_port_util import B, H, W, build_slice, to_nchw, to_nhwc

BPP_RTOL = 2e-2
X_MAX, X_MEAN = 6e-2, 2e-3
Y_ATOL, Y_FLIP_FRACTION = 1e-4, 1e-3


def _bpp(enc):
    n = sum(len(s) for g in enc["strings"] for s in g)
    n += np.asarray(enc["counts"]).nbytes if "counts" in enc else 0
    return n * 8 / (B * H * W)


@pytest.fixture(scope="module")
def runs():
    jax_i, jax_stem, port_i, port_stem, xs, y_cond = build_slice(
        seed=0, surgery=True)
    jax_i.set_compute_dtype(jnp.bfloat16)
    jax_stem.set_compute_dtype(jnp.bfloat16)
    port_i.set_compute_dtype(torch.bfloat16)
    port_stem.set_compute_dtype(torch.bfloat16)
    pipe = StemVideoPipeline(port_i, port_stem, transport_mode="sparse")
    encs = list(pipe.encode_frames([to_nchw(x) for x in xs],
                                   to_nchw(y_cond)))
    dec = list(pipe.decode_frames(encs, to_nchw(y_cond)))
    jpipe = JaxPipeline(jax_i, jax_stem, transport_mode="sparse")
    jencs = list(jpipe.encode_frames([jnp.asarray(x) for x in xs],
                                     jnp.asarray(y_cond)))
    jdec = list(jpipe.decode_frames(jencs, jnp.asarray(y_cond)))
    return pipe, xs, y_cond, encs, dec, jencs, jdec


def test_bf16_slice_matches_jax_bf16_pipeline(runs):
    _, xs, _, encs, dec, jencs, jdec = runs
    assert [e["transport"] for e in encs] == ["sparse"] * len(xs)
    assert [e["transport"] for e in jencs] == ["sparse"] * len(xs)
    for enc, jenc, (x_hat, y_hat), (jx_hat, jy_hat) in zip(encs, jencs, dec,
                                                           jdec):
        assert x_hat.dtype == torch.bfloat16
        assert y_hat.dtype == torch.float32
        dx = np.abs(to_nhwc(x_hat.float()) - np.asarray(jx_hat, np.float32))
        assert dx.max() <= X_MAX and dx.mean() <= X_MEAN
        dy = np.abs(to_nhwc(y_hat) - np.asarray(jy_hat, np.float32))
        assert (dy > Y_ATOL).mean() <= Y_FLIP_FRACTION
        assert dy.max() <= 1 + Y_ATOL
        np.testing.assert_allclose(_bpp(enc), _bpp(jenc), rtol=BPP_RTOL)
        assert 0 < _bpp(enc) < 1


def test_bf16_encoder_carry_equals_decoder_exactly(runs):
    """encode_frame's carry, frame by frame, equals decode_frames' ŷ bit for
    bit at bf16 too, and encode_frame repeats encode_frames' streams."""
    pipe, xs, y_cond, encs, dec, _, _ = runs
    carry = to_nchw(y_cond)
    for x, enc, (x_hat, y_dec) in zip(xs, encs, dec):
        enc2, carry = pipe.encode_frame(to_nchw(x), carry)
        assert enc2["strings"] == enc["strings"]
        assert torch.equal(carry, y_dec)
        assert x_hat.shape == (B, 3, H, W)
        assert torch.isfinite(x_hat.float()).all()
