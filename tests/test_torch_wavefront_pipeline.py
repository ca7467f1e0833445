"""The port's WavefrontVideoPipeline against the model API and the JAX
package, on the CPU (JAX tests/test_pipeline.py:244-350), and its bf16
round trip (JAX tests/test_bf16_serving.py:70-90)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.models import (
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    WavefrontVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    wavefront_y_cur,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.utils import trace

from torch_port_util import jax_tree_numpy, to_nchw, to_nhwc

M, EBC = 24, 32


@pytest.fixture(scope="module")
def wf_setup():
    """The port's I-model (N = 8, its own seed), JAX and port tiled res
    STEMs with the same weights, a 64×64 frame, and g_a's latent of it."""
    rng = np.random.default_rng(3)
    x = rng.random((1, 3, 64, 64), dtype=np.float32)
    jax_stem = JaxStem(variant="res", entropy_bottleneck_channels=EBC,
                       in_channels=M, ar_mode="wavefront",
                       wavefront_tile=(1, 4))
    d = jnp.zeros((1, 4, 4, M))
    jax_stem.init(d, d)
    jax_stem.update()
    imodel = MeanScaleHyperprior(8, M, device="cpu")
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=EBC,
                                    in_channels=M, wavefront_tile=(1, 4),
                                    device="cpu")
    load_jax_params(stem.module, jax_tree_numpy(jax_stem.params))
    stem.update()
    x = torch.from_numpy(x)
    return x, imodel, stem, jax_stem, to_nhwc(imodel.analysis(x))


def _noisy(y, seed):
    g = torch.Generator().manual_seed(seed)
    return y + 0.3 * torch.randn(y.shape, generator=g)


def test_pipeline_streams_match_model_api_and_jax(wf_setup):
    x, imodel, stem, jax_stem, y0 = wf_setup
    pipe = WavefrontVideoPipeline(imodel, stem)
    y_cond = to_nchw(y0)
    y_cur = _noisy(y_cond, 4)
    enc = pipe.encode_frame(y_cur, y_cond)
    ref = stem.compress(y_cur, y_cond)
    jref = jax_stem.compress(jnp.asarray(to_nhwc(y_cur)), jnp.asarray(y0))
    assert enc["strings"] == ref["strings"] == jref["strings"]

    y_hat = pipe.decode_frame(enc, y_cond)
    assert torch.equal(y_hat, stem.decompress(ref["strings"], ref["shape"],
                                              y_cond)["y_hat"])
    jhat = jax_stem.decompress(jref["strings"], jref["shape"],
                               jnp.asarray(y0))["y_hat"]
    np.testing.assert_allclose(to_nhwc(y_hat), np.asarray(jhat), atol=1e-4)


def _assert_batch_invariant(pipe, curs, conds):
    """S streams batched along the batch axis give each stream's solo
    bitstreams byte for byte and its solo decode bit for bit (JAX
    tests/test_pipeline.py:274-297)."""
    solo = [pipe.encode_frame(c, yc) for c, yc in zip(curs, conds)]
    batched = pipe.encode_frame(torch.cat(curs), torch.cat(conds))
    for s in range(len(curs)):
        assert batched["strings"][0][s] == solo[s]["strings"][0][0]
        assert batched["strings"][1][s] == solo[s]["strings"][1][0]
    y_hat_b = pipe.decode_frame(batched, torch.cat(conds))
    for s in range(len(curs)):
        y_hat_s = pipe.decode_frame(solo[s], conds[s])
        assert torch.equal(y_hat_b[s:s + 1], y_hat_s), s


def test_pipeline_multistream_streams_exact(wf_setup):
    """Two f32 streams batched: each stream's streams and ŷ are its solo
    ones exactly."""
    x, imodel, stem, _, _ = wf_setup
    pipe = WavefrontVideoPipeline(imodel, stem)
    conds = [pipe.analysis(x), pipe.analysis(x * 0.8 + 0.1)]
    curs = [_noisy(c, 5 + i) for i, c in enumerate(conds)]
    _assert_batch_invariant(pipe, curs, conds)


def test_pipeline_multistream_streams_exact_bf16():
    """The same at bf16, three streams, tile (1, 4): the nets in bf16
    round every product, so a batch-dependent sum order would show."""
    imodel = MeanScaleHyperprior(8, M, device="cpu", seed=4)
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=EBC,
                                    in_channels=M, wavefront_tile=(1, 4),
                                    device="cpu", seed=5)
    stem.update()
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    pipe = WavefrontVideoPipeline(imodel, stem)
    g = torch.Generator().manual_seed(6)
    conds = [torch.randn((1, M, 8, 8), generator=g) for _ in range(3)]
    curs = [_noisy(c, 7 + i) for i, c in enumerate(conds)]
    _assert_batch_invariant(pipe, curs, conds)


def test_pipeline_gop_schedule(wf_setup):
    """The serve.* spans in order, each with its frame: gs_dispatch(k)
    precedes encode(k+1); the x̂ are g_s of each frame's decoded ŷ, and the
    carry is the last ŷ."""
    x, imodel, stem, _, _ = wf_setup
    pipe = WavefrontVideoPipeline(imodel, stem)
    y0 = pipe.analysis(x)
    frames = [x, x * 0.9 + 0.05, x * 1.1 - 0.05]
    with trace.record() as rec:
        encs, x_hats, y_fin = pipe.serve_gop(frames, y0)
    assert len(encs) == 3 and len(x_hats) == 3
    serve = sorted((s for s in rec.spans if s.name.startswith("serve.")),
                   key=lambda s: s.start_ns)
    assert [(s.name, s.attrs["frame"]) for s in serve] == [
        (ev, k) for k in range(3)
        for ev in ("serve.encode", "serve.decode", "serve.gs_dispatch")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(serve, serve[1:]))
    y_cond = y0
    for k in range(3):
        y_hat = pipe.decode_frame(encs[k], y_cond)
        assert torch.equal(x_hats[k], imodel.get_x(y_hat))
        y_cond = y_hat
    assert torch.equal(y_fin, y_cond)


def test_pipeline_serve_latents(wf_setup):
    """latents=True serves precomputed y_cur planes: the wavefront bench's
    sampler (eval/workload.py::wavefront_y_cur) through serve_gop."""
    x, imodel, stem, _, _ = wf_setup
    pipe = WavefrontVideoPipeline(imodel, stem)
    y0 = pipe.analysis(x)
    gen = torch.Generator().manual_seed(9)
    lat = [wavefront_y_cur(imodel, x, y0, gen) for _ in range(2)]
    assert float((lat[0] - y0).std()) == pytest.approx(0.2, rel=0.2)
    encs, x_hats, y_fin = pipe.serve_gop(lat, y0, latents=True)
    assert len(encs) == 2
    assert bool(torch.isfinite(y_fin).all())
    assert x_hats[0].shape == x.shape


def test_pipeline_rejects_parallel_variant(wf_setup):
    _, imodel, _, _, _ = wf_setup
    par = SpatioTemporalPriorModel(variant="without_spm",
                                   entropy_bottleneck_channels=EBC,
                                   in_channels=M, device="cpu")
    par.update()
    with pytest.raises(ValueError):
        WavefrontVideoPipeline(imodel, par)
    serial = SpatioTemporalPriorModel(variant="res",
                                      entropy_bottleneck_channels=EBC,
                                      in_channels=M, ar_mode="serial",
                                      device="cpu")
    serial.update()
    with pytest.raises(ValueError):
        WavefrontVideoPipeline(imodel, serial)


def test_res_bf16_roundtrip_close_to_f32():
    """JAX tests/test_bf16_serving.py:70-90 through the pipeline's codec:
    the res wavefront (tile (2, 4)) at bf16 decodes to finite ŷ whose mean
    distance to the f32 decode is below 0.25 (a decode mismatch shows as
    O(1) garbage), and the stream sizes stay in the f32 regime."""
    m = SpatioTemporalPriorModel(variant="res",
                                 entropy_bottleneck_channels=EBC,
                                 in_channels=M, wavefront_tile=(2, 4),
                                 device="cpu", seed=2)
    m.update()
    imodel = MeanScaleHyperprior(8, M, device="cpu")
    g = torch.Generator().manual_seed(0)
    y_cur = torch.randn((1, M, 8, 8), generator=g)
    y_cond = y_cur + 0.3 * torch.randn((1, M, 8, 8), generator=g)
    pipe = WavefrontVideoPipeline(imodel, m)
    enc32 = pipe.encode_frame(y_cur, y_cond)
    y32 = pipe.decode_frame(enc32, y_cond)
    m.set_compute_dtype(torch.bfloat16)
    imodel.set_compute_dtype(torch.bfloat16)
    enc16, y16, x16 = pipe.serve_latent(y_cur, y_cond)
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    assert float((y16 - y32).abs().mean()) < 0.25
    assert x16.dtype == torch.bfloat16
    b32 = len(enc32["strings"][0][0])
    assert 0.5 * b32 < len(enc16["strings"][0][0]) < 2.0 * b32
