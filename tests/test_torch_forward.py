"""The port's forwards with likelihoods, against the JAX package on the
CPU: MeanScaleHyperprior and the five STEM variants (eval mode), in f32 and
bf16 on bridged weights, and StemVideoPipeline.gop_forward.

The JAX initialiser leaves every bias at zero, which would hide where a
bias is added; the weights get random biases first. f32: likelihoods rtol
1e-4 and atol 1e-6 (a bin's probability in a Gaussian's tail moves by a
relative 1e-4 when μ moves by 1e-6 of σ's scale: the STEM's random 768-wide
EPM gives |μ| of tens), the estimated bpp rtol 1e-4 (the JAX package sums
the logs in f32), x̂ and ŷ atol 1e-4.
bf16 (the criteria of tests/test_torch_bf16_pipeline.py, at its operating
point: the STEMs get the workload's surgery, eval/workload.py::
realistic_stem, as its slice does): the nets round at other points in XLA
and PyTorch, so a rounding of y − μ may go the other way at a few elements:
ŷ differs at no more than 0.1 % of them, the estimated bpp within rtol
2e-2, and x̂ within 6e-2 at most and 2e-3 on average.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval.metrics import (
    estimate_bpp as jax_estimate_bpp,
)
from spatiotemporalentropymodel_tpu.eval.pipeline import (
    StemVideoPipeline as JaxPipeline,
)
from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.eval.metrics import estimate_bpp
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    StemVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import realistic_stem
from spatiotemporalentropymodel_tpu_torch.models import (
    STEM_VARIANTS,
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)

from torch_port_util import export_jax_tree, jax_tree_numpy, to_nchw, to_nhwc

N, M, EBC = 32, 32, 16
HW = 64
LK_RTOL, LK_ATOL, F32_ATOL, BPP_F32_RTOL = 1e-4, 1e-6, 1e-4, 1e-4
BPP_RTOL, FLIPS = 2e-2, 1e-3
X_MAX, X_MEAN = 6e-2, 2e-3


def _random_biases(params, seed):
    rng = np.random.default_rng(seed)

    def bias(path, p):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return jnp.asarray(0.1 * rng.standard_normal(p.shape), p.dtype)
        return p

    return jax.tree_util.tree_map_with_path(bias, params)


def _frames(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def msh():
    jm = JaxMSH(N, M)
    jm.init(jnp.zeros((1, HW, HW, 3)))
    jm.params = _random_biases(jm.params, 1)
    pm = MeanScaleHyperprior(N, M, device="cpu")
    load_jax_params(pm.module, jax_tree_numpy(jm.params))
    jm.update()
    pm.update()
    return jm, pm


def _stem(variant, seed=2, surgery=False):
    jm = JaxStem(variant=variant, entropy_bottleneck_channels=EBC,
                 in_channels=M)
    d = jnp.zeros((1, 4, 4, M))
    jm.init(d, d)
    jm.params = _random_biases(jm.params, seed)
    pm = SpatioTemporalPriorModel(variant=variant,
                                  entropy_bottleneck_channels=EBC,
                                  in_channels=M, device="cpu")
    load_jax_params(pm.module, jax_tree_numpy(jm.params))
    pm.update()
    if surgery:
        realistic_stem(pm)
        jm.params = jax.tree_util.tree_map(jnp.asarray,
                                           export_jax_tree(pm.module))
    jm.update()
    return jm, pm


def _bf16(*models):
    for m in models:
        m.set_compute_dtype(
            jnp.bfloat16 if hasattr(m, "params") else torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _port_nhwc(t):
    return to_nhwc(t.float())


def _assert_bf16_close(got_hat, want_hat, got_lk, want_lk, pixels, what):
    flips = (np.abs(got_hat - want_hat) > 1e-4).mean()
    assert flips <= FLIPS, f"{what}: ŷ differs at {flips:.2e}"
    bpp = estimate_bpp({k: torch.from_numpy(v) for k, v in got_lk.items()},
                       pixels)
    want = float(jax_estimate_bpp(want_lk, pixels))
    assert bpp == pytest.approx(want, rel=BPP_RTOL), what


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_msh_forward_matches_jax(msh, dtype):
    jm, pm = msh
    if dtype == "bf16":  # fresh copies: the cast is lossy
        jm, pm = JaxMSH(N, M), MeanScaleHyperprior(N, M, device="cpu")
        jm.init(jnp.zeros((1, HW, HW, 3)))
        jm.params = _random_biases(jm.params, 1)
        load_jax_params(pm.module, jax_tree_numpy(jm.params))
        _bf16(jm, pm)
    x = _frames(3, (2, HW, HW, 3))
    want = jm.forward(jnp.asarray(x))
    with torch.no_grad():
        got = pm.forward(to_nchw(x))
    assert set(got) == {"y", "y_hat", "x_hat", "likelihoods"}
    lk = {k: _port_nhwc(v) for k, v in got["likelihoods"].items()}
    if dtype == "f32":
        for k in ("y", "z"):
            np.testing.assert_allclose(lk[k], _f32(want["likelihoods"][k]),
                                       rtol=LK_RTOL, atol=LK_ATOL)
        for k in ("y_hat", "x_hat"):
            np.testing.assert_allclose(_port_nhwc(got[k]), _f32(want[k]),
                                       atol=F32_ATOL)
        return
    assert got["x_hat"].dtype == torch.bfloat16
    _assert_bf16_close(_port_nhwc(got["y_hat"]), _f32(want["y_hat"]), lk,
                       want["likelihoods"], 2 * HW * HW, "msh")
    dx = np.abs(_port_nhwc(got["x_hat"]) - _f32(want["x_hat"]))
    assert dx.max() <= X_MAX and dx.mean() <= X_MEAN


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", STEM_VARIANTS)
def test_stem_forward_matches_jax(variant, dtype):
    jm, pm = _stem(variant, surgery=dtype == "bf16")
    if dtype == "bf16":
        _bf16(jm, pm)
    rng = np.random.default_rng(4)
    y_cur = rng.standard_normal((2, 8, 8, M)).astype(np.float32)
    y_cond = (y_cur + 0.3 * rng.standard_normal(y_cur.shape)).astype(
        np.float32)
    want = jm.forward(jnp.asarray(y_cur), jnp.asarray(y_cond))
    with torch.no_grad():
        got = pm.forward(to_nchw(y_cur), to_nchw(y_cond))
    lk = {k: _port_nhwc(v) for k, v in got["likelihoods"].items()}
    y_hat = _port_nhwc(got["y_hat"])
    if dtype == "f32":
        for k in ("y", "z"):
            np.testing.assert_allclose(lk[k], _f32(want["likelihoods"][k]),
                                       rtol=LK_RTOL, atol=LK_ATOL)
        np.testing.assert_allclose(y_hat, _f32(want["y_hat"]),
                                   atol=F32_ATOL)
        assert estimate_bpp(got["likelihoods"], 128) == pytest.approx(
            float(jax_estimate_bpp(want["likelihoods"], 128)),
            rel=BPP_F32_RTOL)
        return
    _assert_bf16_close(y_hat, _f32(want["y_hat"]), lk, want["likelihoods"],
                       2 * 8 * 8 * 256, variant)


def test_gop_forward_matches_jax(msh):
    """(T, B) = (3, 2) frames of 64×64 through both pipelines' gop_forward:
    x̂ atol 1e-4, bpp_est rtol 1e-3; and each frame's bpp_est is
    estimate_bpp of the STEM forward on that frame's latents."""
    jm, pm = msh
    js, ps = _stem("without_spm", seed=5)
    frames = _frames(6, (3, 2, HW, HW, 3))
    y_cond = (0.5 * np.random.default_rng(7).standard_normal(
        (2, HW // 16, HW // 16, M))).astype(np.float32)
    jx, jbpp = JaxPipeline(jm, js).gop_forward(jnp.asarray(frames),
                                               jnp.asarray(y_cond))
    pipe = StemVideoPipeline(pm, ps)
    px, pbpp = pipe.gop_forward(
        torch.from_numpy(np.ascontiguousarray(frames.transpose(
            0, 1, 4, 2, 3))), to_nchw(y_cond))
    assert px.shape == (3, 2, 3, HW, HW) and pbpp.shape == (3, 2)
    np.testing.assert_allclose(px.numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(jx), atol=F32_ATOL)
    np.testing.assert_allclose(pbpp.numpy(), np.asarray(jbpp), rtol=1e-3)
    with torch.no_grad():
        yc = to_nchw(y_cond)
        for t in range(3):
            out = ps.forward(pm.analysis(torch.from_numpy(
                np.ascontiguousarray(frames[t].transpose(0, 3, 1, 2)))), yc)
            for b in range(2):
                one = {k: v[b:b + 1] for k, v in out["likelihoods"].items()}
                assert float(pbpp[t, b]) == pytest.approx(
                    estimate_bpp(one, HW * HW), rel=1e-12)
            yc = out["y_hat"]
