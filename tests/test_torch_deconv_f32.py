"""deconv_k5s2_f32, g_s's f32 transposed conv, on the CPU: its plain version
(the four sub-pixel phase convs the CUDA kernel computes) against
F.conv_transpose2d + bias and the JAX package's Deconv, and the gate of
layers/conv.py::Synthesis that routes g_s's k5 s2 Deconvs to it.

The phase convs sum in another order than torch's transposed conv, so the
two agree to f32 rounding (1e-5); g_s on the CPU then stays within the f32
tolerance the port's forwards keep to the JAX package (x̂ atol 1e-4,
tests/test_torch_forward.py). On the CPU the wrapper runs the plain
version and counts no launch; tests/test_torch_cuda.py holds the kernel to
float64 on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spatiotemporalentropymodel_tpu import layers as jl
from spatiotemporalentropymodel_tpu_torch import layers as tl
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels
from spatiotemporalentropymodel_tpu_torch.utils import trace

from torch_port_util import export_jax_tree, jax_tree_numpy, to_nchw, to_nhwc

TOL = 1e-5  # the phase convs against one transposed conv: f32 rounding
X_ATOL = 1e-4  # x̂ against the JAX package (tests/test_torch_forward.py)


def _inputs(b, c, o, h, w, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    weight = torch.from_numpy((rng.standard_normal((c, o, 5, 5))
                               * (2.0 / (25 * c)) ** 0.5).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(o).astype(np.float32))
    return x, weight, bias


@pytest.mark.parametrize("c,o,h,w", [
    (192, 192, 5, 7), (192, 3, 6, 9), (128, 128, 4, 5), (256, 256, 3, 4),
    (320, 192, 3, 3), (192, 128, 4, 6), (8, 1, 5, 3), (16, 2, 1, 1)])
def test_plain_matches_conv_transpose(c, o, h, w):
    """At g_s's widths (and the narrow tails, 1×1 inputs): the four phase
    convs + bias equal ConvTranspose2d(k5, s2, p2, op1) + bias within
    1e-5, with output exactly 2H × 2W."""
    x, weight, bias = _inputs(2, c, o, h, w, seed=c + o + h)
    got = kernels.deconv_k5s2_f32(x, weight, bias)
    ref = F.conv_transpose2d(x, weight, None, 2, 2, 1) + bias.view(1, -1, 1,
                                                                   1)
    assert got.shape == (2, o, 2 * h, 2 * w) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("o", [192, 3])
def test_plain_matches_jax_deconv(o):
    """The plain version on a Deconv's own weights against the JAX
    package's Deconv (flipped HWIO) on the same bridged weights, 1e-5."""
    x = np.random.default_rng(o).standard_normal((2, 5, 6, 192)).astype(
        np.float32)
    jax_mod, port = jl.Deconv(o, 5, 2), tl.Deconv(192, o, 5, 2)
    params = jax_tree_numpy(jax_mod.init(jax.random.PRNGKey(o),
                                         jnp.asarray(x))["params"])
    rng = np.random.default_rng(o + 1)
    params = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    load_jax_params(port, params)
    ref = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(x)))
    got = kernels.deconv_k5s2_f32(to_nchw(x), port.weight.detach(),
                                  port.bias.detach())
    np.testing.assert_allclose(to_nhwc(got), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("c,o,want", [
    (192, 192, True), (192, 3, True), (128, 3, True), (256, 256, True),
    (192, 128, True), (16, 32, True), (8, 1, True), (192, 4, False),
    (192, 48, False), (8, 32, False), (12, 3, False), (0, 32, False)])
def test_supported_widths(c, o, want):
    """O a multiple of 32 with C a multiple of 16 (wide), or O 1-3 with C a
    multiple of 8 (narrow)."""
    assert kernels.deconv_k5s2_f32_supported(c, o) is want


def _spy(monkeypatch):
    """deconv_k5s2_f32's calls, as (C, O) (the plain version still runs)."""
    calls = []
    real = kernels.deconv_k5s2_f32

    def spied(x, weight, bias):
        calls.append(tuple(weight.shape[:2]))
        return real(x, weight, bias)

    monkeypatch.setattr(kernels, "deconv_k5s2_f32", spied)
    return calls


@pytest.fixture(scope="module")
def msh():
    return MeanScaleHyperprior(64, 96, device="cpu", seed=5)


def _latent(m=96, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(3 * rng.standard_normal((2, m, 3, 4)))
                            .astype(np.float32))


def test_g_s_routes_f32_no_grad(msh, monkeypatch):
    """An f32 g_s with no graph to record sends its four k5 s2 Deconvs to
    the wrapper (one each, in order), counts each as ``gs.deconv_f32`` in a
    recording, and on the CPU adds nothing to LAUNCHES (the plain version
    ran); x̂ equals the chain of cuDNN-style layers within 1e-5."""
    calls = _spy(monkeypatch)
    y = _latent()
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad(), trace.record() as rec:
        x_hat = msh.module.g_s(y)
    assert calls == [(96, 64), (64, 64), (64, 64), (64, 3)]
    assert rec.counters["gs.deconv_f32"] == 4
    assert kernels.LAUNCHES == launches
    with torch.no_grad():
        ref = tl.Sequential.forward(msh.module.g_s, y)
    torch.testing.assert_close(x_hat, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["grad", "bf16", "h_s", "stem_hd",
                                  "frozen_params"])
def test_gate(msh, monkeypatch, case):
    """The wrapper is not called where autograd records a graph (grad mode
    on, parameters requiring grad), on bf16 input, by h_s or by the STEM's
    HD; with grad mode on but nothing requiring grad it is (4 calls)."""
    calls = _spy(monkeypatch)
    y = _latent()
    g_s = msh.module.g_s
    if case == "grad":
        assert g_s(y).grad_fn is not None
    elif case == "bf16":
        with torch.no_grad():
            out = g_s.to(torch.bfloat16)(y.to(torch.bfloat16))
        g_s.float()
        assert out.dtype == torch.bfloat16
    elif case == "h_s":
        with torch.no_grad():
            msh.module.h_s(_latent(64, 1))
    elif case == "stem_hd":
        stem = SpatioTemporalPriorModel(variant="without_spm",
                                        entropy_bottleneck_channels=32,
                                        in_channels=32, device="cpu", seed=1)
        with torch.no_grad():
            stem.module.HD(torch.zeros((1, 32, 2, 3)))
    else:
        g_s.requires_grad_(False)
        try:
            assert g_s(y).grad_fn is None
        finally:
            g_s.requires_grad_(True)
    assert len(calls) == (4 if case == "frozen_params" else 0)


def test_msh_192_g_s_matches_jax(monkeypatch):
    """MeanScaleHyperprior(192, 192).g_s, routed through the wrapper,
    against the JAX package's g_s on the same weights: x̂ within the f32
    tolerance of the port's forwards (atol 1e-4)."""
    port = MeanScaleHyperprior(192, 192, device="cpu", seed=7)
    g_s = port.module.g_s
    n, m = 192, 192
    jax_g_s = jl.Sequential([
        jl.Deconv(n, 5, 2), jl.GDN(n, inverse=True), jl.Deconv(n, 5, 2),
        jl.GDN(n, inverse=True), jl.Deconv(n, 5, 2), jl.GDN(n, inverse=True),
        jl.Deconv(3, 5, 2)])
    calls = _spy(monkeypatch)
    y = np.round(3 * np.random.default_rng(9).standard_normal(
        (1, 3, 4, m))).astype(np.float32)
    with torch.no_grad():
        got = g_s(to_nchw(y))
    ref = jax_g_s.apply({"params": export_jax_tree(g_s)}, jnp.asarray(y))
    assert len(calls) == 4
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=X_ATOL)
