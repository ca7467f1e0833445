"""conv_k5s2_f32, g_a's f32 conv, on the CPU: its plain version (the four
parity-plane stride-1 convs) against F.conv2d + bias and the JAX package's
Conv, and the gate of layers/conv.py::Analysis that routes g_a's k5 s2 Convs
to it.

The parity-plane convs sum in another order than torch's conv, so the two
agree to f32 rounding (1e-5); g_a on the CPU then stays within the f32
tolerance the port's forwards keep to the JAX package (y atol 1e-4,
tests/test_torch_forward.py). On the CPU the wrapper runs the plain version
and counts no launch; tests/test_torch_cuda.py holds the kernel to float64
on the card.
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
    Cheng2020Attention,
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels
from spatiotemporalentropymodel_tpu_torch.utils import trace

from torch_port_util import export_jax_tree, jax_tree_numpy, to_nchw, to_nhwc

TOL = 1e-5  # the parity-plane convs against one conv: f32 rounding
Y_ATOL = 1e-4  # y against the JAX package (tests/test_torch_forward.py)


def _inputs(b, c, o, h, w, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    weight = torch.from_numpy((rng.standard_normal((o, c, 5, 5))
                               * (2.0 / (25 * c)) ** 0.5).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(o).astype(np.float32))
    return x, weight, bias


@pytest.mark.parametrize("c,o,h,w", [
    (3, 192, 12, 18), (192, 192, 10, 14), (192, 192, 7, 9), (3, 128, 9, 6),
    (128, 128, 8, 11), (128, 192, 6, 6), (192, 320, 5, 8), (16, 32, 1, 1),
    (256, 256, 4, 3)])
def test_plain_matches_conv2d(c, o, h, w):
    """At g_a's widths (odd sides and a 1×1 input too): the four parity-plane
    convs + bias equal Conv2d(k5, s2, p2) + bias within 1e-5, with output
    ⌈H/2⌉ × ⌈W/2⌉."""
    x, weight, bias = _inputs(2, c, o, h, w, seed=c + o + h)
    got = kernels.conv_k5s2_f32(x, weight, bias)
    ref = F.conv2d(x, weight, None, 2, 2) + bias.view(1, -1, 1, 1)
    assert got.shape == (2, o, (h + 1) // 2, (w + 1) // 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("c", [3, 192])
def test_plain_matches_jax_conv(c):
    """The plain version on a Conv's own weights against the JAX package's
    Conv (HWIO) on the same bridged weights, 1e-5."""
    o = 192
    x = np.random.default_rng(c).standard_normal((2, 10, 12, c)).astype(
        np.float32)
    jax_mod, port = jl.Conv(o, 5, 2), tl.Conv(c, o, 5, 2)
    params = jax_tree_numpy(jax_mod.init(jax.random.PRNGKey(c),
                                         jnp.asarray(x))["params"])
    rng = np.random.default_rng(c + 1)
    params = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    load_jax_params(port, params)
    ref = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(x)))
    got = kernels.conv_k5s2_f32(to_nchw(x), port.weight.detach(),
                                port.bias.detach())
    np.testing.assert_allclose(to_nhwc(got), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("c,o,want", [
    (3, 192, True), (3, 128, True), (192, 192, True), (128, 128, True),
    (128, 192, True), (192, 320, True), (16, 32, True), (256, 256, True),
    (3, 3, False), (3, 48, False), (4, 192, False), (8, 32, False),
    (192, 16, False), (0, 32, False), (192, 0, False)])
def test_supported_widths(c, o, want):
    """O a multiple of 32, with C = 3 (narrow) or C a multiple of 16
    (wide)."""
    assert kernels.conv_k5s2_f32_supported(c, o) is want


def _spy(monkeypatch, name="conv_k5s2_f32"):
    """The wrapper's calls, as (C, O) (the plain version still runs)."""
    calls = []
    real = getattr(kernels, name)

    def spied(x, *args):
        calls.append((x.shape[1], args[-1].shape[0]))
        return real(x, *args)

    monkeypatch.setattr(kernels, name, spied)
    return calls


@pytest.fixture(scope="module")
def msh():
    return MeanScaleHyperprior(64, 96, device="cpu", seed=5)


def _frame(seed=0, h=32, w=48):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((2, 3, h, w), dtype=np.float32))


def test_g_a_routes_f32_no_grad(msh, monkeypatch):
    """An f32 g_a with no graph to record sends its four k5 s2 Convs to the
    wrapper (one each, in order), counts each as ``ga.conv_f32`` in a
    recording, and on the CPU adds nothing to LAUNCHES (the plain version
    ran); y equals the chain of cuDNN-style layers within 1e-5."""
    calls = _spy(monkeypatch)
    x = _frame()
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad(), trace.record() as rec:
        y = msh.module.g_a(x)
    assert calls == [(3, 64), (64, 64), (64, 64), (64, 96)]
    assert rec.counters["ga.conv_f32"] == 4
    assert kernels.LAUNCHES == launches
    with torch.no_grad():
        ref = tl.Sequential.forward(msh.module.g_a, x)
    torch.testing.assert_close(y, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["grad", "input_grad", "bf16", "h_a",
                                  "stem_he", "cheng2020", "frozen_params"])
def test_gate(msh, monkeypatch, case):
    """The wrapper is not called where autograd records a graph (grad mode
    on, with parameters or the input requiring grad), on bf16 input (whose
    GDN → Conv pairs still take gdn_conv_fused), by h_a, by the STEM's HE or
    by Cheng2020's g_a; with grad mode on but nothing requiring grad it is
    (4 calls)."""
    calls = _spy(monkeypatch)
    x = _frame()
    g_a = msh.module.g_a
    if case == "grad":
        assert g_a(x).grad_fn is not None
    elif case == "input_grad":
        g_a.requires_grad_(False)
        try:
            assert g_a(x.requires_grad_()).grad_fn is not None
        finally:
            g_a.requires_grad_(True)
    elif case == "bf16":
        fused = _spy(monkeypatch, "gdn_conv_fused")
        with torch.no_grad():
            out = g_a.to(torch.bfloat16)(x.to(torch.bfloat16))
        g_a.float()
        assert out.dtype == torch.bfloat16
        # the GDN → Conv pairs at (64, 64) twice; (64, 96) has no kernel
        assert fused == [(64, 64), (64, 64)]
    elif case == "h_a":
        with torch.no_grad():
            msh.module.h_a(torch.zeros((2, 96, 8, 12)))
    elif case == "stem_he":
        stem = SpatioTemporalPriorModel(variant="without_spm",
                                        entropy_bottleneck_channels=32,
                                        in_channels=32, device="cpu", seed=1)
        with torch.no_grad():
            stem.module.HE(torch.zeros((1, 64, 8, 12)))  # [y, y_cond]
    elif case == "cheng2020":
        model = Cheng2020Attention(32, device="cpu", seed=2)
        with torch.no_grad():
            model.module.g_a(_frame(h=32, w=32))
    else:
        g_a.requires_grad_(False)
        try:
            assert g_a(x).grad_fn is None
        finally:
            g_a.requires_grad_(True)
    assert len(calls) == (4 if case == "frozen_params" else 0)


def test_msh_192_g_a_matches_jax(monkeypatch):
    """MeanScaleHyperprior(192, 192).g_a, routed through the wrapper,
    against the JAX package's g_a on the same weights: y within the f32
    tolerance of the port's forwards (atol 1e-4)."""
    port = MeanScaleHyperprior(192, 192, device="cpu", seed=7)
    g_a = port.module.g_a
    n, m = 192, 192
    jax_g_a = jl.Sequential([
        jl.Conv(n, 5, 2), jl.GDN(n), jl.Conv(n, 5, 2), jl.GDN(n),
        jl.Conv(n, 5, 2), jl.GDN(n), jl.Conv(m, 5, 2)])
    calls = _spy(monkeypatch)
    x = np.random.default_rng(9).random((1, 48, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = g_a(to_nchw(x))
    ref = jax_g_a.apply({"params": export_jax_tree(g_a)}, jnp.asarray(x))
    assert calls == [(3, n), (n, n), (n, n), (n, m)]
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=Y_ATOL)
