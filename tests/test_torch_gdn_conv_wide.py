"""``gdn_conv_fused`` for C ≠ O: the gate takes exactly the pairs with a
kernel, (128, 192) among them (g_a's last stage of the hero I-model, N =
128, M = 192), and the port's plain version at 128 → 192 equals the JAX
kernel run in Pallas interpret mode (tests/test_pallas.py's atol 2e-4).
The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py::test_cuda_gdn_conv_fused_128_to_192)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch.convert import invert_conv_weight
from spatiotemporalentropymodel_tpu_torch.layers import GDN, Conv, Sequential
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import to_nchw, to_nhwc


def test_gate_takes_the_instantiated_pairs():
    assert kernels.gdn_conv_supported(128, 192)
    for c in kernels.FUSED_CHANNELS:
        assert kernels.gdn_conv_supported(c, c)
    for pair in ((192, 320), (192, 128), (64, 128), (128, 256)):
        assert not kernels.gdn_conv_supported(*pair)


def test_plain_128_to_192_matches_jax_interpret():
    rng = np.random.default_rng(0)
    c, o = 128, 192
    x = (0.5 * rng.standard_normal((1, 8, 16, c))).astype(np.float32)
    gt = (0.02 * rng.random((c, c)) + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    kernel = (0.05 * rng.standard_normal((5, 5, c, o))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    got = pk.gdn_conv_fused(jnp.asarray(x), jnp.asarray(gt),
                            jnp.asarray(beta), jnp.asarray(kernel),
                            jnp.asarray(bias), True)
    plain = kernels._gdn_conv_ref(
        to_nchw(x), torch.from_numpy(gt), torch.from_numpy(beta),
        torch.from_numpy(invert_conv_weight(kernel)), torch.from_numpy(bias))
    assert plain.shape == (1, o, 4, 8)
    np.testing.assert_allclose(np.asarray(got), to_nhwc(plain), atol=2e-4)


def test_sequential_fuses_the_128_to_192_stage(monkeypatch):
    """A bf16 GDN(128) → Conv(128 → 192, k5 s2) chain goes through
    gdn_conv_fused (its plain version on the CPU), with the chain's
    output."""
    calls = []
    fused = kernels.gdn_conv_fused

    def spy(x, *args):
        calls.append((x.shape[1], args[2].shape[0]))
        return fused(x, *args)

    monkeypatch.setattr(kernels, "gdn_conv_fused", spy)
    g = torch.Generator().manual_seed(1)
    seq = Sequential([GDN(128), Conv(128, 192, 5, 2, g)])
    x = torch.randn((1, 128, 12, 20), generator=g).bfloat16()
    with torch.no_grad():
        seq.to(torch.bfloat16)
        out = seq(x)
        plain = seq.layers[1](seq.layers[0](x))
    assert calls == [(128, 192)]
    assert out.shape == (1, 192, 6, 10)
    scale = float(plain.float().abs().max())
    assert float((out.float() - plain.float()).abs().max()) <= 2**-6 * scale
