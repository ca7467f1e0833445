"""The port past 192 channels, on the CPU: MeanScaleHyperprior(256, 320)
against the JAX package, gdn_fused's plain version at C = 200, 256 and 320
against the JAX kernel in Pallas interpret mode, and the fused kernels'
gates at N = 256.

The model's f32 forward on the JAX weights (carried across by convert.py,
with random biases: the initialiser's zeros would hide where a bias is
added) gives x̂ within atol 1e-4 and the estimated bpp within rtol 1e-3 of
the JAX package's, and its compress gives the JAX streams byte for byte.
gdn_fused: f32 at rtol 1e-5, atol 1e-6; bf16 within one bf16 step (rtol
2⁻⁷), the two packages summing the norm in another order. The kernels
themselves run on the card (tests/test_torch_cuda.py::
test_cuda_gdn_fused_past_192_channels, ``test_cuda_*_256``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval.metrics import (
    estimate_bpp as jax_estimate_bpp,
)
from spatiotemporalentropymodel_tpu.models import MeanScaleHyperprior as JaxMSH
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.eval.metrics import estimate_bpp
from spatiotemporalentropymodel_tpu_torch.models import MeanScaleHyperprior
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import jax_tree_numpy, random_biases, to_nchw, to_nhwc

N, M, HW = 256, 320, 64
X_ATOL, BPP_RTOL = 1e-4, 1e-3
GDN_RTOL, GDN_ATOL, GDN_BF16_RTOL = 1e-5, 1e-6, 2**-7


def _frame(seed=3):
    return np.random.default_rng(seed).random((1, HW, HW, 3),
                                              dtype=np.float32)


@pytest.fixture(scope="module")
def msh():
    """(JAX model, port model) with the same weights, tables built. The JAX
    initialiser is traced once under jit (``init`` runs it op by op, about
    13 s at these widths here) with the keys ``init`` would split."""
    jm = JaxMSH(N, M)
    jm._rng, k1, k2 = jax.random.split(jm._rng, 3)
    init = jax.jit(lambda rngs, x: jm.module.init(rngs, x, train=False))
    params = init({"params": k1, "noise": k2}, jnp.zeros((1, HW, HW, 3)))
    tree = random_biases(jax_tree_numpy(params["params"]), 1)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    pm = MeanScaleHyperprior(N, M, device="cpu")
    load_jax_params(pm.module, tree)
    jm.update(force=True)
    pm.update(force=True)
    return jm, pm


def test_msh_256_320_forward_matches_jax(msh):
    jm, pm = msh
    x = _frame()
    want = jm.forward(jnp.asarray(x))
    with torch.no_grad():
        got = pm.forward(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(got["x_hat"]),
                               np.asarray(want["x_hat"]), atol=X_ATOL)
    bpp = estimate_bpp(got["likelihoods"], HW * HW)
    assert bpp == pytest.approx(
        float(jax_estimate_bpp(want["likelihoods"], HW * HW)), rel=BPP_RTOL)


def test_msh_256_320_compress_matches_jax(msh):
    """The I-frame codec's streams are the JAX package's byte for byte, and
    the port's encoder ŷ is its decoder's exactly."""
    jm, pm = msh
    x = _frame()
    jenc = jm.compress(jnp.asarray(x))
    xt = to_nchw(x)
    enc = pm.compress(xt)
    assert enc["shape"] == jenc["shape"] == (HW // 64, HW // 64)
    assert enc["strings"] == jenc["strings"]
    _, y_enc = pm.fused_encode_expr(xt)
    dec = pm.decompress(enc["strings"], enc["shape"])
    assert torch.equal(y_enc, dec["y_hat"])
    assert dec["x_hat"].shape == (1, 3, HW, HW)


@pytest.mark.parametrize("c", [200, 256, 320])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gdn_fused_plain_past_192_matches_jax_interpret(c, dtype):
    """The port's gdn_fused on a CPU tensor (its plain version) against the
    JAX gdn_fused run through its Pallas kernel in interpret mode, forward
    and inverse, on a dense non-negative γ."""
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, 5, 12, c)) *
         10.0 ** rng.uniform(-1.0, 1.0, (2, 5, 12, 1))).astype(np.float32)
    gt = (0.02 * rng.random((c, c)) + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    xj = jnp.asarray(x, jd)
    xt = to_nchw(np.asarray(xj.astype(jnp.float32))).to(td)
    for inverse in (False, True):
        want = pk.gdn_fused(xj, jnp.asarray(gt), jnp.asarray(beta), inverse,
                            interpret=True)
        got = kernels.gdn_fused(xt, torch.from_numpy(gt),
                                torch.from_numpy(beta), inverse)
        assert got.dtype == td and got.shape == (2, c, 5, 12)
        want = np.asarray(want.astype(jnp.float32))
        got = to_nhwc(got.float())
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=GDN_RTOL,
                                       atol=GDN_ATOL)
        else:
            np.testing.assert_allclose(got, want, rtol=GDN_BF16_RTOL,
                                       atol=GDN_ATOL)


def test_fused_gates_take_256():
    assert kernels.gdn_conv_supported(256, 256)
    assert kernels.gdn_conv_supported(256, 320)
    assert kernels.igdn_deconv_wide_supported(256, 256)
    assert kernels.igdn_deconv_tail_supported(256, 3)
    assert kernels.igdn_deconv_fused_supported(256, 3)
    for pair in ((256, 192), (320, 320), (256, 384)):
        assert not kernels.gdn_conv_supported(*pair)
    assert not kernels.igdn_deconv_wide_supported(256, 320)
    assert not kernels.igdn_deconv_tail_supported(320, 3)


def test_bf16_chains_of_msh_256_320_pick_the_fused_wrappers(monkeypatch):
    """In bf16, g_a runs gdn_conv_fused at (256, 256) twice and at
    (256, 320) once, g_s runs gdn_fused at 256, then the packed pair at
    (256, 256) and (256, 3), and nothing else of the kernels; the outputs
    are those of the wrappers' plain versions on the CPU."""
    calls = []

    def spy(name, widths):
        fn = getattr(kernels, name)

        def wrapped(x, *args):
            calls.append((name, *widths(x, *args)))
            return fn(x, *args)
        monkeypatch.setattr(kernels, name, wrapped)

    spy("gdn_fused", lambda x, *a: (x.shape[1],))
    spy("gdn_conv_fused", lambda x, *a: (x.shape[1], a[2].shape[0]))
    for name in ("igdn_deconv_wide_packed", "igdn_deconv_tail_packed",
                 "igdn_deconv_wide", "igdn_deconv_fused"):
        spy(name, lambda x, *a: (x.shape[1], a[2].shape[1]))
    m = MeanScaleHyperprior(N, M, device="cpu", seed=0)
    m.set_compute_dtype(torch.bfloat16)
    x = torch.from_numpy(_frame()).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        y = m.module.g_a(x)
        assert calls == [("gdn_conv_fused", 256, 256)] * 2 + [
            ("gdn_conv_fused", 256, 320)]
        calls.clear()
        x_hat = m.module.g_s(y)
    assert calls == [("gdn_fused", 256),
                     ("igdn_deconv_wide_packed", 256, 256),
                     ("igdn_deconv_tail_packed", 256, 3)]
    assert y.shape == (1, M, HW // 16, HW // 16) and y.dtype == torch.bfloat16
    assert x_hat.shape == (1, 3, HW, HW)
    assert bool(torch.isfinite(x_hat).all())
