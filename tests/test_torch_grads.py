"""Gradients through the port's kernel wrappers on the CPU, against jax.grad of
the JAX package's Pallas kernels in interpret mode (their custom_vjp rules
differentiate the ``_*_ref`` compositions, as the port's backward does).

Every case takes the loss sum(out · R) with the same random cotangent R in
both packages and compares the gradients of x, γᵀ, β, the weight and the
bias, f32, atol 1e-4. The JAX packed layouts are unpacked inside the JAX
loss, so both sides differentiate with respect to the same logical tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch.convert import (
    invert_conv_weight,
    invert_deconv_weight,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import to_nchw, to_nhwc

ATOL = 1e-4


def _weights(rng, c, o, conv: bool):
    gt = (0.01 * np.abs(rng.standard_normal((c, c)))
          + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    kernel = (0.05 * rng.standard_normal((5, 5, c, o))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    port_w = invert_conv_weight(kernel) if conv else invert_deconv_weight(
        kernel)
    return gt, beta, kernel, bias, port_w


# name → (input NHWC shape, outputs, JAX function of (x, γᵀ, β, kernel, bias)
# on the logical NHWC input, returning the logical NHWC output)
CASES = {
    "gdn_conv_fused": ((1, 8, 12, 32), 24, lambda *a: pk.gdn_conv_fused(
        *a, True)),
    "igdn_deconv_fused": ((1, 4, 6, 32), 3, lambda *a: pk.igdn_deconv_fused(
        *a, 2, True)),
    "igdn_deconv_wide": ((1, 4, 6, 32), 24, lambda *a: pk.igdn_deconv_wide(
        *a, True)),
    "igdn_deconv_wide_packed": (
        (1, 4, 6, 32), 24, lambda *a: pk._unpack_phase_major(
            pk.igdn_deconv_wide_packed(*a, True), 24)),
    "igdn_deconv_tail_packed": (
        (1, 6, 10, 16), 3, lambda x, *a: pk.igdn_deconv_tail_packed(
            _pack_phase_major(x), *a, True)),
}


def _pack_phase_major(y):
    """The logical input, packed for the JAX tail kernel: (B, 2H', 2W', C)
    → the TPU's phase-major (B, H', W', 4C)."""
    b, h2, w2, c = y.shape
    v = y.reshape(b, h2 // 2, 2, w2 // 2, 2, c)
    return v.transpose(0, 1, 3, 2, 4, 5).reshape(b, h2 // 2, w2 // 2, 4 * c)


def _port_grads(fn, x, rest, cot):
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
              for a in (to_nchw(x).numpy(), *rest)]
    out = fn(*leaves)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, to_nchw(cot))
    return out, [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_fused_conv_gradients_match_jax(name):
    shape, o, jax_fn = CASES[name]
    rng = np.random.default_rng(len(name))
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    gt, beta, kernel, bias, port_w = _weights(rng, shape[-1], o,
                                              name == "gdn_conv_fused")
    out_ref = jax_fn(jnp.asarray(x), jnp.asarray(gt), jnp.asarray(beta),
                     jnp.asarray(kernel), jnp.asarray(bias))
    cot = rng.standard_normal(out_ref.shape).astype(np.float32)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jax_fn(*a) * cot), argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), jnp.asarray(gt), jnp.asarray(beta),
        jnp.asarray(kernel), jnp.asarray(bias))
    out, grads = _port_grads(getattr(kernels, name), x,
                             (gt, beta, port_w, bias), cot)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(out_ref), atol=5e-4)
    invert = (invert_conv_weight if name == "gdn_conv_fused"
              else invert_deconv_weight)
    want = [np.moveaxis(np.asarray(jgrads[0]), -1, 1), np.asarray(jgrads[1]),
            np.asarray(jgrads[2]), invert(np.asarray(jgrads[3])),
            np.asarray(jgrads[4])]
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_fused_gradients_match_jax(inverse):
    rng = np.random.default_rng(30 + inverse)
    x = rng.standard_normal((2, 5, 7, 64)).astype(np.float32)
    gt, beta, _, _, _ = _weights(rng, 64, 1, False)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jgrads = jax.grad(
        lambda *a: jnp.sum(pk.gdn_fused(*a, inverse, True) * cot),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gt),
                           jnp.asarray(beta))
    _, grads = _port_grads(
        lambda *a: kernels.gdn_fused(*a, inverse), x, (gt, beta), cot)
    want = [np.moveaxis(np.asarray(jgrads[0]), -1, 1), np.asarray(jgrads[1]),
            np.asarray(jgrads[2])]
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got, ref, atol=ATOL)


def test_gradients_keep_each_input_dtype_and_skip_unneeded():
    """bf16 x gets a bf16 gradient and the f32 γᵀ, β an f32 one; an input
    without requires_grad gets none; under no_grad nothing is recorded."""
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((1, 64, 4, 5)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
    gt = torch.eye(64).requires_grad_()
    beta = torch.ones(64)
    out = kernels.gdn_fused(x, gt, beta, True)
    gx, gg = torch.autograd.grad(out.float().sum(), [x, gt])
    assert gx.dtype == torch.bfloat16 and gg.dtype == torch.float32
    assert beta.grad is None
    with torch.no_grad():
        assert kernels.gdn_fused(x, gt, beta).grad_fn is None
