"""The port's ops and its two kernels' plain versions against the JAX
package (Pallas kernels in interpret mode), on the CPU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.entropy import get_scale_table
from spatiotemporalentropymodel_tpu.ops import bound as jbound
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu.ops.parametrizers import (
    NonNegativeParametrizer as JaxNNP,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels
from spatiotemporalentropymodel_tpu_torch.ops.bound import lower_bound
from spatiotemporalentropymodel_tpu_torch.ops.parametrizers import (
    NonNegativeParametrizer,
)
from spatiotemporalentropymodel_tpu_torch.ops.quantize import (
    dequantize,
    quantize,
    quantize_symbols,
    ste_round,
)

from torch_port_util import to_nchw, to_nhwc

# the JAX package's ops/__init__ shadows the module name with its function
jquant = importlib.import_module("spatiotemporalentropymodel_tpu.ops.quantize")


def test_lower_bound_forward_and_pass_through_gradient():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jbound.lower_bound(v, 0.1), jnp.asarray(x))
    (jax_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = lower_bound(xt, 0.1)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jbound.lower_bound(x, 0.1)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jax_grad))


def test_nonnegative_parametrizer_matches():
    rng = np.random.default_rng(1)
    v = rng.random((8, 8)).astype(np.float32)
    jp, tp = JaxNNP(minimum=1e-6), NonNegativeParametrizer(minimum=1e-6)
    np.testing.assert_allclose(tp.init(torch.from_numpy(v)).numpy(),
                               np.asarray(jp.init(jnp.asarray(v))), rtol=1e-6)
    np.testing.assert_allclose(tp(torch.from_numpy(v)).numpy(),
                               np.asarray(jp(jnp.asarray(v))), rtol=1e-6)


def test_quantize_modes_match():
    rng = np.random.default_rng(2)
    x = (4 * rng.standard_normal(256)).astype(np.float32)
    x[:9] = np.arange(-4, 5) + 0.5  # half-even ties
    mu = rng.standard_normal(256).astype(np.float32)
    mu[:9] = 0.0
    xt, mt = torch.from_numpy(x), torch.from_numpy(mu)
    np.testing.assert_array_equal(
        quantize(xt, "symbols", mt).numpy(),
        np.asarray(jquant.quantize(jnp.asarray(x), "symbols",
                                   jnp.asarray(mu))))
    np.testing.assert_array_equal(
        quantize(xt, "dequantize", mt).numpy(),
        np.asarray(jquant.quantize(jnp.asarray(x), "dequantize",
                                   jnp.asarray(mu))))
    np.testing.assert_array_equal(ste_round(xt).numpy(),
                                  np.asarray(jquant.ste_round(x)))
    sym = quantize_symbols(xt, mt)
    np.testing.assert_array_equal(
        dequantize(sym, mt).numpy(),
        np.asarray(jquant.dequantize(jnp.asarray(sym.numpy()),
                                     jnp.asarray(mu))))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 3, 7, 48)])
def test_gdn_fused_matches_pallas(inverse, shape):
    """Channel-second port kernel (plain version on the CPU) vs the Pallas
    kernel in interpret mode on the same NHWC data, rtol 1e-5."""
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    gamma_t = (0.02 * rng.random((c, c)) + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    ref = pk.gdn_fused(jnp.asarray(x), jnp.asarray(gamma_t),
                       jnp.asarray(beta), inverse, interpret=True)
    before = dict(kernels.LAUNCHES)
    out = kernels.gdn_fused(to_nchw(x), torch.from_numpy(gamma_t),
                            torch.from_numpy(beta), inverse)
    assert kernels.LAUNCHES == before  # the CPU runs the plain version
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _qidx_inputs(seed=4, shape=(2, 8, 8, 64)):
    rng = np.random.default_rng(seed)
    table = get_scale_table()
    t32 = table.astype(np.float32)
    means = (2 * rng.standard_normal(shape)).astype(np.float32)
    y = (means + 3 * rng.standard_normal(shape)).astype(np.float32)
    scales = np.exp(4 * rng.random(shape) - 3).astype(np.float32)
    yf, mf, sf = y.reshape(-1), means.reshape(-1), scales.reshape(-1)
    ties = np.arange(-20, 21, dtype=np.float32) + 0.5  # y − μ on ±k.5
    mf[:ties.size], yf[:ties.size] = 0.0, ties
    big = np.array([3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128], np.float32)
    o = ties.size
    mf[o:o + big.size], yf[o:o + big.size] = 0.0, big
    edges = np.concatenate([
        t32, np.nextafter(t32, np.float32(-1)),
        np.nextafter(t32, np.float32(1e9)),
        np.array([0.11, 0.0, -1.0, 0.05], np.float32),
        np.nextafter(np.float32(0.11), np.float32(1))[None],
    ]).astype(np.float32)
    sf[:edges.size] = edges
    return y, means, scales, table


def test_quantize_and_index_matches_pallas_exactly():
    y, means, scales, table = _qidx_inputs()
    ref_sym, ref_idx = pk.quantize_and_index(
        jnp.asarray(y), jnp.asarray(means), jnp.asarray(scales), table,
        interpret=True)
    before = dict(kernels.LAUNCHES)
    sym, idx = kernels.quantize_and_index(
        to_nchw(y), to_nchw(means), to_nchw(scales), table)
    assert kernels.LAUNCHES == before
    assert sym.dtype == torch.int32 and idx.dtype == torch.uint8
    np.testing.assert_array_equal(to_nhwc(sym), np.asarray(ref_sym))
    np.testing.assert_array_equal(to_nhwc(idx), np.asarray(ref_idx))


def test_wrappers_raise_on_devices_without_a_kernel():
    """A wrapper runs its plain version for CPU tensors only; elsewhere it
    launches its kernel or raises — here, on the meta device, it raises."""
    x = torch.empty((1, 4, 2, 2), device="meta")
    g = torch.empty((4, 4), device="meta")
    b = torch.empty((4,), device="meta")
    with pytest.raises(ValueError):
        kernels.gdn_fused(x, g, b)
    with pytest.raises(ValueError):
        kernels.quantize_and_index(x, x, x, torch.empty(64, device="meta"))
