"""The port's STEM (without_spm) and its codec expressions against the JAX
package on bridged weights, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.entropy import base as jbase
from spatiotemporalentropymodel_tpu_torch.entropy import base as tbase
from spatiotemporalentropymodel_tpu_torch.entropy import transport
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import build_slice, to_nchw, to_nhwc


@pytest.fixture(scope="module")
def plain():
    """Untrained weights (no workload surgery): (σ, μ) vary everywhere."""
    jax_i, jax_stem, port_i, port_stem, xs, y_cond = build_slice(
        seed=1, surgery=False)
    y_cur = np.asarray(jax_i._apply(jnp.asarray(xs[0]),
                                    method="analysis")[0])
    return jax_stem, port_stem, y_cur, y_cond


def test_hyper_encode_and_entropy_params_match(plain):
    jax_stem, port_stem, y_cur, y_cond = plain
    z = np.asarray(jax_stem._apply(jnp.asarray(y_cur), jnp.asarray(y_cond),
                                   method="hyper_encode"))
    z_hat = np.round(z)
    scales, means = jax_stem._apply(jnp.asarray(z_hat), jnp.asarray(y_cond),
                                    method="entropy_params")
    with torch.no_grad():
        z_t = port_stem.module.hyper_encode(to_nchw(y_cur), to_nchw(y_cond))
        s_t, m_t = port_stem.module.entropy_params(to_nchw(z_hat),
                                                   to_nchw(y_cond))
    np.testing.assert_allclose(to_nhwc(z_t), z, atol=1e-5)
    np.testing.assert_allclose(to_nhwc(s_t), np.asarray(scales), atol=1e-5)
    np.testing.assert_allclose(to_nhwc(m_t), np.asarray(means), atol=1e-5)


def test_jax_planes_through_port_quantizer_and_coder_give_same_streams(plain):
    """JAX-computed (y, μ, σ) and z through the port's quantize_and_index,
    tables and coder: the y and z strings equal the JAX model API's."""
    jax_stem, port_stem, y_cur, y_cond = plain
    ref = jax_stem.compress(jnp.asarray(y_cur), jnp.asarray(y_cond))
    med = jax_stem.tables["entropy_bottleneck"].medians.astype(np.float32)
    z = np.asarray(jax_stem._apply(jnp.asarray(y_cur), jnp.asarray(y_cond),
                                   method="hyper_encode"))
    z_sym = np.clip(np.round(z - med), -32767, 32767)
    scales, means = jax_stem._apply(jnp.asarray(z_sym + med),
                                    jnp.asarray(y_cond),
                                    method="entropy_params")
    sym, idx = kernels.quantize_and_index(
        to_nchw(y_cur), to_nchw(np.asarray(means)),
        to_nchw(np.asarray(scales)),
        port_stem.tables["gaussian_conditional"].scale_table)
    y_strings = tbase.compress(
        np.clip(to_nhwc(sym), -32767, 32767), to_nhwc(idx).astype(np.int32),
        port_stem.tables["gaussian_conditional"])
    zt = port_stem.tables["entropy_bottleneck"]
    z_strings = tbase.compress(
        z_sym.astype(np.int32),
        tbase.bottleneck_indexes(z_sym.shape, zt.rows), zt)
    assert y_strings == ref["strings"][0]
    assert z_strings == ref["strings"][1]


def test_model_api_streams_and_decode_match_jax(plain):
    jax_stem, port_stem, y_cur, y_cond = plain
    ref = jax_stem.compress(jnp.asarray(y_cur), jnp.asarray(y_cond))
    enc = port_stem.compress(to_nchw(y_cur), to_nchw(y_cond))
    assert enc["shape"] == ref["shape"]
    assert enc["strings"] == ref["strings"]
    ref_hat = jax_stem.decompress(ref["strings"], ref["shape"],
                                  jnp.asarray(y_cond))["y_hat"]
    y_hat = port_stem.decompress(enc["strings"], enc["shape"],
                                 to_nchw(y_cond))["y_hat"]
    np.testing.assert_allclose(to_nhwc(y_hat), np.asarray(ref_hat), atol=1e-5)


def test_sparse_transport_buffer_identical_to_jax(plain):
    """The device-side sparse buffer (bitmask, values, counts, z, meta) is
    the JAX package's byte for byte, and the port's carry equals the
    decoder-side reconstruction from the same buffer."""
    jax_stem, port_stem, y_cur, y_cond = plain
    small = 0.05 * y_cur  # converged-model spread: the frame ships sparse
    ref = np.asarray(jax_stem.fused_encode_sparse_expr(jnp.asarray(small),
                                                       jnp.asarray(y_cond)))
    packed, y_hat = port_stem.fused_encode_sparse_carry_expr(
        to_nchw(small), to_nchw(y_cond))
    np.testing.assert_array_equal(packed.numpy(), ref)
    b, h, w, _ = y_cur.shape
    zh, zw, zc = h // 4, w // 4, port_stem.tables["entropy_bottleneck"].rows
    layout = transport.SparseLayout(b=b, n=y_cur[0].size, zn=zh * zw * zc,
                                    levels=64)
    planes = transport.unpack_encode(packed.numpy(), layout)
    assert not planes.overflow
    z_sym = torch.from_numpy(planes.z_sym).view(b, zh, zw, zc).permute(
        0, 3, 1, 2)
    order, means = port_stem.fused_params_sparse_expr(z_sym,
                                                      to_nchw(y_cond))
    maskbits, values = transport.pack_decode_payload(planes.y_sorted,
                                                     layout.cap)
    dec = port_stem.fused_reconstruct_sparse_expr(
        torch.from_numpy(maskbits), torch.from_numpy(values), order, means,
        to_nchw(y_cond))
    assert torch.equal(dec, y_hat)
