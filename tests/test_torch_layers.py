"""The port's GDN, Conv, Deconv and Sequential against the JAX package's
layers on the same bridged weights and inputs, on the CPU (atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu import layers as jl
from spatiotemporalentropymodel_tpu_torch import layers as tl
from spatiotemporalentropymodel_tpu_torch.convert import (
    load_jax_params,
    state_dict_from_jax,
)

from torch_port_util import export_jax_tree, jax_tree_numpy, to_nchw, to_nhwc


def _randomize(tree, seed):
    """Perturb every leaf so no layer runs at its trivial init."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(f, tree)


def _pair(jax_mod, port_mod, x_nhwc, seed):
    params = jax_mod.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    params = {"params": _randomize(jax_tree_numpy(params["params"]), seed)}
    load_jax_params(port_mod, params["params"])
    ref = jax_mod.apply(params, jnp.asarray(x_nhwc))
    with torch.no_grad():
        out = port_mod(to_nchw(x_nhwc))
    return to_nhwc(out), np.asarray(ref)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches(inverse):
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 32)).astype(
        np.float32)
    out, ref = _pair(jl.GDN(32, inverse=inverse), tl.GDN(32, inverse=inverse),
                     x, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,s", [(5, 2), (3, 1), (1, 1), (5, 1)])
def test_conv_matches(k, s):
    x = np.random.default_rng(2).standard_normal((2, 9, 12, 16)).astype(
        np.float32)
    out, ref = _pair(jl.Conv(24, k, s), tl.Conv(16, 24, k, s), x, 3)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("features", [24, 3])  # wide, and the RGB tail
def test_deconv_matches(features):
    """k5s2 with output_padding 1: output exactly 2H×2W; the narrow case
    takes the JAX package's sub-pixel lowering."""
    x = np.random.default_rng(4).standard_normal((2, 6, 7, 16)).astype(
        np.float32)
    out, ref = _pair(jl.Deconv(features, 5, 2), tl.Deconv(16, features, 5, 2),
                     x, 5)
    assert out.shape == (2, 12, 14, features)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_sequential_analysis_and_synthesis_chains():
    """g_a- and g_s-shaped chains through both packages' Sequential."""
    x = np.random.default_rng(6).random((1, 32, 32, 3)).astype(np.float32)
    ja = jl.Sequential([jl.Conv(16, 5, 2), jl.GDN(16), jl.Conv(16, 5, 2),
                        jl.GDN(16), jl.Conv(24, 5, 2)])
    ta = tl.Sequential([tl.Conv(3, 16, 5, 2), tl.GDN(16),
                        tl.Conv(16, 16, 5, 2), tl.GDN(16),
                        tl.Conv(16, 24, 5, 2)])
    y, y_ref = _pair(ja, ta, x, 7)
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    js = jl.Sequential([jl.Deconv(16, 5, 2), jl.GDN(16, inverse=True),
                        jl.Deconv(16, 5, 2), jl.GDN(16, inverse=True),
                        jl.Deconv(3, 5, 2)])
    ts = tl.Sequential([tl.Deconv(24, 16, 5, 2), tl.GDN(16, inverse=True),
                        tl.Deconv(16, 16, 5, 2), tl.GDN(16, inverse=True),
                        tl.Deconv(16, 3, 5, 2)])
    x_hat, x_ref = _pair(js, ts, y_ref, 8)
    assert x_hat.shape == x.shape
    np.testing.assert_allclose(x_hat, x_ref, atol=1e-5)


def test_weight_bridge_round_trips():
    """JAX tree → port state dict → JAX tree is the identity, including the
    flipped deconv kernel."""
    ta = tl.Sequential([tl.Conv(3, 8, 5, 2), tl.GDN(8), tl.Deconv(8, 4, 5, 2)])
    ja = jl.Sequential([jl.Conv(8, 5, 2), jl.GDN(8), jl.Deconv(4, 5, 2)])
    tree = _randomize(jax_tree_numpy(ja.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]), 9)
    load_jax_params(ta, tree)
    back = export_jax_tree(ta)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(state_dict_from_jax(ta, tree))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
