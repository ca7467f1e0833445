"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py). Data crosses between the two as NumPy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    match_latent_to_prior,
    realistic_stem,
)
from spatiotemporalentropymodel_tpu_torch.layers import Conv, Deconv
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)

# the small slice: 64×64 frames, N = M = 64, EB 32
N = M = 64
EBC = 32
B, H, W = 2, 64, 64


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def to_nhwc(t):
    return np.moveaxis(t.detach().cpu().numpy(), 1, -1)


def export_jax_tree(module: torch.nn.Module) -> dict:
    """The port's weights as a JAX parameter tree (the inverse of
    convert.load_jax_params)."""
    tree = {}
    for name, p in module.state_dict().items():
        parts = name.split(".")
        owner, leaf = parts[:-1], parts[-1]
        val = p.detach().cpu().numpy()
        if leaf == "weight":
            sub = module.get_submodule(".".join(owner))
            if isinstance(sub, Deconv):  # (I, O, kh, kw) → flipped HWIO
                val = np.transpose(val, (2, 3, 0, 1))[::-1, ::-1]
            elif isinstance(sub, Conv):
                val = np.transpose(val, (2, 3, 1, 0))
            leaf = "kernel"
        keys, i = [], 0
        while i < len(owner):
            if owner[i] == "layers":
                keys.append(f"layers_{owner[i + 1]}")
                i += 2
            else:
                keys.append(owner[i])
                i += 1
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(val)
    return tree


def jax_tree_numpy(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def frames(seed: int, n: int):
    """n frames (B, H, W, 3) NHWC in [0, 1) and a conditioning latent."""
    rng = np.random.default_rng(seed)
    xs = [rng.random((B, H, W, 3), dtype=np.float32) for _ in range(n)]
    y_cond = (0.5 * rng.standard_normal((B, H // 16, W // 16, M))).astype(
        np.float32)
    return xs, y_cond


def build_slice(seed: int = 0, surgery: bool = True):
    """JAX and port models of the small slice with the same weights.

    The JAX models are initialised, carried into the port, given the
    benchmark workload's surgery there (realistic_stem, then
    match_latent_to_prior on the first frame) and carried back, so both
    sides code the same operating point. Returns (jax_i, jax_stem, port_i, port_stem, xs, y_cond).
    """
    xs, y_cond = frames(seed, 3)
    jax_i = JaxMSH(N, M)
    jax_i.init(jnp.asarray(xs[0]))
    jax_stem = JaxStem(variant="without_spm",
                       entropy_bottleneck_channels=EBC, in_channels=M)
    d = jnp.zeros((1, 4, 4, M))
    jax_stem.init(d, d)

    port_i = MeanScaleHyperprior(N, M, device="cpu")
    port_stem = SpatioTemporalPriorModel(EBC, M, device="cpu")
    load_jax_params(port_i.module, jax_tree_numpy(jax_i.params))
    load_jax_params(port_stem.module, jax_tree_numpy(jax_stem.params))
    port_stem.update()
    if surgery:
        realistic_stem(port_stem)
        match_latent_to_prior(port_i, port_stem, to_nchw(xs[0]),
                              to_nchw(y_cond))
        jax_i.params = jax.tree_util.tree_map(
            jnp.asarray, export_jax_tree(port_i.module))
        jax_stem.params = jax.tree_util.tree_map(
            jnp.asarray, export_jax_tree(port_stem.module))
    jax_stem.update(force=True)
    return jax_i, jax_stem, port_i, port_stem, xs, y_cond
