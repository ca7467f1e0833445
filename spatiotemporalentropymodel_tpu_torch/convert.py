"""Load the JAX package's parameter trees into the port's modules.

A JAX tree is a nested dict of NumPy arrays as flax stores it (for example
``params["g_a"]["layers_0"]["kernel"]``); only tests import jax to produce
one. Layout changes:

  * Conv and MaskedConv2d kernel HWIO → weight OIHW (the masked conv's raw
    kernel, as both packages keep it).
  * Deconv kernel: the JAX package stores the spatially flipped
    ConvTranspose2d weight as (kh, kw, in, out); unflip → (in, out, kh, kw).
  * GDN β/γ (sqrt space), entropy-bottleneck matrix/bias/factor/quantiles and
    biases copy through.
"""

import numpy as np
import torch

from .layers import Conv, Deconv, MaskedConv2d


def invert_conv_weight(k: np.ndarray) -> np.ndarray:
    """(kh, kw, I, O) → (O, I, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def invert_deconv_weight(k: np.ndarray) -> np.ndarray:
    """Flipped (kh, kw, I, O) → ConvTranspose2d (I, O, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _torch_name(part: str) -> str:
    # flax names the entries of a Sequential's layer list layers_<i>
    if part.startswith("layers_") and part[7:].isdigit():
        return "layers." + part[7:]
    return part


def state_dict_from_jax(module: torch.nn.Module, tree) -> dict:
    """The torch state dict equivalent to a JAX parameter tree."""
    state = {}
    for path, val in _flatten(tree):
        owner = ".".join(_torch_name(p) for p in path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            sub = module.get_submodule(owner)
            if isinstance(sub, Deconv):
                val = invert_deconv_weight(val)
            elif isinstance(sub, (Conv, MaskedConv2d)):
                val = invert_conv_weight(val)
            else:
                raise ValueError(f"kernel of a {type(sub).__name__} at {owner}")
            leaf = "weight"
        name = f"{owner}.{leaf}" if owner else leaf
        state[name] = torch.from_numpy(np.array(val, np.float32))
    return state


def load_jax_params(module: torch.nn.Module, tree) -> None:
    """Load a JAX parameter tree into ``module`` (every parameter, exactly:
    a missing or unexpected key raises)."""
    module.load_state_dict(state_dict_from_jax(module, tree), strict=True)
