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

A checkpoint read without jax (training/checkpoints.py) gives the leaves of
such a tree without their paths: ``load_jax_leaves`` rebuilds the paths from
the port's module in jax's order and loads them. ``jax_leaves`` goes the
other way: the port's parameters as that tree's leaves, with their paths
(the weight hash of the video container, eval/video_codec.py), and
``jax_tree`` nests them as the tree a checkpoint saves.
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
                raise ValueError(
                    f"kernel of a {type(sub).__name__} at {owner}")
            leaf = "weight"
        name = f"{owner}.{leaf}" if owner else leaf
        state[name] = torch.from_numpy(np.array(val, np.float32))
    return state


def _jax_keys(owner):
    """Module path parts → the JAX tree's keys: ``layers.<i>`` → flax's
    ``layers_<i>``."""
    keys, i = [], 0
    while i < len(owner):
        if owner[i] == "layers" and i + 1 < len(owner):
            keys.append(f"layers_{owner[i + 1]}")
            i += 2
        else:
            keys.append(owner[i])
            i += 1
    return keys


def _jax_views(module: torch.nn.Module):
    """(JAX path, the parameter in the JAX layout, whether that layout is
    also flipped in kh and kw) of every parameter of ``module``, in its
    order. The views are transposed only: Conv and MaskedConv2d (O, I, kh,
    kw) → (kh, kw, I, O), Deconv (I, O, kh, kw) → (kh, kw, I, O)."""
    for name, p in module.named_parameters():
        *owner, leaf = name.split(".")
        t, flip = p.detach(), False
        if leaf == "weight":
            sub = module.get_submodule(".".join(owner))
            if isinstance(sub, Deconv):
                t, flip = t.permute(2, 3, 0, 1), True
            elif isinstance(sub, (Conv, MaskedConv2d)):
                t = t.permute(2, 3, 1, 0)
            else:
                raise ValueError(f"weight of a {type(sub).__name__} at "
                                 f"{'.'.join(owner)}")
            leaf = "kernel"
        yield tuple(_jax_keys(owner)) + (leaf,), t, flip


def jax_param_paths(module: torch.nn.Module):
    """[(JAX path, JAX shape)] of ``module``'s parameters in jax's flatten
    order: dict keys sorted as strings at every level (``layers_10`` before
    ``layers_2``), which for paths of keys is the tuples' lexicographic
    order. Kernels take their JAX shapes, (kh, kw, in, out)."""
    return sorted((path, tuple(t.shape)) for path, t, _ in _jax_views(module))


def jax_leaves(module: torch.nn.Module):
    """[(JAX path, NumPy array)] of ``module``'s parameters in jax's flatten
    order, each in the JAX layout (the inverse of ``state_dict_from_jax``)
    and in the parameter's current dtype. NumPy has no bf16: bf16
    parameters come as uint16 arrays of their bit patterns, whose bytes
    are those of the JAX package's bf16 leaves."""
    out = []
    for path, t, flip in _jax_views(module):
        if flip:
            t = torch.flip(t, (0, 1))
        t = t.contiguous().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        out.append((path, arr))
    return sorted(out, key=lambda e: e[0])


def jax_tree(module: torch.nn.Module) -> dict:
    """``module``'s parameters as the JAX package's nested tree of NumPy
    arrays (``jax_leaves`` with their paths as dict keys): what a
    checkpoint saves, its leaves in jax's order."""
    tree = {}
    for path, arr in jax_leaves(module):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def tree_from_leaves(module: torch.nn.Module, leaves) -> dict:
    """The JAX tree of ``module``'s parameters from the first of ``leaves``
    (jax's flatten order, ``jax_param_paths``), one per parameter, each
    checked against its JAX shape."""
    paths = jax_param_paths(module)
    if len(leaves) < len(paths):
        raise ValueError(f"{len(leaves)} leaves for {len(paths)} parameters")
    tree = {}
    for (path, shape), leaf in zip(paths, leaves):
        if tuple(np.shape(leaf)) != shape:
            raise ValueError(f"leaf for {'/'.join(path)} has shape "
                             f"{tuple(np.shape(leaf))}, expected {shape}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(leaf)
    return tree


def load_jax_leaves(module: torch.nn.Module, leaves) -> list:
    """Load ``module``'s parameters from the first of ``leaves`` (see
    ``tree_from_leaves``); returns the leaves after them."""
    n = len(jax_param_paths(module))
    load_jax_params(module, tree_from_leaves(module, leaves))
    return list(leaves[n:])


def load_jax_params(module: torch.nn.Module, tree) -> None:
    """Load a JAX parameter tree into ``module`` (every parameter, exactly:
    a missing or unexpected key raises)."""
    module.load_state_dict(state_dict_from_jax(module, tree), strict=True)
