"""Spatial model-parallelism: one frame split along W over a mesh.

Counterpart of spatiotemporalentropymodel_tpu/parallel/spatial.py. There a
frame W-sharded over a mesh runs through the transforms and GSPMD inserts
the convolutions' halo exchanges. Torch has no such partitioner, so the
port splits W itself: each shard takes its own columns plus a halo on each
side (clipped at the frame's border, where the layers' own zero padding
applies as before), runs the transform on its device, and crops each output
to its own columns at that output's stride.

The halo is the transform's receptive-field radius, rounded up to its total
stride so that every shard starts on the stride's phase: for g_a's four
k5 s2 convolutions 2 + 4 + 8 + 16 = 30 → 32 pixels, for g_s's k5 s2
transposed convolutions under 2 latent columns → 2. ``stack_halo``
computes it from the layers (kernel, stride, padding). A halo smaller than
the radius changes the columns next to each interior cut. ``shard_frame``
raises for a W that does not divide the mesh, as the JAX package's does;
an output whose columns do not split into whole columns per shard is
computed whole (``spatial_apply``).

A W-split tensor is a ``Sharded`` value: its shards (NCHW, shard i on the
mesh's i-th device), the mesh and the split dimension (3); ``gather()``
concatenates it on the first device. ``shard_frame``, ``spatial_apply``
and ``eval/pipeline.py::StemVideoPipeline`` take it as input. Each shard
runs with its card current (``mesh.on_device``), through the model's copy
on its device (``mesh.replica_on``). ``frame_sharding`` keeps
the JAX package's public name; nothing in the port calls it.
"""

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional

import torch

from .mesh import (
    Mesh, Placement, check_axis, make_mesh, on_device, replica_on,
)

SP_AXIS = "sp"
_W = 3  # NCHW

# the stacks each transform method of the models runs, in order
METHOD_STACKS = {
    "analysis": ("g_a",),
    "get_x": ("g_s",),
    "hyper_encode": ("HE",),
}


@dataclass
class Sharded:
    """A tensor split along ``dim`` over ``mesh``: ``shards[i]`` lies on
    ``mesh.devices[i]``."""

    shards: List[torch.Tensor]
    mesh: Mesh
    dim: int = _W

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.dim] = sum(t.shape[self.dim] for t in self.shards)
        return torch.Size(s)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        first = self.mesh.devices[0]
        return torch.cat([t.to(first) for t in self.shards], dim=self.dim)

    def map(self, fn) -> "Sharded":
        """fn applied to each shard (a pointwise function)."""
        return Sharded([fn(t) for t in self.shards], self.mesh, self.dim)


def whole(x):
    """x itself, or a ``Sharded`` x gathered."""
    return x.gather() if isinstance(x, Sharded) else x


def make_spatial_mesh(n_devices: Optional[int] = None,
                      axis_name: str = SP_AXIS) -> Mesh:
    return make_mesh(n_devices, axis_name)


def frame_sharding(mesh: Mesh, axis_name: str = SP_AXIS) -> Placement:
    """An NCHW frame split along W (the widest side at 16:9, so a shard's
    halo is small beside its area)."""
    check_axis(mesh, axis_name)
    return Placement(mesh, _W)


def _dense(t, device=None):
    """A copy of t on ``device`` with the canonical NCHW strides (see
    models/base.py::_nchw)."""
    return torch.empty(t.shape, dtype=t.dtype,
                       device=device or t.device).copy_(t)


def shard_frame(x, mesh: Mesh, axis_name: str = SP_AXIS) -> Sharded:
    """An NCHW tensor (or a ``Sharded`` one) split along W over ``mesh``
    into equal shards; raises where W does not divide the mesh size."""
    check_axis(mesh, axis_name)
    if isinstance(x, Sharded):
        if x.mesh == mesh and x.dim == _W:
            return x
        x = x.gather()
    n = mesh.size
    if x.dim() != 4 or x.shape[_W] % n:
        raise ValueError(f"frame of shape {tuple(x.shape)}: W not divisible "
                         f"by the mesh size {n}")
    return Sharded([_dense(c, d) for c, d in zip(x.chunk(n, _W),
                                                  mesh.devices)], mesh)


# ---- the halo -------------------------------------------------------------


def _leaves(module):
    from ..layers.conv import Sequential

    if isinstance(module, Sequential):
        for layer in module.layers:
            yield from _leaves(layer)
    else:
        yield module


def receptive_field(stacks):
    """(radius, stride) of layer stacks run one after another: how far, in
    input columns, an output column reads to either side, and how many
    input columns make one output column (a Fraction below 1 where the
    stacks upsample). Convolutions and transposed convolutions count; GDN
    and activations are pointwise; any other layer with weights raises."""
    from ..layers.conv import Conv, Deconv
    from ..layers.gdn import GDN

    radius, scale = Fraction(0), Fraction(1)
    for stack in stacks:
        for layer in _leaves(stack):
            if isinstance(layer, Conv):
                radius += layer.padding * scale
                scale *= layer.stride
            elif isinstance(layer, Deconv):
                # out[o] reads in[i] for s·i ∈ [o + p − (k − 1), o + p]
                k, s = layer.weight.shape[-1], layer.stride
                reach = max(layer.padding, k - 1 - layer.padding)
                radius += math.ceil(Fraction(reach, s)) * scale
                scale /= s
            elif not isinstance(layer, GDN) and any(
                    True for _ in layer.parameters()):
                raise TypeError(f"no receptive field known for "
                                f"{type(layer).__name__}")
    return radius, scale


def stack_halo(*stacks) -> int:
    """The halo in input columns for layer stacks run in order: their
    receptive-field radius rounded up to their total stride (at least
    one column)."""
    radius, stride = receptive_field(stacks)
    step = max(1, math.ceil(stride))
    return int(math.ceil(radius / step) * step)


def method_halo(model, method: str) -> int:
    """The halo of a transform method of a model (``METHOD_STACKS``)."""
    if method not in METHOD_STACKS:
        raise ValueError(f"no stacks known for method {method!r}; pass halo=")
    module = getattr(model, "module", model)
    return stack_halo(*(module.get_submodule(name)
                        for name in METHOD_STACKS[method]))


# ---- running a function on W-split inputs -----------------------------------


def _pieces(x):
    """[(first column, tensor)] of x along W."""
    if isinstance(x, Sharded):
        starts, col = [], 0
        for t in x.shards:
            starts.append(col)
            col += t.shape[_W]
        return list(zip(starts, x.shards))
    return [(0, x)]


def _columns(pieces, a: int, b: int, device):
    """Columns [a, b) of a split tensor, on ``device``."""
    parts = [t[..., max(a, s) - s:min(b, s + t.shape[_W]) - s].to(device)
             for s, t in pieces if s < b and s + t.shape[_W] > a]
    return _dense(parts[0], device) if len(parts) == 1 else torch.cat(
        parts, dim=_W)


def halo_map(fn, inputs, mesh: Mesh, halo: int):
    """fn(*inputs) with every input split along W over ``mesh`` (inputs of
    one width, whole or ``Sharded``): shard i runs fn on its columns plus
    ``halo`` on each side on ``mesh.devices[i]`` and keeps its own columns
    of each output. Returns a ``Sharded`` for each 4-D output, or None
    for an output whose columns do not split into whole columns on every
    shard (a tuple where fn returns one)."""
    n = mesh.size
    width = inputs[0].shape[_W]
    if any(x.shape[_W] != width for x in inputs) or width % n:
        raise ValueError(f"inputs of widths {[x.shape[_W] for x in inputs]} "
                         f"do not split into {n} equal shards")
    w = width // n
    sources = [_pieces(x) for x in inputs]
    per_shard = []
    for i, device in enumerate(mesh.devices):
        lo, hi = i * w, (i + 1) * w
        a, b = max(0, lo - halo), min(width, hi + halo)
        with on_device(device):
            out = fn(*(_columns(p, a, b, device) for p in sources))
        outs = out if isinstance(out, tuple) else (out,)
        cropped = []
        for o in outs:
            if not (torch.is_tensor(o) and o.dim() == 4):
                raise TypeError("a W-split function must return 4-D "
                                "tensors")
            ratio = Fraction(o.shape[_W], b - a)
            c0, c1 = (lo - a) * ratio, (hi - a) * ratio
            whole_cols = c0.denominator == 1 and c1.denominator == 1
            cropped.append(_dense(o[..., int(c0):int(c1)]) if whole_cols
                           else None)
        per_shard.append(cropped)
    results = tuple(
        None if any(s[j] is None for s in per_shard)
        else Sharded([s[j] for s in per_shard], mesh)
        for j in range(len(per_shard[0])))
    return results if isinstance(out, tuple) else results[0]


def spatial_apply(model, method: str, x, mesh: Mesh, *,
                  axis_name: str = SP_AXIS, gather: bool = False,
                  halo: Optional[int] = None):
    """Run one transform method of a model (``CompressionModel`` or its
    module: ``analysis``, ``get_x``, STEM ``hyper_encode``…) with its input
    W-split over ``mesh``. ``x``: an NCHW tensor or ``Sharded`` value, or a
    tuple of them for a method of several inputs.

    ``halo``: columns of context each shard takes on either side; by default
    ``method_halo``, the receptive field of the stacks the method runs.
    Returns a ``Sharded`` value for each output whose columns split over
    the mesh, and the other outputs whole on the first device, computed
    there from the gathered input (the JAX package's rule: every output
    whose W divides the mesh is pinned W-sharded, the others replicated);
    with ``gather=True`` every output whole on the first device."""
    def fn(*args):
        # the model's copy on the shard's device (itself where it lies)
        target = replica_on(model, args[0].device)
        return (getattr(target, method, None)
                or getattr(target.module, method))(*args)

    if halo is None:
        halo = method_halo(model, method)
    inputs = x if isinstance(x, tuple) else (x,)
    inputs = tuple(shard_frame(v, mesh, axis_name) for v in inputs)
    with torch.no_grad():
        out = halo_map(fn, inputs, mesh, halo)
        outs = out if isinstance(out, tuple) else (out,)
        if any(o is None for o in outs):
            full = fn(*(v.gather() for v in inputs))
            full = full if isinstance(full, tuple) else (full,)
            outs = tuple(f if o is None else o for o, f in zip(outs, full))
    if gather:
        outs = tuple(whole(o) for o in outs)
    return outs if isinstance(out, tuple) else outs[0]
