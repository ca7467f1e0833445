"""Device meshes for data-parallel work, one controlling process.

Counterpart of spatiotemporalentropymodel_tpu/parallel/mesh.py. The JAX
package runs one program over a mesh: the global batch goes in sharded on
the "data" axis, the parameters replicated, and one result comes out. The
port keeps that model: a ``Mesh`` is an ordered tuple of ``torch.device``s
and an axis name, ``shard_batch`` splits dim 0 into one equal chunk per
entry, ``replicate`` copies a tree to every entry, and the callers
(``train_step.data_parallel_step``, ``StemVideoPipeline.gop_forward_sharded``)
run each shard on its device from this one process and gather onto the
first.

A mesh may name one device more than once: ``Mesh(("cuda:0", "cuda:0"))``
runs two shards on one card, as the JAX tests' virtual host devices do on
one CPU. On several cards each shard's work runs with its card current
(``on_device``), through a copy of the model there (``replica_on``). A
multi-card build can put DistributedDataParallel (one process per card)
under the same API; one card gives it nothing to measure.

Every function that takes an ``axis_name`` raises where it is not the
mesh's, as a JAX sharding naming an axis its mesh lacks does.
``Placement``, ``replicated``, ``batch_sharded`` and ``replicate`` keep the
JAX package's public names; nothing in the port calls them.
"""

import contextlib
import copy
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """An ordered 1-D mesh of devices (repeats allowed) with an axis
    name."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    def __post_init__(self):
        devs = tuple(canonical_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class Placement:
    """Where a tree goes on a mesh: ``dim`` split over the mesh's entries
    (``batch_sharded``: dim 0), or every entry a whole copy (``replicated``:
    dim None)."""

    mesh: Mesh
    dim: Optional[int] = None


def check_axis(mesh: Mesh, axis_name: str) -> None:
    """Raise unless ``axis_name`` is the mesh's axis."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's axis "
                         f"{mesh.axis_name!r}")


def on_device(device):
    """The context a shard's work runs in: its card made current (the
    kernels, new streams and events go to the current card), nothing for
    the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _module(obj) -> torch.nn.Module:
    return obj if isinstance(obj, torch.nn.Module) else obj.module


def _device(obj) -> torch.device:
    if isinstance(obj, torch.nn.Module):
        return canonical_device(next(obj.parameters()).device)
    return canonical_device(obj.device)


def replica(obj, device):
    """A deep copy of ``obj`` on ``device``: an ``nn.Module`` with its
    parameters and buffers there, or a ``CompressionModel`` with its module
    and its entropy tables there."""
    twin = copy.deepcopy(obj)
    if isinstance(twin, torch.nn.Module):
        return twin.to(device)
    twin.module.to(device)
    twin.device = torch.device(device)
    if twin.tables:
        twin.set_tables(twin.tables)
    return twin


# obj → {device: (its replica there, obj's _signature when last copied)}
_REPLICAS = weakref.WeakKeyDictionary()


def _signature(obj):
    """(what a copy of obj's tensors must redo: their dtypes, the compute
    dtype, the tables; what an in-place copy of their values redoes: their
    storage and in-place versions)."""
    state = _module(obj).state_dict(keep_vars=True).values()
    layout = (tuple(t.dtype for t in state),
              getattr(obj, "compute_dtype", None),
              id(getattr(obj, "tables", None)))
    return layout, tuple((t.data_ptr(), t._version) for t in state)


def replica_on(obj, device):
    """``obj`` itself where it lies on ``device``, else its replica there
    (``replica``), kept while ``obj`` lives and brought up to date at each
    call: its values copied in place where ``obj``'s tensors changed since
    (an optimizer step, a load), made anew where their dtypes, the compute
    dtype or the tables changed."""
    device = canonical_device(device)
    if device == _device(obj):
        return obj
    per = _REPLICAS.setdefault(obj, {})
    sig = _signature(obj)
    twin, seen = per.get(device, (None, None))
    if twin is None or seen[0] != sig[0]:
        twin = replica(obj, device)
    elif seen[1] != sig[1]:
        with torch.no_grad():
            for src, dst in zip(_module(obj).state_dict().values(),
                                _module(twin).state_dict().values()):
                dst.copy_(src)
    per[device] = (twin, sig)
    return twin


def canonical_device(device) -> torch.device:
    """``device`` with its index made explicit for a card ("cuda" → the
    current card's "cuda:i"), as a tensor's ``.device`` reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _visible_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """The first ``n_devices`` visible cards (every card by default; the
    CPU where torch sees none)."""
    devices = _visible_devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} "
                             f"visible")
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis_name)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def batch_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> Placement:
    check_axis(mesh, axis_name)
    return Placement(mesh, 0)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _split(x, mesh: Mesh, dim: int):
    n = mesh.size
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"divide into {n} equal shards")
    return [c.to(d) for c, d in zip(x.chunk(n, dim), mesh.devices)]


def shard_batch(batch, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Each tensor of ``batch`` (dim 0 the global batch) as a list of
    ``mesh.size`` equal chunks, chunk i on ``mesh.devices[i]``; raises
    where dim 0 does not divide."""
    check_axis(mesh, axis_name)
    return _tree_map(lambda x: _split(x, mesh, 0), batch)


def replicate(tree, mesh: Mesh):
    """Each tensor of ``tree`` as a list of copies, one on each entry of
    the mesh (the tensor itself where it is already there)."""
    return _tree_map(lambda x: [x.to(d) for d in mesh.devices], tree)
