"""CompressionModel host wrapper.

Counterpart of spatiotemporalentropymodel_tpu/models/base.py
(compressai/models/priors.py:42-106): a thin host object around

  * an ``nn.Module`` (``self.module``) holding the architecture and weights,
    on ``self.device``,
  * explicit :class:`CodecTables` per entropy-model instance
    (``self.tables``), built by the pure NumPy ``update`` functions,
  * a serving compute dtype (``set_compute_dtype``): f32 by default, bf16
    for the transform nets with f32 entropy math.
"""

from typing import Any, Dict

import numpy as np
import torch

from ..coders import get_coder
from ..entropy import base as entropy_base
from ..entropy.tables import CodecTables
from ..entropy import (
    EntropyBottleneck,
    get_scale_table,
    update_bottleneck_tables,
    update_gaussian_tables,
)
from ..ops import kernels


def _nhwc_flat(t, b):
    """NCHW (b, c, h, w) → (b, h·w·c) in the JAX package's NHWC order."""
    return t.permute(0, 2, 3, 1).reshape(b, -1)


def _as_bytes(t):
    return t.contiguous().view(torch.uint8).reshape(-1)


def _nchw(t, dtype=torch.float32):
    """A ``dtype`` copy with the canonical NCHW strides. ``.contiguous()`` is
    not enough: a permuted tensor with a size-1 dimension counts as
    contiguous yet keeps channels-last strides, which steer the convs to
    other algorithms, and then the decoder's (σ, μ) and ŷ would differ from
    the encoder's in the last bit."""
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def _common_dtype(*tensors):
    """The tensors as they are where they share a dtype, else all in f32
    (exact from bf16)."""
    if all(t.dtype == tensors[0].dtype for t in tensors):
        return tensors
    return tuple(t.float() for t in tensors)


def _to_nchw(plane_nhwc: np.ndarray, device):
    """Host NHWC int plane → device NCHW int32 tensor, canonical strides."""
    t = torch.from_numpy(np.ascontiguousarray(plane_nhwc, np.int32))
    return _nchw(t.to(device).permute(0, 3, 1, 2), torch.int32)


def aux_loss(module):
    """The aux loss of every EntropyBottleneck in ``module``, summed: what
    the aux optimizer minimises, over ``quantiles`` only."""
    return sum(m.aux_loss() for m in module.modules()
               if isinstance(m, EntropyBottleneck))


class CompressionModel:
    """Base wrapper; subclasses set ``module`` and implement the codec path."""

    # names of EntropyBottleneck submodules of ``module``
    bottleneck_names = ("entropy_bottleneck",)
    # whether the model owns a GaussianConditional (scale-table driven)
    has_gaussian = False

    def __init__(self, module, device="cuda"):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval()
        self.tables: Dict[str, Any] = {}

    @property
    def coder(self):
        return get_coder()

    # serving compute dtype of the transform nets; None = float32. The
    # fused codec expressions cast back to f32 before quantization and CDF
    # indexing whatever it is.
    compute_dtype = None

    @torch.no_grad()
    def set_compute_dtype(self, dtype=None):
        """Serve the transform nets at ``dtype`` (e.g. ``torch.bfloat16``);
        models/base.py:90-112 of the JAX package.

        Casts the floating parameters of ``module`` and marks inputs for
        casting (``_cast_in``); the codec tables stay exact. Call AFTER the
        weights are final and AFTER ``update()``, so the tables come from
        full-precision quantiles. The cast is lossy: ``None`` serves f32
        again, but only reloading the weights recovers them exactly.
        """
        self.compute_dtype = dtype
        target = torch.float32 if dtype is None else dtype
        for p in self.module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(target)

    def _cast(self, t):
        """A net input in the compute dtype, with the canonical NCHW
        strides on encoder and decoder alike (see ``_nchw``); f32 inputs
        pass as they are when no compute dtype is set."""
        if self.compute_dtype is None:
            return t
        return _nchw(t, self.compute_dtype)

    def _cast_in(self, t):
        """An input in the compute dtype (models/base.py:114-119)."""
        if self.compute_dtype is not None and t.is_floating_point():
            return t.to(self.compute_dtype)
        return t

    def forward(self, *args, train: bool = False, generator=None):
        """The module's forward with rate estimation (models/base.py:141-145
        of the JAX package): in eval mode quantization rounds and the inputs
        go in the compute dtype; in train mode it adds U(-0.5, 0.5) noise
        from ``generator`` and the inputs go as they are."""
        if not train:
            args = tuple(self._cast_in(a) for a in args)
        return self.module(*args, train=train, generator=generator)

    def aux_loss(self):
        """The EntropyBottlenecks' aux loss, summed (priors.py:58-65)."""
        return aux_loss(self.module)

    def update(self, scale_table=None, force: bool = False) -> bool:
        """(Re)build codec tables from parameters (priors.py:77-96).

        Returns True if tables were (re)computed.
        """
        if self.tables and not force:
            return False
        tables = {}
        for name in self.bottleneck_names:
            eb = self.module.get_submodule(name)
            tables[name] = update_bottleneck_tables(eb.numpy_params())
        if self.has_gaussian:
            if scale_table is None:
                scale_table = get_scale_table()
            tables["gaussian_conditional"] = update_gaussian_tables(
                scale_table
            )
        self.set_tables(tables)
        return True

    def set_tables(self, tables: Dict[str, Any]) -> None:
        """Install codec tables (models/base.py::set_tables of the JAX
        package), with device copies of the constants every frame reads
        (an upload per frame would also sync the stream)."""
        self.tables = dict(tables)
        self._medians = torch.as_tensor(
            self.tables["entropy_bottleneck"].medians, dtype=torch.float32,
            device=self.device,
        ).view(1, -1, 1, 1)
        if "gaussian_conditional" in self.tables:
            self._scale_table = kernels.scale_table_tensor(
                self.tables["gaussian_conditional"].scale_table, self.device
            )

    def load_state_leaves(self, leaves) -> None:
        """Load the leaves of a JAX checkpoint's ``"model"`` entry, the JAX
        package's ``state_dict()`` ({"params", "tables"}), as its
        ``load_state_dict`` does: the parameters, then the codec tables that
        follow them in jax's order (tables by name, each table's fields by
        name), installed as they are. A checkpoint saved before
        ``update()`` has no tables; ``update()`` builds them then."""
        from ..convert import load_jax_leaves

        rest = load_jax_leaves(self.module, leaves)
        if not rest:
            self.tables = {}
            return
        names = list(self.bottleneck_names)
        if self.has_gaussian:
            names.append("gaussian_conditional")
        fields = {name: sorted(("cdf", "cdf_length", "offset",
                                "scale_table" if name == "gaussian_conditional"
                                else "medians")) for name in names}
        want = sum(len(f) for f in fields.values())
        if len(rest) != want:
            raise ValueError(f"{len(rest)} leaves after the parameters, "
                             f"expected {want} of the codec tables {names}")
        tables, it = {}, iter(rest)
        for name in sorted(names):
            tables[name] = CodecTables.fromdict(
                {f: next(it) for f in fields[name]})
        self.set_tables(tables)

    def state_tree(self):
        """The JAX package's ``state_dict()``: {"params": the parameters as
        its tree (``convert.jax_tree``), "tables": each codec table's
        fields}, what a checkpoint's ``"model"`` entry saves and
        ``load_state_leaves`` reads back."""
        from ..convert import jax_tree

        return {"params": jax_tree(self.module),
                "tables": {k: v.asdict() for k, v in self.tables.items()}}

    def _require_tables(self):
        if not self.tables:
            raise RuntimeError("Uninitialized CDFs. Run update() first")

    # ---- EB coding helpers (host NumPy, NHWC planes) -------------------------

    def _eb_compress(self, z, name="entropy_bottleneck"):
        return entropy_base.bottleneck_compress(np.asarray(z),
                                                self.tables[name], self.coder)

    def _eb_decompress(self, strings, spatial_shape,
                       name="entropy_bottleneck"):
        return entropy_base.bottleneck_decompress(
            strings, spatial_shape, self.tables[name], self.coder)

    def _eb_quantize(self, z, name="entropy_bottleneck"):
        """Encoder-side ẑ: decode(encode(z)) by construction, through the
        coder's own saturated symbols, so the encoder's priors are the
        decoder's."""
        med = self.tables[name].medians[None, None, None, :]
        symbols = entropy_base.safe_symbols(np.asarray(z), med)
        return (symbols + med).astype(np.float32)
