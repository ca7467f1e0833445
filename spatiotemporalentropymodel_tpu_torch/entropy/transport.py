"""Host side of the sparse-grouped symbol transport.

The port's copy of spatiotemporalentropymodel_tpu/entropy/transport.py.
Counterpart of ``models/stem.py::fused_encode_sparse_carry_expr`` /
``fused_params_sparse_expr`` / ``fused_reconstruct_sparse_expr`` and of
charm's per-group transport (models/charm.py): unpack the device's packed
transport buffer, run the rANS coder in grouped-by-CDF-row order (per-symbol
row ids rebuilt from the counts — no index plane ever crosses the link), and
pack decoded symbols back into (bitmask + compacted int8 values) for upload.
The native coders use their run-based container; a coder without one (the
NumPy coder, ``supports_runs`` false) codes the same order through the
indexed path, its rows from ``rows_from_counts``.

Replaces the reference's per-tensor ``.tolist()`` boundary
(entropy_models.py:201-233) with, per 1080p frame: ~0.5 MB down on encode and
~0.5 MB up on decode (zero fetches — the container carries the row counts),
vs ~10 MB dense.

Spans (utils/trace.py): ``transport.unpack`` and ``transport.pack`` around
the buffer work, and one ``rans.y.encode``/``rans.y.decode`` per coded
stream.
"""

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..coders import get_coder
from ..utils import trace
from . import base as entropy_base
from .tables import CodecTables


def sparse_capacity(n: int) -> int:
    """Values-plane capacity for n symbols — THE single definition both the
    device encode expression (models/stem.py::_sparse_capacity) and the host
    unpack (SparseLayout.cap) must agree on. Converged models run ~5-8%
    nonzeros at the published 0.08-0.16 bpp, so n/8 leaves ~2× headroom
    (overflow falls back to the dense transport); small planes get a floor
    since their byte cost is negligible and their nonzero fraction noisier."""
    return min(n, max(n // 8, 64))


@dataclass(frozen=True)
class SparseLayout:
    """Byte offsets of a sparse encode expression's buffer."""

    b: int
    n: int  # y symbols per batch element
    zn: int  # z symbols per batch element
    levels: int
    # explicit values-plane capacity for layouts whose encoder uses another
    # formula (charm packs n // 4); default sparse_capacity(n)
    cap_value: Optional[int] = None

    @property
    def cap(self) -> int:
        if self.cap_value is not None:
            return self.cap_value
        return sparse_capacity(self.n)

    @property
    def sizes(self):
        b = self.b
        return (
            b * self.n // 8,       # bitmask
            b * self.cap,          # values i8
            b * self.levels * 4,   # counts i32
            b * self.zn,           # z i8
            b * 2 * 4,             # meta i32 (nz, overflow)
        )

    @property
    def total(self) -> int:
        return sum(self.sizes)


@dataclass
class SparseEncodePlanes:
    y_sorted: np.ndarray   # (b, n) int32, grouped-by-row order
    counts: np.ndarray     # (b, levels) int32
    z_sym: np.ndarray      # (b, zn) int32 (flat)
    overflow: bool


def unpack_encode(buf, layout: SparseLayout) -> SparseEncodePlanes:
    with trace.span("transport.unpack"):
        buf = np.asarray(buf, np.uint8)
        if buf.size != layout.total:
            raise ValueError(
                f"transport buffer size {buf.size} != layout {layout.total}"
            )
        s = layout.sizes
        off = np.cumsum((0,) + s)
        b, n, cap = layout.b, layout.n, layout.cap

        maskbits = buf[off[0]:off[1]].reshape(b, n // 8)
        values = buf[off[1]:off[2]].view(np.int8).reshape(b, cap)
        counts = buf[off[2]:off[3]].view(np.int32).reshape(b, layout.levels)
        z_sym = buf[off[3]:off[4]].view(np.int8).reshape(b, layout.zn)
        meta = buf[off[4]:off[5]].view(np.int32).reshape(b, 2)

        if meta[:, 1].any():  # int8/capacity overflow → re-encoded dense
            return SparseEncodePlanes(
                y_sorted=np.zeros((b, n), np.int32),
                counts=counts,
                z_sym=z_sym.astype(np.int32),
                overflow=True,
            )

        coder = get_coder()
        if coder.supports_runs:
            y_sorted = np.stack([
                coder.expand_sparse(maskbits[i], values[i], n)
                for i in range(b)
            ])
        else:
            mask = np.unpackbits(maskbits, axis=-1, bitorder="little").astype(
                bool)
            y_sorted = np.zeros((b, n), np.int32)
            for i in range(b):
                y_sorted[i, mask[i]] = values[i, :int(meta[i, 0])]
        return SparseEncodePlanes(
            y_sorted=y_sorted,
            counts=counts,
            z_sym=z_sym.astype(np.int32),
            overflow=False,
        )


def rows_from_counts(counts: np.ndarray) -> np.ndarray:
    """(b, levels) counts → (b, n) per-symbol CDF-row ids in grouped order."""
    return np.stack([
        np.repeat(np.arange(counts.shape[1], dtype=np.int32), counts[i])
        for i in range(counts.shape[0])
    ])


def encode_grouped(
    y_sorted: np.ndarray,
    counts: np.ndarray,
    tables: CodecTables,
    coder=None,
) -> List[bytes]:
    """rANS-encode grouped-order symbols (one stream per batch element).

    Native coders use the run-based container (per-symbol rows derived from
    `counts` on both sides — no index plane, row constants hoisted,
    reciprocal-multiply division); others the indexed path."""
    coder = coder or get_coder()
    if not coder.supports_runs:
        return entropy_base.compress(
            y_sorted, rows_from_counts(counts), tables, coder, order="hwc")
    y_sorted = np.ascontiguousarray(y_sorted, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    esym = entropy_base.get_enc_table(tables, coder)
    out = []
    for i in range(y_sorted.shape[0]):
        with trace.span("rans.y.encode"):
            out.append(coder.encode_runs(
                y_sorted[i], counts[i], tables.cdf, tables.cdf_length,
                tables.offset, esym,
            ))
    return out


def decode_grouped(
    strings: Sequence[bytes],
    counts: np.ndarray,
    tables: CodecTables,
    coder=None,
) -> np.ndarray:
    """Decode grouped-order streams → (b, n) int32 sorted symbols."""
    coder = coder or get_coder()
    counts = np.ascontiguousarray(counts, np.int32)
    if not coder.supports_runs:
        return entropy_base.decompress(
            strings, rows_from_counts(counts), tables, coder, order="hwc")
    lut = entropy_base.get_lut(tables, coder)
    n = int(counts[0].sum())
    out = []
    for i, s in enumerate(strings):
        with trace.span("rans.y.decode"):
            out.append(coder.decode_runs(
                s, counts[i], n, tables.cdf, tables.cdf_length,
                tables.offset, lut,
            ))
    return np.stack(out)


def decode_grouped_packed(
    strings: Sequence[bytes],
    counts: np.ndarray,
    cap: int,
    tables: CodecTables,
    coder=None,
):
    """Decode grouped streams STRAIGHT into the decode-payload format:
    (maskbits u8 (b, n/8), values i8 (b, cap)) — the rANS decoder emits the
    bitmask and compacted nonzeros as it goes, so the dense (b, n) int32
    plane never materializes and pack_decode_payload disappears. Returns
    None when the coder lacks the run-based path or a values plane
    overflows `cap` (caller falls back to decode_grouped +
    pack_decode_payload)."""
    coder = coder or get_coder()
    if not coder.supports_runs:
        return None
    counts = np.ascontiguousarray(counts, np.int32)
    lut = entropy_base.get_lut(tables, coder)
    n = int(counts[0].sum())
    maskbits = np.empty((len(strings), (n + 7) // 8), np.uint8)
    values = np.empty((len(strings), cap), np.int8)
    for i, s in enumerate(strings):
        with trace.span("rans.y.decode"):
            res = coder.decode_runs_packed(
                s, counts[i], n, cap, tables.cdf, tables.cdf_length,
                tables.offset, lut,
            )
        if res is None:
            return None
        maskbits[i], values[i] = res[0], res[1]
    return maskbits, values


def pack_decode_payload(y_sorted: np.ndarray, cap: int):
    """(b, n) decoded symbols → (maskbits u8 (b, n/8), values i8 (b, cap))
    for upload; symbols must fit int8 (they do — the encoder clamped)."""
    with trace.span("transport.pack"):
        b, n = y_sorted.shape
        mask = y_sorted != 0
        maskbits = np.packbits(mask, axis=-1, bitorder="little")
        values = np.zeros((b, cap), np.int8)
        for i in range(b):
            nzv = y_sorted[i, mask[i]]
            values[i, : nzv.size] = nzv.astype(np.int8)
        return maskbits, values


def pack_counts(counts) -> bytes:
    """Compact wire form of CDF-row count vectors (container side-info).

    A trained model touches ~20-30 of the 64 scale-table rows, so raw
    ``levels × u32`` (the .stemv v3 layout) ships mostly zeros — 1 KB/frame
    for charm G=4, which at a 256×256 eval frame is a 0.125 bpp toll. Wire
    format, big-endian: u8 n_vec, u8 levels, then per vector a u8 used-row
    count followed by (u8 row_id, LEB128 count) pairs. Typical cost is
    ~2-4 bytes per *used* row (~4x smaller than raw).

    ``counts``: (..., levels) int array; leading axes are flattened.
    """
    a = np.asarray(counts, np.int64)
    levels = a.shape[-1]
    vecs = a.reshape(-1, levels)
    if len(vecs) > 255 or levels > 255:
        raise ValueError(f"pack_counts supports <=255 vectors/levels, got "
                         f"{vecs.shape}")
    out = bytearray(struct.pack(">2B", len(vecs), levels))
    for v in vecs:
        (used,) = np.nonzero(v)
        out += struct.pack(">B", used.size)
        for r in used:
            out += struct.pack(">B", int(r))
            c = int(v[r])
            while True:
                b7, c = c & 0x7F, c >> 7
                out.append(b7 | (0x80 if c else 0))
                if not c:
                    break
    return bytes(out)


def unpack_counts(f) -> np.ndarray:
    """Inverse of :func:`pack_counts`; reads from a binary file object and
    returns (n_vec, levels) int32."""
    n_vec, levels = struct.unpack(">2B", f.read(2))
    out = np.zeros((n_vec, levels), np.int32)
    for i in range(n_vec):
        (used,) = struct.unpack(">B", f.read(1))
        for _ in range(used):
            (r,) = struct.unpack(">B", f.read(1))
            c = shift = 0
            while True:
                (b7,) = f.read(1)
                c |= (b7 & 0x7F) << shift
                shift += 7
                if not b7 & 0x80:
                    break
            out[i, r] = c
    return out
