"""Host side of the sparse-grouped symbol transport.

The port's copy of spatiotemporalentropymodel_tpu/entropy/transport.py, for
the native coder only. Counterpart of ``models/stem.py::fused_encode_sparse_expr`` /
``fused_params_sparse_expr`` / ``fused_reconstruct_sparse_expr``: unpack the
device's packed transport buffer, run the rANS coder in grouped-by-CDF-row
order (per-symbol row ids rebuilt from the 64 counts — no index plane ever
crosses the link), and pack decoded symbols back into (bitmask + compacted
int8 values) for upload.

Replaces the reference's per-tensor ``.tolist()`` boundary
(entropy_models.py:201-233) with, per 1080p frame: ~0.5 MB down on encode and
~0.5 MB up on decode (zero fetches — the container carries the row counts),
vs ~10 MB dense.
"""

import struct
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..coders import get_coder
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
    """Byte offsets of ``fused_encode_sparse_expr``'s buffer."""

    b: int
    n: int  # y symbols per batch element
    zn: int  # z symbols per batch element
    levels: int

    @property
    def cap(self) -> int:
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

    if meta[:, 1].any():  # int8/capacity overflow → caller re-encodes dense
        return SparseEncodePlanes(
            y_sorted=np.zeros((b, n), np.int32),
            counts=counts,
            z_sym=z_sym.astype(np.int32),
            overflow=True,
        )

    coder = get_coder()
    y_sorted = np.stack([
        coder.expand_sparse(maskbits[i], values[i], n) for i in range(b)
    ])
    return SparseEncodePlanes(
        y_sorted=y_sorted,
        counts=counts,
        z_sym=z_sym.astype(np.int32),
        overflow=False,
    )


def encode_grouped(
    y_sorted: np.ndarray,
    counts: np.ndarray,
    tables: CodecTables,
    coder=None,
) -> List[bytes]:
    """rANS-encode grouped-order symbols (one stream per batch element) in
    the run-based container: per-symbol rows derived from `counts` on both
    sides — no index plane, row constants hoisted, reciprocal-multiply
    division."""
    coder = coder or get_coder()
    y_sorted = np.ascontiguousarray(y_sorted, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    esym = entropy_base.get_enc_table(tables, coder)
    return [
        coder.encode_runs(
            y_sorted[i], counts[i], tables.cdf, tables.cdf_length,
            tables.offset, esym,
        )
        for i in range(y_sorted.shape[0])
    ]


def decode_grouped(
    strings: Sequence[bytes],
    counts: np.ndarray,
    tables: CodecTables,
    coder=None,
) -> np.ndarray:
    """Decode grouped-order streams → (b, n) int32 sorted symbols."""
    coder = coder or get_coder()
    counts = np.ascontiguousarray(counts, np.int32)
    lut = entropy_base.get_lut(tables, coder)
    n = int(counts[0].sum())
    return np.stack([
        coder.decode_runs(
            s, counts[i], n, tables.cdf, tables.cdf_length, tables.offset, lut,
        )
        for i, s in enumerate(strings)
    ])


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
    None when a values plane overflows `cap` (caller falls back to
    decode_grouped + pack_decode_payload)."""
    coder = coder or get_coder()
    counts = np.ascontiguousarray(counts, np.int32)
    lut = entropy_base.get_lut(tables, coder)
    n = int(counts[0].sum())
    maskbits = np.empty((len(strings), (n + 7) // 8), np.uint8)
    values = np.empty((len(strings), cap), np.int8)
    for i, s in enumerate(strings):
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
