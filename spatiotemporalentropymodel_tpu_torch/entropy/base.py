"""Host-side batch compress/decompress over codec tables.

The port's copy of spatiotemporalentropymodel_tpu/entropy/base.py (NumPy
only): EntropyModel.compress/decompress (entropy_models.py:201-279) over
batched int32 planes in NHWC order, the native rANS coder per batch element.
"""

from typing import List, Sequence

import numpy as np

from ..coders import get_coder
from .tables import CodecTables

# Symbols saturate to an int32-safe band before coding. The reference casts
# round(x−μ) straight to int32 (entropy_models.py:148-150) and silently
# corrupts the stream when an untrained/diverged model emits |values| ≥ 2³¹;
# here both encoder and decoder see the same saturated integer, so the codec
# stays self-consistent under any input.
SYMBOL_MAX = 1 << 30


def safe_symbols(values, means=None) -> np.ndarray:
    """round(values − means) → NaN-cleared, saturated int32 symbols."""
    v = np.asarray(values, np.float64)
    if means is not None:
        v = v - np.asarray(means, np.float64)
    v = np.nan_to_num(np.round(v), nan=0.0, posinf=SYMBOL_MAX, neginf=-SYMBOL_MAX)
    return np.clip(v, -SYMBOL_MAX, SYMBOL_MAX).astype(np.int32)


def _flatten(plane: np.ndarray, order: str) -> np.ndarray:
    """Flatten one batch element to the wire symbol order.

    ``"chw"`` reproduces the reference's flattening — NCHW tensors reshaped
    row-major (entropy_models.py:210-221) — so bitstreams are byte-identical
    with (and decodable by) upstream compressai. ``"hwc"`` flattens the NHWC
    plane directly (no transpose copy; the fast-path option).
    """
    if order == "chw" and plane.ndim >= 2:
        plane = np.moveaxis(plane, -1, 0)
    return np.ascontiguousarray(plane).reshape(-1)


def get_enc_table(tables: CodecTables, coder) -> np.ndarray:
    """Cached reciprocal encoder-symbol table (native coder): replaces the
    per-symbol integer division with a multiply while emitting byte-identical
    streams (rans.cpp::enc_put_sym). Cached on the tables instance like the
    decode LUT (see get_lut for the id()-reuse rationale)."""
    esym = getattr(tables, "_esym", None)
    if esym is None:
        esym = coder.build_enc_table(tables.cdf, tables.cdf_length)
        object.__setattr__(tables, "_esym", esym)
    return esym


def compress(
    symbols,
    indexes,
    tables: CodecTables,
    coder=None,
    order: str = "chw",
) -> List[bytes]:
    """Encode per-batch-element bitstreams.

    symbols: int array (B, ...); indexes: same shape, CDF-row per element.
    """
    coder = coder or get_coder()
    symbols = np.asarray(symbols, np.int32)
    indexes = np.asarray(indexes, np.int32)
    if symbols.shape != indexes.shape:
        raise ValueError("`symbols` and `indexes` must have the same shape")
    esym = get_enc_table(tables, coder)
    return [
        coder.encode_with_indexes(
            _flatten(symbols[i], order),
            _flatten(indexes[i], order),
            tables.cdf,
            tables.cdf_length,
            tables.offset,
            esym,
        )
        for i in range(symbols.shape[0])
    ]


def get_lut(tables: CodecTables, coder):
    """Cached direct symbol-lookup table for O(1) decode (native coder).

    The LUT is cached ON the tables instance (object lifetime == cache
    lifetime). Never key such a cache by id(): after the old tables are
    garbage-collected a new array can reuse the same id and silently decode
    with a stale LUT.
    """
    lut = getattr(tables, "_lut", None)
    if lut is None:
        lut = coder.build_lut(tables.cdf, tables.cdf_length)
        object.__setattr__(tables, "_lut", lut)  # frozen dataclass, private cache
    return lut


def decompress(
    strings: Sequence[bytes],
    indexes,
    tables: CodecTables,
    coder=None,
    order: str = "chw",
) -> np.ndarray:
    """Decode bitstreams back to int32 symbols with `indexes`'s shape."""
    coder = coder or get_coder()
    indexes = np.asarray(indexes, np.int32)
    if len(strings) != indexes.shape[0]:
        raise ValueError("one string per batch element required")
    lut = get_lut(tables, coder)
    out = np.empty(indexes.shape, np.int32)
    plane_shape = indexes.shape[1:]
    transpose = order == "chw" and len(plane_shape) >= 2
    if transpose:
        plane_shape = (plane_shape[-1],) + plane_shape[:-1]
    for i, s in enumerate(strings):
        plane = coder.decode_with_indexes(
            s,
            _flatten(indexes[i], order),
            tables.cdf,
            tables.cdf_length,
            tables.offset,
            lut=lut,
        ).reshape(plane_shape)
        out[i] = np.moveaxis(plane, 0, -1) if transpose else plane
    return out


def unpack_symbol_buffer(packed, y_shape, z_shape):
    """Split a fused-encoder byte buffer [y int16][z int16][idx u8] into
    (y_sym int16, z_sym int16, idx int32) planes (zero-copy views + one cast)."""
    packed = np.asarray(packed)
    ny = int(np.prod(y_shape))
    nz = int(np.prod(z_shape))
    y_sym = packed[: 2 * ny].view(np.int16).reshape(y_shape)
    z_sym = packed[2 * ny : 2 * (ny + nz)].view(np.int16).reshape(z_shape)
    idx = packed[2 * (ny + nz) :].reshape(y_shape).astype(np.int32)
    return y_sym, z_sym, idx


def bottleneck_indexes(shape, channels: int) -> np.ndarray:
    """Channel-broadcast CDF indexes for EntropyBottleneck coding
    (entropy_models.py:454-459), NHWC: shape = (B, H, W, C)."""
    b, h, w, c = shape
    assert c == channels, (c, channels)
    return np.broadcast_to(
        np.arange(c, dtype=np.int32)[None, None, None, :], (b, h, w, c)
    )
