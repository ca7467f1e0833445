"""Drop-in API shims matching the reference's ``compressai.ans`` module.

Counterpart of spatiotemporalentropymodel_tpu/coders/compat.py. For users
migrating from the reference: the same three classes with the same call
signatures (Python lists in, bytes out — rans_interface.cpp:352-372), over
the port's native coder (``coders.get_coder``). New code should use
``coders.get_coder`` / ``entropy.base`` directly (no list marshalling).
"""

from typing import List

import numpy as np

from . import get_coder


def _arrays(symbols, indexes, cdfs, cdfs_sizes, offsets):
    if len({len(c) for c in cdfs}) > 1:  # ragged python lists
        # (the JAX package's shim builds np.asarray(cdfs) first, which
        # NumPy 1.24 and later refuse for ragged rows)
        cdf_arr = np.zeros((len(cdfs), max(len(c) for c in cdfs)), np.int32)
        for i, c in enumerate(cdfs):
            cdf_arr[i, : len(c)] = c
    else:
        cdf_arr = np.asarray(cdfs, np.int32)
    return (
        np.asarray(symbols, np.int32),
        np.asarray(indexes, np.int32),
        cdf_arr,
        np.asarray(cdfs_sizes, np.int32),
        np.asarray(offsets, np.int32),
    )


class RansEncoder:
    """One-shot encoder (rans_interface.cpp:193-204)."""

    def encode_with_indexes(self, symbols, indexes, cdfs, cdfs_sizes,
                            offsets) -> bytes:
        s, i, c, ln, off = _arrays(symbols, indexes, cdfs, cdfs_sizes, offsets)
        return get_coder("rans").encode_with_indexes(s, i, c, ln, off)


class BufferedRansEncoder:
    """Accumulate symbol chunks, emit one stream on flush()
    (rans_interface.cpp:99-191).

    The reference records the CDF tables *per symbol*; callers may legally
    buffer chunks coded against different tables. Tables are kept per chunk
    here and merged into one row-stacked CDF matrix at flush time (indexes
    rebased onto each chunk's row block), which encodes identically.
    """

    def __init__(self):
        self._symbols: List[np.ndarray] = []
        self._indexes: List[np.ndarray] = []
        self._tables: List[tuple] = []

    def encode_with_indexes(self, symbols, indexes, cdfs, cdfs_sizes, offsets):
        s, i, c, ln, off = _arrays(symbols, indexes, cdfs, cdfs_sizes, offsets)
        self._symbols.append(s)
        self._indexes.append(i)
        self._tables.append((c, ln, off))

    def flush(self) -> bytes:
        if not self._tables:
            return b""
        first = self._tables[0]
        same = all(
            t[0] is first[0] or (
                t[0].shape == first[0].shape
                and np.array_equal(t[0], first[0])
                and np.array_equal(t[1], first[1])
                and np.array_equal(t[2], first[2])
            )
            for t in self._tables[1:]
        )
        if same:
            c, ln, off = first
            i = np.concatenate(self._indexes)
        else:  # merge: stack rows, rebase each chunk's indexes
            cols = max(t[0].shape[1] for t in self._tables)
            c_parts, ln_parts, off_parts, i_parts = [], [], [], []
            base = 0
            for (tc, tln, toff), ti in zip(self._tables, self._indexes):
                padded = np.zeros((tc.shape[0], cols), np.int32)
                padded[:, : tc.shape[1]] = tc
                c_parts.append(padded)
                ln_parts.append(tln)
                off_parts.append(toff)
                i_parts.append(ti + base)
                base += tc.shape[0]
            c = np.concatenate(c_parts)
            ln = np.concatenate(ln_parts)
            off = np.concatenate(off_parts)
            i = np.concatenate(i_parts)
        s = np.concatenate(self._symbols)
        self._symbols, self._indexes, self._tables = [], [], []
        return get_coder("rans").encode_with_indexes(s, i, c, ln, off)


class RansDecoder:
    """Stateless + stateful-stream decoder (rans_interface.cpp:206-350)."""

    def __init__(self):
        self._stream = None

    def decode_with_indexes(self, encoded: bytes, indexes, cdfs, cdfs_sizes,
                            offsets) -> List[int]:
        _, i, c, ln, off = _arrays([], indexes, cdfs, cdfs_sizes, offsets)
        out = get_coder("rans").decode_with_indexes(encoded, i, c, ln, off)
        return out.tolist()

    def set_stream(self, encoded: bytes):
        self._stream = get_coder("rans").make_stream_decoder(encoded)

    def decode_stream(self, indexes, cdfs, cdfs_sizes, offsets) -> List[int]:
        if self._stream is None:
            raise RuntimeError("call set_stream() first")
        _, i, c, ln, off = _arrays([], indexes, cdfs, cdfs_sizes, offsets)
        return self._stream.decode(i, c, ln, off).tolist()
