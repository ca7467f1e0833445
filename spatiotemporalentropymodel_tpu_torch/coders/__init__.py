"""Entropy coders: the native C++ rANS, its interleaved container, and a
pure NumPy coder.

Counterpart of spatiotemporalentropymodel_tpu/coders/__init__.py.
``get_coder(name)`` returns an object with the uniform array API:

  encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets) -> bytes
  decode_with_indexes(data, indexes, cdfs, cdf_lengths, offsets) -> int32[n]
  encode_stream(symbols, indexes, ...) -> bytes   the plain-stream format
  make_stream_decoder(data) -> a stream decoder (autoregressive decode)

and the capability flags ``supports_lut``, ``supports_runs`` and
``supports_stream_runs`` that the transport (entropy/transport.py) and the
AR codecs (models/ar_wavefront.py) branch on. The coders:

  "rans"              the ``rans`` module itself: native, single stream,
                      bitstream-compatible with the reference's
                      ``compressai.ans``
  "rans_interleaved"  native, an 8-lane container (lanes decode in
                      parallel); its own format, not the reference's
  "numpy"             the executable spec (``_numpy_rans``): slow, no
                      acceleration tables, no run-based container

A failed build of the native coder raises; unlike the JAX package, neither
native name ever gives way to the NumPy coder.
"""

import numpy as np

from . import _numpy_rans, rans
from .rans import make_stream_decoder


class NumpyCoder:
    name = "numpy"
    supports_lut = False
    supports_runs = False
    supports_stream_runs = False

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_lengths,
                            offsets):
        return _numpy_rans.encode_with_indexes(
            np.asarray(symbols, dtype=np.int32).reshape(-1),
            np.asarray(indexes, dtype=np.int32).reshape(-1),
            np.asarray(cdfs, dtype=np.int32),
            np.asarray(cdf_lengths, dtype=np.int32),
            np.asarray(offsets, dtype=np.int32),
        )

    def decode_with_indexes(self, data, indexes, cdfs, cdf_lengths, offsets,
                            lut=None):
        del lut  # the spec searches the CDF row
        return _numpy_rans.decode_with_indexes(
            data,
            np.asarray(indexes, dtype=np.int32).reshape(-1),
            np.asarray(cdfs, dtype=np.int32),
            np.asarray(cdf_lengths, dtype=np.int32),
            np.asarray(offsets, dtype=np.int32),
        )

    def encode_stream(self, symbols, indexes, cdfs, cdf_lengths, offsets,
                      esym=None):
        del esym  # the spec has no acceleration tables
        return self.encode_with_indexes(symbols, indexes, cdfs, cdf_lengths,
                                        offsets)

    def make_stream_decoder(self, data):
        return _NumpyStream(data)


class _NumpyStream:
    def __init__(self, data):
        self._dec = _numpy_rans.StreamDecoder(data)

    def decode(self, indexes, cdfs, cdf_lengths, offsets, lut=None):
        del lut  # the spec searches the CDF row
        return self._dec.decode(
            np.asarray(indexes, dtype=np.int32).reshape(-1),
            np.asarray(cdfs, dtype=np.int32),
            np.asarray(cdf_lengths, dtype=np.int32),
            np.asarray(offsets, dtype=np.int32),
        )


class InterleavedCoder:
    """The native coder with ``n_lanes`` lanes: the interleaved container
    for indexed coding and the chunked-lane container for runs; the plain
    stream, its decoder and the tables are the single-stream coder's."""

    name = "rans_interleaved"
    supports_lut = True
    supports_runs = True
    supports_stream_runs = True

    def __init__(self, n_lanes: int = 8):
        rans.load()
        self.n_lanes = int(n_lanes)

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_lengths,
                            offsets, esym=None):
        return rans.encode_interleaved(symbols, indexes, cdfs, cdf_lengths,
                                       offsets, self.n_lanes, esym)

    def decode_with_indexes(self, data, indexes, cdfs, cdf_lengths, offsets,
                            lut=None):
        return rans.decode_interleaved(data, indexes, cdfs, cdf_lengths,
                                       offsets, lut)

    def encode_runs(self, symbols, counts, cdfs, cdf_lengths, offsets,
                    esym=None):
        return rans.encode_runs(symbols, counts, cdfs, cdf_lengths, offsets,
                                esym, n_lanes=self.n_lanes)

    build_enc_table = staticmethod(rans.build_enc_table)
    build_lut = staticmethod(rans.build_lut)
    encode_stream = staticmethod(rans.encode_stream)
    encode_runs_segmented = staticmethod(rans.encode_runs_segmented)
    decode_runs = staticmethod(rans.decode_runs)
    decode_runs_packed = staticmethod(rans.decode_runs_packed)
    expand_sparse = staticmethod(rans.expand_sparse)
    make_stream_decoder = staticmethod(rans.make_stream_decoder)


_cache = {}


def get_coder(name=None):
    """The coder called ``name`` (default: the package's
    ``get_entropy_coder()``), built and loaded on first use."""
    if name is None:
        from .. import get_entropy_coder

        name = get_entropy_coder()
    if name not in _cache:
        if name == "numpy":
            _cache[name] = NumpyCoder()
        elif name == "rans":
            rans.load()
            _cache[name] = rans
        elif name == "rans_interleaved":
            _cache[name] = InterleavedCoder()
        else:
            raise ValueError(f"unknown entropy coder: {name!r}")
    return _cache[name]


__all__ = ["get_coder", "make_stream_decoder", "rans", "NumpyCoder",
           "InterleavedCoder"]
