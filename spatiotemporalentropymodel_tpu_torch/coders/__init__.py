"""Entropy coder of the serving path: the native C++ single-stream rANS.

``get_coder()`` returns the one coder the f32 P-frame path uses (the JAX
package's default ``"rans"``): the ``rans`` module itself, built and loaded
on first use. Building it raises on failure; unlike the JAX package there is
no silent drop to a NumPy coder. ``make_stream_decoder`` opens a stream for
the autoregressive codecs' per-round decode.
"""

from . import rans
from .rans import make_stream_decoder


def get_coder(name=None):
    """The native rANS coder module (built and loaded on first use)."""
    if name not in (None, "rans"):
        raise ValueError(f"unknown entropy coder: {name!r} (the port has "
                         f"'rans' only)")
    rans.load()
    return rans
