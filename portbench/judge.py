"""What decides ``correct``: the program's outputs held against the plain
reference, once the window has closed. The shared part: helpers and the
verdict; the configuration's program gives the reference the judges
receive (``programs/<name>.py::reference``), and each traffic's judge
(``judges/<name>.py``) recomputes its own steps.

A record is what one sampled step of the window produced, with the inputs
it was given. A judge recomputes that step from the same inputs and the
same weights (never from anything the program made but the outputs it
judges), decodes the program's bitstreams with the reference's own
tables, and reads numbers such as:

- ``g_a``: max |y − y_ref| / max |y_ref|, the analysis transform's latent.
- ``g_s``: max |x̂ − x̂_ref| (x̂ in [0, 1]), x̂_ref the reference's
  synthesis of the program's ŷ (which ``y_hat`` holds to the reference).
- ``y_hat``: the STEM codec's ŷ and symbols against the reference's.
- ``bpp``: the largest relative gap of the estimated bits per pixel.

Where a number needs the program's state to go on (the carry a step
starts from, the latent its STEM codes), the judge takes it from the
record and checks the stage that produced it by itself: g_a on the frame,
the carry against the reference's ŷ of the step before it.
"""

import numpy as np

from . import rans


def rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def decode_z(ref, strings, shape):
    """ẑ's symbols (b, C, h, w) decoded from the program's z streams with
    the reference's bottleneck tables."""
    b, c, h, w = shape
    rows = np.repeat(np.arange(c), h * w)
    return np.stack([rans.Decoder(s, ref.zt).decode(rows).reshape(c, h, w)
                     for s in strings])


def rounding_gap(value, rounded):
    """How far ``rounded`` is from being a rounding of ``value``: 0 for any
    rounding to a nearest integer, ties and last-bit cases included."""
    return max(0.0, float((value - rounded).abs().max()) - 0.5)


def verdict(readings, limits):
    """(correct, the worst reading of each number): every reading at or
    under its limit."""
    worst = {}
    for r in readings:
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v)
    ok = bool(readings) and all(
        np.isfinite(worst.get(k, np.inf)) and worst[k] <= lim
        for k, lim in limits.items())
    return ok, worst
