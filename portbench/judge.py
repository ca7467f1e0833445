"""What decides ``correct``: the program's outputs held against the plain
reference, once the window has closed. The shared part: the reference's
weights and tables (``Ref``), helpers, and the verdict; each traffic's
judge (``judges/<name>.py``) recomputes its own steps.

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
import torch

from . import rans
from . import reference as R

STEM_NETS = ("HE.", "HD.", "TPM.", "EPM.", "context_prediction.")


class Ref:
    """The reference's weights (f32 dicts on the run's device) and tables.
    ``net_dtype``: the dtype the STEM's nets are served in. Where it is not
    f32 the serving judge runs those nets in it, on inputs cast to it, so
    that (σ, μ), and with them the CDF rows a stream is coded in, are the
    ones a faithful implementation of that precision gets."""

    def __init__(self, I, S, config, net_dtype=torch.float32):
        self.I, self.S, self.cfg = I, S, config
        self.net_dtype = net_dtype
        self.S_net = S if net_dtype == torch.float32 else {
            k: (v.to(net_dtype) if k.startswith(STEM_NETS) else v)
            for k, v in S.items()}
        self.med32 = S["entropy_bottleneck.quantiles"][:, 0, 1].float().view(
            1, -1, 1, 1)
        pre = "entropy_bottleneck."
        self.eb_params = {k[len(pre):]: v.float() for k, v in S.items()
                          if k.startswith(pre)}
        self.zt = R.eb_tables({k: v.cpu().numpy()
                               for k, v in self.eb_params.items()})
        self.gt = R.gaussian_tables()
        self.table = torch.as_tensor(self.gt.scales, dtype=torch.float32,
                                     device=self.med32.device)
        self.levels = len(self.gt.scales)


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
