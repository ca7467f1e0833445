"""The image codec's served step: ``g_a``, ``g_s`` and ``y_hat``.

Per picture the plain reference (``reference_cheng2020.py``) computes y
from the picture, decodes the program's z stream with its own bottleneck
tables (each symbol a rounding of its z − median on the host's float64
path), then the program's y stream round by round with its own (σ, μ) and
CDF rows on what it decoded before.

- ``g_a``: max |y − y_ref| / max |y_ref| over the step's pictures.
- ``y_hat``: the largest of the program's ŷ's gap to the reference's
  decode and each decoded symbol's gap from a rounding of y_ref − μ (and
  each z symbol's from a rounding of z_ref − median), over max |μ_ref|.
- ``g_s``: max |x̂ − x̂_ref|, x̂_ref the reference's clamped g_s of the ŷ
  it decoded.
"""

import numpy as np
import torch

from portbench import judge as J
from portbench import reference_cheng2020 as RC

NAMES = ("g_a", "g_s", "y_hat")


@torch.no_grad()
def judge(ref, rec):
    x, y_strings, z_strings = rec["x"], *rec["strings"]
    b = x.shape[0]
    if len(y_strings) != b or len(z_strings) != b:
        return {"g_a": 1.0, "g_s": 1.0, "y_hat": 1.0}
    g_a = g_s = gap = 0.0
    mu_max = 1e-30
    for i in range(b):
        y = RC.g_a(ref.W, x[i:i + 1])
        g_a = max(g_a, J.rel(rec["y"][i:i + 1], y))
        z = RC.h_a(ref.W, y)[0].double().cpu().numpy()
        z = z - ref.zt.medians[:, None, None]
        zs = J.decode_z(ref, z_strings[i:i + 1], (1, *z.shape))[0]
        gap = max(gap, float(np.abs(z - zs).max()) - 0.5)
        y_hat, mu_i = RC.ar_decode(ref, y_strings[i], zs, x.device)
        mu_max = max(mu_max, mu_i)
        gap = max(gap, J.rounding_gap(y, y_hat),
                  float((rec["y_hat"][i:i + 1] - y_hat).abs().max()))
        g_s = max(g_s, float((rec["x_hat"][i:i + 1].float()
                              - RC.g_s(ref.W, y_hat)).abs().max()))
    return {"g_a": g_a, "y_hat": max(gap, 0.0) / mu_max, "g_s": g_s}


@torch.no_grad()
def control(ref, st, k, y_cond, p):
    """The reference in the program's place at precision ``p`` on the
    step's pictures at GOP position ``k``: the step's record with streams
    from the reference's own coder. A picture codec hands on no carry."""
    x = st.frames[k]
    ys, y_strings, z_strings, y_hats = [], [], [], []
    for i in range(x.shape[0]):
        y, _, ys_i, zs_i, y_hat = RC.encode(ref, x[i:i + 1], p)
        ys.append(y)
        y_strings.append(ys_i)
        z_strings.append(zs_i)
        y_hats.append(y_hat)
    y_hat = torch.cat(y_hats)
    return {"x": x, "y": torch.cat(ys), "strings": [y_strings, z_strings],
            "y_hat": y_hat, "x_hat": RC.g_s(ref.W, y_hat, p)}, y_cond
