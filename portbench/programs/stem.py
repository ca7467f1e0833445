"""The STEM program: the port's ``MeanScaleHyperprior`` as the I-model
(its g_a and g_s) around a ``SpatioTemporalPriorModel`` P-frame codec.

A program module gives what the harness needs of the program a
configuration names (``"program"``):

- ``make(cfg, traffic, W, frames, device)``: the program's models by name
  (the harness casts them to the traffic's dtype and drops them once the
  window has closed) and the rest of the state its loops read;
- ``reference(W, cfg, net_dtype)``: what the judges and ``calibrate.py``
  receive, from the weights alone;
- ``transforms(cfg, hw)``: ``{"g_a": (layers, io_elems), "g_s": ...}`` of
  one h×w picture, as ``peaks.transform_bound_s`` takes them;
- ``picture_ops(cfg, hw, served)``: the whole step's model operations per
  picture;
- ``check(cfg, loop)``: refuses what the configuration asks that the loop
  does not do.

Here the models are ``i_model`` and ``stem``, the state ``y_i``, the
I-frame latent round(g_a(first frame)) of the plain reference.
"""

import torch

from portbench import peaks
from portbench import reference as R

STEM_NETS = ("HE.", "HD.", "TPM.", "EPM.", "context_prediction.")


def make(cfg, traffic, W, frames, device):
    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior, SpatioTemporalPriorModel,
    )

    with torch.no_grad():
        y_i = torch.round(R.g_a(W.I, frames[0])).contiguous()
    i_model = MeanScaleHyperprior(cfg["N"], cfg["M"], device=device)
    i_model.module.load_state_dict(W.I, strict=True)
    tile = cfg.get("wavefront_tile")
    stem = SpatioTemporalPriorModel(
        variant=cfg["variant"],
        entropy_bottleneck_channels=cfg["entropy_bottleneck_channels"],
        in_channels=cfg["M"], wavefront_tile=tuple(tile) if tile else None,
        device=device)
    stem.module.load_state_dict(W.S, strict=True)
    stem.update(force=True)
    return {"i_model": i_model, "stem": stem}, {"y_i": y_i}


def check(cfg, loop):
    if cfg["variant"] not in loop.VARIANTS:
        raise SystemExit(f"{cfg['name']}: the loop drives the "
                         f"{', '.join(loop.VARIANTS)} STEM, and does not "
                         f"drive the {cfg['variant']!r} STEM")


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


def reference(W, cfg, net_dtype=torch.float32):
    return Ref(W.I, W.S, cfg, net_dtype)


# ---- work ---------------------------------------------------------------


def g_a_layers(n, m, h, w):
    """(conv operations, [(pixels, C) of each GDN], weights) of g_a on one
    h×w picture."""
    ops, norms, weights = 0, [], 0
    chans = [3, n, n, n, m]
    for j in range(4):
        h, w = (h + 1) // 2, (w + 1) // 2
        ops += peaks.conv(chans[j], chans[j + 1], 5, h, w)
        weights += 25 * chans[j] * chans[j + 1] + chans[j + 1]
        if j < 3:
            norms.append((h * w, n))
            weights += n * n + n
    return ops, norms, weights


def g_s_layers(n, m, h, w):
    """The same of g_s from an h×w latent."""
    ops, norms, weights = 0, [], 0
    chans = [m, n, n, n, 3]
    for j in range(4):
        ops += peaks.deconv(chans[j], chans[j + 1], 5, h, w)
        weights += 25 * chans[j] * chans[j + 1] + chans[j + 1]
        h, w = 2 * h, 2 * w
        if j < 3:
            norms.append((h * w, n))
            weights += n * n + n
    return ops, norms, weights


def transforms(cfg, hw):
    """g_a's and g_s's layers on one picture, each with the elements of its
    input and output (the frame and the latent)."""
    n, m = cfg["N"], cfg["M"]
    h, w = hw
    io = 3 * h * w + m * (h // 16) * (w // 16)
    return {"g_a": (g_a_layers(n, m, h, w), io),
            "g_s": (g_s_layers(n, m, h // 16, w // 16), io)}


def stem_ops(cfg, h, w, served: bool):
    """Model operations of the STEM on one h×w latent: HE, then the priors
    (TPM, HD) and EPM, once for the encoder and once more for the decoder
    where the picture is served; on the spatial-prior path EPM runs on rows
    with the masked context's 12 causal taps."""
    conv, deconv = peaks.conv, peaks.deconv
    m, ebc = cfg["in_channels"], cfg["entropy_bottleneck_channels"]
    spm = cfg["variant"] == "res"
    h2, w2, h4, w4 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4
    he = (conv(2 * m, 256, 3, h, w) + conv(256, 256, 5, h2, w2)
          + conv(256, ebc, 5, h4, w4))
    hd = (deconv(ebc, 256, 5, h4, w4) + deconv(256, 256, 5, h2, w2)
          + conv(256, 2 * m, 3, h, w))
    tpm = (conv(m, 256, 5, h, w) + conv(256, 320, 5, h, w)
           + conv(320, 2 * m, 5, h, w))
    epm_in = 2 * m * (3 if spm else 2)
    epm = (conv(epm_in, 768, 1, h, w) + conv(768, 576, 1, h, w)
           + conv(576, 2 * m, 1, h, w))
    ctx = 2 * 12 * m * 2 * m * h * w if spm else 0
    per_side = tpm + hd + epm + ctx
    return he + per_side * (2 if served else 1)


def picture_ops(cfg, hw, served: bool):
    """Model operations per picture: g_a, the STEM and g_s."""
    t = transforms(cfg, hw)
    return (peaks.transform_ops(t["g_a"][0])
            + stem_ops(cfg, hw[0] // 16, hw[1] // 16, served)
            + peaks.transform_ops(t["g_s"][0]))
