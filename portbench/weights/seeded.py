"""Seeded weights: every parameter drawn on the device from the seed
(``workload.draw``), then the benchmark's copy of the program's surgery
(``workload.realistic_stem``), so that they code like a converged model.

The configuration's ``latent`` says what the served latent is:
``analysis``, g_a of the frame, with g_a's last conv rescaled so that its
latent has the statistics of this STEM's prior
(``workload.match_latent_to_prior``); or ``carry_noise``, the carry plus
``latent_noise`` · N(0, 1), one draw per GOP position (``noise``)."""

from types import SimpleNamespace

import numpy as np
import torch

from portbench import workload as WL


def make(cfg, frames, seed, gen, device):
    n, m = cfg["N"], cfg["M"]
    I = WL.draw(WL.i_model_specs(n, m), gen, device)
    S = WL.draw(WL.stem_specs(cfg["variant"],
                              cfg["entropy_bottleneck_channels"], m),
                gen, device)
    WL.realistic_stem(S, np.random.default_rng(seed))
    gop, b, _, h, w = frames.shape
    lat = (b, m, h // 16, w // 16)
    noise = None
    if cfg["latent"] == "analysis":
        y0 = 0.5 * torch.randn(lat, generator=gen, device=device)
        WL.match_latent_to_prior(I, S, frames[0], y0)
    elif cfg["latent"] == "carry_noise":
        noise = cfg["latent_noise"] * torch.randn(
            (gop, *lat), generator=gen, device=device)
    else:
        raise SystemExit(f"unknown latent {cfg['latent']!r}")
    return SimpleNamespace(I=I, S=S, noise=noise)
