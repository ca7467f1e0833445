"""The Cheng2020 program: the port's ``Cheng2020Attention`` image codec
through its model API, ``compress`` and ``decompress`` in wavefront mode.

The models are ``codec`` (the weights loaded, the tables built by
``update(force=True)``); the state is ``y_i``, None: ``calibrate.py`` hands
a judge's control the carry of a video program, and a picture codec has
none. ``arch`` names the model class; another joint autoregressive image
model of the port (mbt2018) would add its class and its weights module.
The counts below follow ``programs/stem.py``'s rule: the products of every
convolution, 1×1 and sub-pixel convs included, and of each GDN's norm.
"""

from portbench import peaks
from portbench import reference as R
from portbench import reference_cheng2020 as RC

ARCHS = ("cheng2020-attn",)


def _codec_class(arch):
    from spatiotemporalentropymodel_tpu_torch.models import waseda

    return {"cheng2020-attn": waseda.Cheng2020Attention}[arch]


def make(cfg, traffic, W, frames, device):
    if traffic["dtype"] != "float32":
        raise SystemExit(f"{cfg['name']}: the plain reference is f32 only")
    codec = _codec_class(cfg["arch"])(cfg["N"], ar_mode="wavefront",
                                      device=device)
    codec.module.load_state_dict(W.W, strict=True)
    codec.update(force=True)
    return {"codec": codec}, {"y_i": None}


def check(cfg, loop):
    """Refuses an arch the program does not know, and a port whose image
    codec runs g_a without the per-batch entry the loop times."""
    if cfg.get("arch") not in ARCHS:
        raise SystemExit(f"{cfg['name']}: arch {cfg.get('arch')!r} is not "
                         f"one of {ARCHS}")
    from spatiotemporalentropymodel_tpu_torch.models import priors

    if not hasattr(priors.JointAutoregressiveHierarchicalPriors,
                   "_analysis_streams"):
        raise SystemExit(f"{cfg['name']}: the port's image codec has no "
                         f"_analysis_streams, the g_a call the loop times")


def reference(W, cfg, net_dtype=None):
    return RC.Ref(W.W, cfg)


# ---- work ---------------------------------------------------------------


def _half(v):
    return (v + 1) // 2


def _conv(cin, cout, k, h, w):
    """(operations, weights) of a k×k conv with h×w outputs."""
    return peaks.conv(cin, cout, k, h, w), k * k * cin * cout + cout


def _layers(kinds, n, c, h, w):
    """(conv operations, [(pixels, C) of each GDN], weights) of a chain of
    blocks on a c×h×w input, and its output's (c, h, w)."""
    ops, norms, weights = 0, [], 0

    def add(*convs):
        nonlocal ops, weights
        for o, wt in convs:
            ops, weights = ops + o, weights + wt

    for kind in kinds:
        if kind == "rbws":
            h, w = _half(h), _half(w)
            add(_conv(c, n, 3, h, w), _conv(n, n, 3, h, w),
                _conv(c, n, 1, h, w))
            norms.append((h * w, n))
            weights += n * n + n
        elif kind == "rb":
            add(_conv(n, n, 3, h, w), _conv(n, n, 3, h, w))
        elif kind == "rbu":
            add(_conv(n, 4 * n, 3, h, w), _conv(n, 4 * n, 3, h, w))
            h, w = 2 * h, 2 * w
            add(_conv(n, n, 3, h, w))
            norms.append((h * w, n))
            weights += n * n + n
        elif kind == "attn":
            unit = (_conv(n, n // 2, 1, h, w), _conv(n // 2, n // 2, 3, h, w),
                    _conv(n // 2, n, 1, h, w))
            add(*unit * 6, _conv(n, n, 1, h, w))
        elif kind == "conv_s2":
            h, w = _half(h), _half(w)
            add(_conv(n, n, 3, h, w))
        elif kind == "subpel_out":
            add(_conv(n, 12, 3, h, w))
            h, w, n = 2 * h, 2 * w, 3
        else:
            raise ValueError(kind)
        c = n
    return (ops, norms, weights), (c, h, w)


def transforms(cfg, hw):
    """g_a's and g_s's layers on one picture, each with the elements of its
    input and output (the picture and the latent)."""
    n = cfg["N"]
    ga, (m, lh, lw) = _layers(RC.G_A, n, 3, *hw)
    gs, _ = _layers(RC.G_S, n, m, lh, lw)
    io = 3 * hw[0] * hw[1] + m * lh * lw
    return {"g_a": (ga, io), "g_s": (gs, io)}


def hyper_ops(n, h, w):
    """(h_a, h_s) operations on an h×w latent."""
    conv = peaks.conv
    h2, w2 = _half(h), _half(w)
    h4, w4 = _half(h2), _half(w2)
    ha = (2 * conv(n, n, 3, h, w) + conv(n, n, 3, h2, w2)
          + conv(n, n, 3, h2, w2) + conv(n, n, 3, h4, w4))
    n3 = n * 3 // 2
    hs = (conv(n, n, 3, h4, w4) + conv(n, 4 * n, 3, h4, w4)
          + conv(n, n3, 3, h2, w2) + conv(n3, 4 * n3, 3, h2, w2)
          + conv(n3, 2 * n, 3, h, w))
    return ha, hs


def row_ops(m):
    """Operations of one pixel's row: the masked context on its 12 causal
    taps, then the entropy-parameters stack."""
    w = (4 * m, m * 10 // 3, m * 8 // 3, m * 6 // 3)
    return 2 * len(R.TAPS) * m * 2 * m + sum(
        2 * a * b for a, b in zip(w, w[1:]))


def picture_ops(cfg, hw, served: bool):
    """Model operations per picture: g_a, h_a, then h_s and every pixel's
    row on the encoder, again on the decoder where the picture is served,
    then g_s."""
    n = cfg["N"]
    t = transforms(cfg, hw)
    lh, lw = -(-hw[0] // 16), -(-hw[1] // 16)
    ha, hs = hyper_ops(n, lh, lw)
    side = hs + row_ops(n) * lh * lw
    return (peaks.transform_ops(t["g_a"][0]) + ha
            + side * (2 if served else 1) + peaks.transform_ops(t["g_s"][0]))
