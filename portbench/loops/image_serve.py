"""Closed loop of a joint autoregressive image codec through its model API:
each step ``compress``es one picture of every stream as a batch, then
``decompress``es its strings; the step's pictures count once their x̂ is
complete on the card. Each stream's pictures are the traffic's ``gop``
distinct pictures, cycled.

Spans, none inside another: ``pb.g_a`` around the codec's per-batch g_a
(``_analysis_streams``: g_a runs once per stream, so one call is the
batch's pictures, as the roofline readers count them), ``pb.hyper`` around
h_a and the priors (h_s) of both sides, ``pb.ar`` around the autoregressive
encode and decode (the wavefront rounds with their host rANS), ``pb.g_s``
around g_s. The host coder's time is the model's stage clock
(``enc_host_s`` + ``host_rans_s``: y's rANS on both sides), read in traced
runs only, as ``loops/wavefront_serve.py`` reads it."""

import time

import torch

from portbench.harness import Loop

KEYS = ()
PROGRAMS = ("cheng2020",)


def make(st, spans, clock):
    return ImageServe(st, spans, clock)


class ImageServe(Loop):

    def __init__(self, st, spans, clock):
        self.st, self.clock, self.k = st, clock, 0
        self.codec = codec = st.codec
        self.y = []
        spans.wrap(codec, "_analysis_streams", "pb.g_a",
                   lambda args, kw, out: self.y.append(out))
        spans.wrap(codec.module.h_a, "forward", "pb.hyper")
        spans.wrap(codec, "_priors", "pb.hyper")
        spans.wrap(codec, "_ar_encode", "pb.ar")
        spans.wrap(codec, "_ar_decode", "pb.ar")
        spans.wrap(codec.module.g_s, "forward", "pb.g_s")

    @torch.no_grad()
    def step(self):
        x = self.st.frames[self.k % self.st.gop]
        self.k += 1
        self.y.clear()
        t = time.perf_counter()
        enc = self.codec.compress(x)
        dec = self.codec.decompress(enc["strings"], enc["shape"])
        end = self.clock.mark()
        item = {"x": x, "y": self.y[0], "strings": enc["strings"],
                "y_hat": dec["y_hat"], "x_hat": dec["x_hat"]}
        return [(t, end, x.shape[0])], [item]

    def before_window(self, trace):
        if trace:
            self.codec._codec_stats = {}

    def host_coder_s(self, spans):
        stats = self.codec._codec_stats
        if not stats:
            return None
        return stats.get("enc_host_s", 0.0) + stats.get("host_rans_s", 0.0)
