"""Closed serve loop of the wavefront STEM (the spatial prior's
autoregressive rounds) through ``WavefrontVideoPipeline.serve_latent``,
one P-frame of every stream a step, g_s left in flight as the pipeline
schedules it. The latent is the carry plus the configuration's fixed noise
per GOP position (the JAX bench's wavefront latent), with g_a run on the
frame for its cost. Warm-up: one whole GOP. The host coder's time is the
model's stage clock (``enc_host_s`` + ``host_rans_s``), read in traced
runs only: it synchronises."""

import time

import torch

from portbench.harness import Loop

KEYS = ()
PROGRAMS = ("stem",)
VARIANTS = ("res",)  # the SPM STEM the weights and reference make


def make(st, spans, clock):
    return WavefrontServe(st, spans, clock)


class WavefrontServe(Loop):

    def __init__(self, st, spans, clock):
        from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
            WavefrontVideoPipeline,
        )

        if st.noise is None:
            raise SystemExit("the wavefront loop serves the carry_noise "
                             "latent: the configuration draws none")
        self.st, self.clock = st, clock
        self.stem = st.stem
        self.warmup_steps = st.gop - 1
        self.pipe = WavefrontVideoPipeline(st.i_model, st.stem)
        spans.wrap(st.i_model, "analysis", "pb.g_a")
        spans.wrap(st.i_model, "get_x", "pb.g_s")
        spans.wrap(st.stem, "compress", "pb.stem")
        spans.wrap(st.stem, "decompress", "pb.stem")
        self.k = self.st.gop

    @torch.no_grad()
    def step(self):
        if self.k >= self.st.gop:
            self.k, self.y_cond = 1, self.st.y_i
        t = time.perf_counter()
        x, y_cond = self.st.frames[self.k], self.y_cond
        y_ga = self.pipe.analysis(x)
        y_cur = y_cond + self.st.noise[self.k] + 1e-30 * y_ga.float().mean()
        enc, y_hat, x_hat = self.pipe.serve_latent(y_cur, y_cond, self.k)
        end = self.clock.mark()
        self.k += 1
        self.y_cond = y_hat
        item = {"x": x, "y_cur": y_cur, "y_cond": y_cond, "y_ga": y_ga,
                "strings": enc["strings"], "y_hat_dec": y_hat,
                "x_hat": x_hat}
        return [(t, end, self.st.b)], [item]

    def before_window(self, trace):
        if trace:
            self.stem._codec_stats = {}

    def host_coder_s(self, spans):
        stats = getattr(self.stem, "_codec_stats", None)
        if not stats:
            return None
        return stats.get("enc_host_s", 0.0) + stats.get("host_rans_s", 0.0)
