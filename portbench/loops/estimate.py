"""Rate estimation: ``StemVideoPipeline.gop_forward`` over the GOP's
P-frames of every stream, from the I-frame latent, two calls in flight at
most. A picture is forwarded, not coded. Warm-up: one call."""

import time

from portbench.harness import Loop

KEYS = ()
PROGRAMS = ("stem",)
VARIANTS = ("without_spm",)  # StemVideoPipeline drives no SPM variant


def make(st, spans, clock):
    return Estimate(st, spans, clock)


class Estimate(Loop):

    served = False

    def __init__(self, st, spans, clock):
        from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
            StemVideoPipeline,
        )

        self.st, self.clock = st, clock
        self.pipe = StemVideoPipeline(st.i_model, st.stem)
        self.cap_y, self.cap_f, self.ends = [], [], []
        spans.wrap(st.i_model, "analysis", "pb.g_a",
                   lambda a, k, o: self.cap_y.append(o))
        spans.wrap(st.i_model, "get_x", "pb.g_s")
        spans.wrap(st.stem, "forward", "pb.stem",
                   lambda a, k, o: self.cap_f.append((a[1], o["y_hat"])))

    def step(self):
        if len(self.ends) >= 2:
            self.clock.wait(self.ends[-2])
        self.cap_y.clear()
        self.cap_f.clear()
        t = time.perf_counter()
        frames = self.st.frames[1:]
        x_hat, bpp = self.pipe.gop_forward(frames, self.st.y_i)
        end = self.clock.mark()
        self.ends = self.ends[-1:] + [end]
        items = [{"x": frames[j], "y_cur": self.cap_y[j],
                  "y_cond": self.cap_f[j][0], "y_hat": self.cap_f[j][1],
                  "x_hat": x_hat[j], "bpp": bpp[j]}
                 for j in range(len(frames))]
        return [(t, end, self.st.b * len(frames))], items
