"""Closed serve loop of the parallel STEM (the sparse transport).

Each step encodes one P-frame of every stream with
``StemVideoPipeline.encode_frames`` (host coding of a frame overlapping
the device encode of the next) and decodes its record with
``decode_frame`` as soon as it arrives; both ŷ carries stay on the device
and restart from the I-frame latent every GOP. Warm-up: one whole GOP."""

import time

from portbench.harness import Loop

KEYS = ()
PROGRAMS = ("stem",)
VARIANTS = ("without_spm",)  # the STEMs the weights and reference make


def make(st, spans, clock):
    return ParallelServe(st, spans, clock)


class ParallelServe(Loop):

    def __init__(self, st, spans, clock):
        from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
            StemVideoPipeline,
        )

        self.clock, self.gop = clock, st.gop
        self.warmup_steps = st.gop - 1
        self.frames, self.y_i = st.frames, st.y_i
        self.pipe = StemVideoPipeline(st.i_model, st.stem,
                                      transport_mode="sparse")
        self.cap_y, self.cap_carry, self.handoff = [], [], []
        spans.wrap(st.i_model, "analysis", "pb.g_a",
                   lambda a, k, o: self.cap_y.append(o))
        spans.wrap(st.i_model, "get_x", "pb.g_s")
        spans.wrap(st.stem, "fused_encode_sparse_carry_expr", "pb.stem",
                   lambda a, k, o: self.cap_carry.append((a[1], o[1])))
        spans.wrap(st.stem, "fused_params_sparse_expr", "pb.stem")
        spans.wrap(st.stem, "fused_reconstruct_sparse_expr", "pb.stem")
        spans.wrap(self.pipe, "code_sparse_buffer", "pb.host_coder")
        spans.wrap(self.pipe, "_host_decode_sparse", "pb.host_coder")
        self.gen = None

    def _gop(self):
        self.cap_y.clear()
        self.cap_carry.clear()
        self.handoff.clear()
        self.k, self.y_dec = 0, self.y_i

        def feed():
            for j in range(1, self.gop):
                self.handoff.append(time.perf_counter())
                yield self.frames[j]

        self.gen = self.pipe.encode_frames(feed(), self.y_i)

    def step(self):
        enc = None if self.gen is None else next(self.gen, None)
        if enc is None:
            self._gop()
            enc = next(self.gen)
        k, y_cond_dec = self.k, self.y_dec
        x_hat, self.y_dec = self.pipe.decode_frame(enc, y_cond=y_cond_dec)
        end = self.clock.mark()
        self.k += 1
        y_cond, carry = self.cap_carry[k]
        item = {"x": self.frames[k + 1], "y_cur": self.cap_y[k],
                "y_cond": y_cond, "carry": carry, "strings": enc["strings"],
                "counts": enc.get("counts"), "y_hat_dec": self.y_dec,
                "x_hat": x_hat}
        return [(self.handoff[k], end, self.frames.shape[1])], [item]

    def close(self):
        if self.gen is not None:
            self.gen.close()
        self.gen = None
