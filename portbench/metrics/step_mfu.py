"""The whole step's share of the chip's peak: model operations per picture
(g_a, the STEM's nets on encoder and decoder, g_s; from the configuration's
shapes) times the pictures of the traced window, over its length and the
peak of the cell's dtype (f32 on the CUDA cores with TF32 off, or bf16 on
the tensor cores), at the published H100 SXM rates."""

from portbench import peaks


def read(run):
    if not run.pictures or run.window_s <= 0:
        return None
    ops = peaks.picture_ops(run.cfg, run.hw, run.served) * run.pictures
    return 100.0 * ops / run.window_s / peaks.PEAK[run.traffic["dtype"]]
