"""Cheng2020 anchor and attention models (the residual-block variants of
mbt2018).

Counterpart of spatiotemporalentropymodel_tpu/models/waseda.py
(compressai/models/waseda.py:29-138): N == M, residual and attention g_a
and g_s, a 3×3-conv hyper pair with sub-pixel upsampling in h_s. The joint
AR entropy machinery and the codec are mbt2018's
(models/priors.py::JointAutoregressiveModule and
JointAutoregressiveHierarchicalPriors); only the transform factories
differ. No GDN here feeds a k5 s2 conv, so in bf16 the norms run the lone
``gdn_fused`` kernel (3 in g_a, 3 in g_s).
"""

from ..layers import (
    AttentionBlock,
    Conv,
    LeakyReLU,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    Sequential,
    SubpelConv3x3,
)
from .priors import (
    JointAutoregressiveHierarchicalPriors,
    JointAutoregressiveModule,
)


def _lrelu():
    return LeakyReLU(0.01)


class _Transform(Sequential):
    """g_a or g_s, whose f32 3×3 stride-1 convs on the card run through
    PyTorch's own CUDA convolution (``Conv.im2col``). For some of them
    cuDNN's heuristics (deterministic, no autotuning, TF32 off), and its
    autotuner too, take FFT convolutions: at 136 × 240, and at 68 × 120 in a
    batch of 4, 33 024 GEMV or complex-GEMM launches of 0.24-0.42 s for
    22-87 GFLOP. With im2col and a cuBLAS GEMM the 1088 × 1920 g_a took
    71 ms on an H100 where cuDNN took 823, g_s on 4 latents 334 where it
    took 1799 (PERF.md §6). The anchor's transforms hold the same convs."""

    def __init__(self, layers):
        super().__init__(layers)
        for m in self.modules():
            if isinstance(m, Conv) and m.stride == 1 and \
                    m.weight.shape[-1] == 3:
                m.im2col = True


class Cheng2020AnchorModule(JointAutoregressiveModule):
    def _build_g_a(self, g):
        n = self.N
        return _Transform([
            ResidualBlockWithStride(3, n, 2, g), ResidualBlock(n, n, g),
            ResidualBlockWithStride(n, n, 2, g), ResidualBlock(n, n, g),
            ResidualBlockWithStride(n, n, 2, g), ResidualBlock(n, n, g),
            Conv(n, n, 3, 2, g),
        ])

    def _build_h_a(self, g):
        n = self.N
        return Sequential([
            Conv(n, n, 3, 1, g), _lrelu(), Conv(n, n, 3, 1, g), _lrelu(),
            Conv(n, n, 3, 2, g), _lrelu(), Conv(n, n, 3, 1, g), _lrelu(),
            Conv(n, n, 3, 2, g),
        ])

    def _build_h_s(self, g):
        n, n3 = self.N, self.N * 3 // 2
        return Sequential([
            Conv(n, n, 3, 1, g), _lrelu(), SubpelConv3x3(n, n, 2, g),
            _lrelu(), Conv(n, n3, 3, 1, g), _lrelu(),
            SubpelConv3x3(n3, n3, 2, g), _lrelu(), Conv(n3, n * 2, 3, 1, g),
        ])

    def _build_g_s(self, g):
        n = self.N
        return _Transform([
            ResidualBlock(n, n, g), ResidualBlockUpsample(n, n, 2, g),
            ResidualBlock(n, n, g), ResidualBlockUpsample(n, n, 2, g),
            ResidualBlock(n, n, g), ResidualBlockUpsample(n, n, 2, g),
            ResidualBlock(n, n, g), SubpelConv3x3(n, 3, 2, g),
        ])


class Cheng2020AttentionModule(Cheng2020AnchorModule):
    def _build_g_a(self, g):
        n = self.N
        return _Transform([
            ResidualBlockWithStride(3, n, 2, g), ResidualBlock(n, n, g),
            ResidualBlockWithStride(n, n, 2, g), AttentionBlock(n, g),
            ResidualBlock(n, n, g), ResidualBlockWithStride(n, n, 2, g),
            ResidualBlock(n, n, g), Conv(n, n, 3, 2, g), AttentionBlock(n, g),
        ])

    def _build_g_s(self, g):
        n = self.N
        return _Transform([
            AttentionBlock(n, g), ResidualBlock(n, n, g),
            ResidualBlockUpsample(n, n, 2, g), ResidualBlock(n, n, g),
            ResidualBlockUpsample(n, n, 2, g), AttentionBlock(n, g),
            ResidualBlock(n, n, g), ResidualBlockUpsample(n, n, 2, g),
            ResidualBlock(n, n, g), SubpelConv3x3(n, 3, 2, g),
        ])


class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    """cheng2020-anchor: mbt2018's codec with N = M."""

    _module_cls = Cheng2020AnchorModule

    def __init__(self, N: int = 192, ar_mode: str = "wavefront",
                 device="cuda", seed: int = 0):
        super().__init__(N, N, ar_mode, device, seed)


class Cheng2020Attention(JointAutoregressiveHierarchicalPriors):
    """cheng2020-attn: the anchor with attention blocks in g_a and g_s."""

    _module_cls = Cheng2020AttentionModule

    def __init__(self, N: int = 192, ar_mode: str = "wavefront",
                 device="cuda", seed: int = 0):
        super().__init__(N, N, ar_mode, device, seed)
