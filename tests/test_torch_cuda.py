"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without one. This file imports neither jax nor
the JAX package, so it also runs on a machine that has only PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu_torch.entropy import get_scale_table
from spatiotemporalentropymodel_tpu_torch.ops import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs the same "
                    "checks at the serving shapes)")
    return torch.device("cuda")


def _edge_inputs(device, shape=(2, 64, 8, 8), seed=4):
    """(y, μ, σ) with y−μ on ±k.5 ties and beyond ±2³⁰, and σ on, just below
    and just above every f32 table entry and 0.11."""
    rng = np.random.default_rng(seed)
    t32 = get_scale_table().astype(np.float32)
    means = (2 * rng.standard_normal(shape)).astype(np.float32)
    y = (means + 3 * rng.standard_normal(shape)).astype(np.float32)
    scales = np.exp(4 * rng.random(shape) - 3).astype(np.float32)
    yf, mf, sf = y.reshape(-1), means.reshape(-1), scales.reshape(-1)
    ties = np.arange(-20, 21, dtype=np.float32) + 0.5
    mf[:ties.size], yf[:ties.size] = 0.0, ties
    big = np.array([3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128], np.float32)
    o = ties.size
    mf[o:o + big.size], yf[o:o + big.size] = 0.0, big
    edges = np.concatenate([
        t32, np.nextafter(t32, np.float32(-1)),
        np.nextafter(t32, np.float32(1e9)),
        np.array([0.11, 0.0, -1.0, 0.05], np.float32),
        np.nextafter(np.float32(0.11), np.float32(1))[None],
    ]).astype(np.float32)
    sf[:edges.size] = edges
    return [torch.from_numpy(a).to(device) for a in (y, means, scales)]


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    """Both kernels against their plain versions (gdn rtol 1e-5,
    quantize_and_index exact), and each launch counted."""
    y, means, scales = _edge_inputs(cuda)
    t = kernels.scale_table_tensor(get_scale_table(), cuda)
    n0 = dict(kernels.LAUNCHES)
    sym, idx = kernels.quantize_and_index(y, means, scales, t)
    rs, ri = kernels._qidx_ref(y, means, scales, t, 0.11)
    assert torch.equal(sym, rs) and torch.equal(idx, ri)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 192, 24, 40)).astype(
        np.float32)).to(cuda)
    gt = torch.from_numpy((0.02 * rng.random((192, 192))
                           + 0.1 * np.eye(192)).astype(np.float32)).to(cuda)
    beta = torch.ones(192, device=cuda)
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gt, beta, inverse)
        ref = kernels._gdn_ref(x, gt, beta, inverse)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    assert kernels.LAUNCHES["gdn_fused"] == n0["gdn_fused"] + 2
    assert (kernels.LAUNCHES["quantize_and_index"]
            == n0["quantize_and_index"] + 1)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    """On a CUDA tensor a wrapper launches or raises, never runs the plain
    version: wrong dtype, non-contiguous input and a wrong γ shape raise."""
    x = torch.randn((1, 8, 4, 4), device=cuda)
    g = torch.eye(8, device=cuda)
    b = torch.ones(8, device=cuda)
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError):
        kernels.gdn_fused(x.double(), g.double(), b.double())
    with pytest.raises(ValueError):
        kernels.gdn_fused(x.transpose(2, 3), g, b)
    with pytest.raises(ValueError):
        kernels.gdn_fused(x, torch.eye(4, device=cuda), b)
    assert kernels.LAUNCHES == n0
