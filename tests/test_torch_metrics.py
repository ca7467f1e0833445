"""The port's metrics and padding against the JAX package's, on the CPU:
PSNR and SSIM to 1e-5, MS-SSIM at 192×192 (the smallest side its five
scales take) to 1e-5, the estimated bpp to rtol 1e-6, and the actual bpp,
counts charged at their wire cost, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval import metrics as jm
from spatiotemporalentropymodel_tpu.ops import padding as jp
from spatiotemporalentropymodel_tpu_torch.eval import metrics as pm
from spatiotemporalentropymodel_tpu_torch.ops import padding as pp

from torch_port_util import to_nchw, to_nhwc


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 48, 40, 3), (1, 33, 65, 3)])
def test_psnr_ssim_match_jax(shape):
    a, b = _pair(0, shape)
    ta, tb = to_nchw(a), to_nchw(b)
    assert float(pm.psnr(ta, tb)) == pytest.approx(
        float(jm.psnr(jnp.asarray(a), jnp.asarray(b))), abs=1e-5)
    assert float(pm.mse(ta, tb)) == pytest.approx(
        float(jm.mse(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    s, cs = pm.ssim(ta, tb, return_cs=True)
    js, jcs = jm.ssim(jnp.asarray(a), jnp.asarray(b), return_cs=True)
    assert float(s) == pytest.approx(float(js), abs=1e-5)
    assert float(cs) == pytest.approx(float(jcs), abs=1e-5)
    # a bf16 reconstruction is compared in f32
    assert float(pm.psnr(ta, tb.bfloat16())) == pytest.approx(
        float(pm.psnr(ta, tb.bfloat16().float())), abs=1e-12)


@pytest.mark.parametrize("hw", [(192, 192), (193, 201)])
def test_ms_ssim_matches_jax(hw):
    a, b = _pair(1, (1, *hw, 3))
    got = float(pm.ms_ssim(to_nchw(a), to_nchw(b)))
    assert got == pytest.approx(float(jm.ms_ssim(jnp.asarray(a),
                                                 jnp.asarray(b))), abs=1e-5)
    small = to_nchw(a[:, :64, :64])
    assert np.isnan(pm.ms_ssim_or_nan(small, small))
    with pytest.raises(ValueError):
        pm.ms_ssim(small, small)


def test_bpp_match_jax():
    rng = np.random.default_rng(2)
    lk = {"y": rng.uniform(1e-9, 1, (2, 4, 6, 8)).astype(np.float32),
          "z": rng.uniform(1e-3, 1, (2, 4, 2, 2)).astype(np.float32)}
    got = pm.estimate_bpp({k: to_nchw(v) for k, v in lk.items()}, 1000)
    want = float(jm.estimate_bpp({k: jnp.asarray(v) for k, v in lk.items()},
                                 1000))
    assert got == pytest.approx(want, rel=1e-6)
    strings = [[b"\x01" * 37, b"\x02" * 5], [[b"\x03" * 11], b"\x04" * 2]]
    counts = rng.integers(0, 300, (2, 64)) * (rng.random((2, 64)) < 0.3)
    for c in (None, counts):
        assert pm.actual_bpp(strings, 4096, counts=c) == jm.actual_bpp(
            strings, 4096, counts=c)


@pytest.mark.parametrize("hw", [(64, 64), (70, 100), (1, 130)])
def test_padding_matches_jax(hw):
    x = np.random.default_rng(3).random((2, *hw, 3), dtype=np.float32)
    got, pads = pp.pad_centered(to_nchw(x), 64)
    want, jpads = jp.pad_centered(jnp.asarray(x), 64)
    assert pads == jpads
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(to_nhwc(pp.crop_centered(got, pads)), x)
    got, size = pp.pad_to_multiple(to_nchw(x), 64)
    want, jsize = jp.pad_to_multiple(jnp.asarray(x), 64)
    assert size == jsize
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(to_nhwc(pp.crop_to(got, size)), x)
