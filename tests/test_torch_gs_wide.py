"""The lone g_s kernels, igdn_deconv_fused and igdn_deconv_wide, through their
plain versions, and the Sequential knobs that route g_s to them, against the
JAX package on the CPU.

Each wrapper is held to the JAX Pallas kernel run in interpret mode (as
tests/test_pallas.py runs it): f32 atol 1e-4; in bf16 the interpret-mode
kernel rounds the IGDN'd window to bf16 before its dot while the port's plain
version keeps it f32 (pallas_kernels.py::_igdn_deconv_ref does too), so atol
6e-2, rtol 3e-2, the repo's bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.models import MeanScaleHyperprior as JaxMSH
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch.convert import (
    invert_deconv_weight,
    load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.models import MeanScaleHyperprior
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import jax_tree_numpy, to_nchw, to_nhwc

F32_ATOL = 1e-4
BF16_ATOL, BF16_RTOL = 6e-2, 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, shape, o):
    """NHWC x, γᵀ, β and a flipped-HWIO deconv kernel and bias, at the JAX
    tests' scale."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    gt = (0.01 * np.abs(rng.standard_normal((c, c)))
          + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    kernel = (0.05 * rng.standard_normal((5, 5, c, o))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    return x, gt, beta, kernel, bias


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def _both(jax_fn, port_fn, case, dtype):
    jd, td = DTYPES[dtype]
    x, gt, beta, kernel, bias = case
    ref = jax_fn(jnp.asarray(x, jd), jnp.asarray(gt), jnp.asarray(beta),
                 jnp.asarray(kernel, jd), jnp.asarray(bias))
    got = port_fn(to_nchw(x).to(td), _t(gt), _t(beta),
                  _t(invert_deconv_weight(kernel), td), _t(bias))
    return got, ref


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [3, 8, 32])
def test_igdn_deconv_fused_matches_jax_interpret(dtype, f):
    case = _case(f, (2, 8, 8, 64), f)
    got, ref = _both(
        lambda *a: pk.igdn_deconv_fused(*a, 2, interpret=True),
        kernels.igdn_deconv_fused, case, dtype)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, f, 16, 16)
    _close(to_nhwc(got.float()), np.asarray(ref, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_igdn_deconv_wide_matches_jax_interpret(dtype):
    case = _case(40, (2, 4, 6, 128), 128)
    got, ref = _both(
        lambda *a: pk.igdn_deconv_wide(*a, interpret=True),
        kernels.igdn_deconv_wide, case, dtype)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 128, 8, 12)
    _close(to_nhwc(got.float()), np.asarray(ref, np.float32), dtype)


@pytest.fixture
def msh():
    """MeanScaleHyperprior(64, 64) with the same perturbed weights in both
    packages, and a bf16 latent for g_s."""
    rng = np.random.default_rng(21)
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    jax_m = JaxMSH(64, 64)
    jax_m.init(jnp.asarray(x))
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), jax_tree_numpy(jax_m.params))
    jax_m.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = MeanScaleHyperprior(64, 64, device="cpu")
    load_jax_params(port.module, tree)
    y = (rng.standard_normal((1, 4, 4, 64))).astype(np.float32)
    return jax_m, port, y


def _record(monkeypatch):
    """The fused wrappers' calls, in order (on the CPU they run the plain
    versions and add nothing to LAUNCHES)."""
    calls = []
    for name in ("gdn_fused", "gdn_conv_fused", "igdn_deconv_wide_packed",
                 "igdn_deconv_tail_packed", "igdn_deconv_fused",
                 "igdn_deconv_wide"):
        real = getattr(kernels, name)

        def recorded(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(kernels, name, recorded)
    return calls


KNOB_ROUTES = {
    "default": ({}, ["gdn_fused", "igdn_deconv_wide_packed",
                     "igdn_deconv_tail_packed"]),
    "wide": (kernels.WIDE_KNOBS, ["igdn_deconv_wide", "igdn_deconv_wide",
                                  "igdn_deconv_fused"]),
    "packed_off": ({"FUSE_GS_PACKED": False},
                   ["gdn_fused", "gdn_fused", "igdn_deconv_fused"]),
    "all_off": ({"FUSE_GS_PACKED": False, "FUSE_IGDN_DECONV": False,
                 "FUSE_GDN_CONV": False}, ["gdn_fused"] * 3),
}


@pytest.mark.parametrize("route", list(KNOB_ROUTES))
def test_knobs_route_g_s_and_match_jax_bf16(msh, monkeypatch, route):
    """Each knob set routes the bf16 g_s at N = 64 through the wrappers in
    the JAX package's peephole order, an f32 g_s through its IGDN layers
    alone, g_a's GDN →
    Conv pairs through gdn_conv_fused unless FUSE_GDN_CONV is off; the bf16
    x̂ matches the JAX package's bf16 g_s (which runs its plain layers on
    the CPU) at the bf16 tolerance; the knobs come back afterwards."""
    jax_m, port, y = msh
    values, want = KNOB_ROUTES[route]
    calls = _record(monkeypatch)
    jax_m.set_compute_dtype(jnp.bfloat16)
    x_ref = jax_m.get_x(jnp.asarray(y))
    with kernels.knobs(**values), torch.no_grad():
        port.module.g_s(to_nchw(y))
        assert calls == ["gdn_fused"] * 3  # the IGDN layers on their own
        del calls[:]
        port.set_compute_dtype(torch.bfloat16)
        x_hat = port.get_x(to_nchw(y))
        assert calls == want
        del calls[:]
        port.analysis(torch.rand((1, 3, 64, 64)))
        assert calls == (["gdn_fused"] * 3 if route == "all_off"
                         else ["gdn_conv_fused"] * 3)
    assert (kernels.FUSE_GS_PACKED, kernels.FUSE_GDN_CONV,
            kernels.FUSE_IGDN_DECONV, kernels.FUSE_IGDN_DECONV_WIDE) == (
        True, True, True, False)
    assert x_hat.dtype == torch.bfloat16
    np.testing.assert_allclose(to_nhwc(x_hat.float()),
                               np.asarray(x_ref, np.float32),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


def test_knobs_reject_unknown_names():
    with pytest.raises(KeyError):
        with kernels.knobs(FUSE_NOTHING=True):
            pass
    with pytest.raises(KeyError):
        with kernels.knobs(LAUNCHES={}):
            pass
