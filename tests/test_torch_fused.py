"""The bf16 path's fused GDN + conv kernels, through their plain versions, and
the Sequential peepholes that dispatch to them, against the JAX package on
the CPU.

Each plain version is held to its JAX ``_ref`` in f32 (atol 1e-4) and in bf16.
In bf16 both sides round at the same points (GDN output before the conv in
``_gdn_conv_ref``; one rounding at the end of ``_igdn_deconv_ref``), but XLA
and PyTorch sum the bf16 convs in other orders and XLA may keep bf16
elementwise chains in f32, so outputs may differ by a bf16 step or two:
atol 6e-2, rtol 3e-2, the repo's bf16 tolerance (tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu import layers as jl
from spatiotemporalentropymodel_tpu.models import MeanScaleHyperprior as JaxMSH
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch import layers as tl
from spatiotemporalentropymodel_tpu_torch.convert import (
    invert_conv_weight,
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


def _gdn_params(rng, c):
    gt = (0.01 * np.abs(rng.standard_normal((c, c)))
          + 0.1 * np.eye(c)).astype(np.float32)
    return gt, (1.0 + rng.random(c)).astype(np.float32)


def _conv_case(seed, shape, o):
    """NHWC x and the GDN + HWIO conv weights of the JAX tests' scale."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    gt, beta = _gdn_params(rng, shape[-1])
    kernel = (0.05 * rng.standard_normal((5, 5, shape[-1], o))).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    return x, gt, beta, kernel, bias


def _pack_phase_major(y):
    """Logical NHWC (B, 2H, 2W, O) → the TPU's phase-major packed
    (B, H, W, 4O) (pallas_kernels.py::_igdn_deconv_wide_packed_ref)."""
    b, h2, w2, o = y.shape
    v = y.reshape(b, h2 // 2, 2, w2 // 2, 2, o)
    return v.transpose(0, 1, 3, 2, 4, 5).reshape(b, h2 // 2, w2 // 2, 4 * o)


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gdn_conv_plain_matches_jax_ref(dtype):
    jd, td = DTYPES[dtype]
    x, gt, beta, kernel, bias = _conv_case(0, (2, 12, 22, 64), 64)
    ref = pk._gdn_conv_ref(jnp.asarray(x, jd), jnp.asarray(gt),
                           jnp.asarray(beta), jnp.asarray(kernel, jd),
                           jnp.asarray(bias, jd))
    got = kernels._gdn_conv_ref(to_nchw(x).to(td), _t(gt), _t(beta),
                                _t(invert_conv_weight(kernel), td),
                                _t(bias, td))
    assert got.dtype == td and got.shape == (2, 64, 6, 11)
    _close(to_nhwc(got.float()), np.asarray(ref, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_igdn_deconv_plain_matches_jax_packed_refs(dtype):
    """The port's one plain version against both JAX packed refs: the wide
    one unpacked from the phase-major layout, and the tail one fed the
    phase-major packing of the port's logical input."""
    jd, td = DTYPES[dtype]
    x, gt, beta, kernel, bias = _conv_case(1, (2, 6, 10, 64), 64)
    jax_kernel = kernel[::-1, ::-1].copy()  # the JAX Deconv's flipped layout
    wide = pk._igdn_deconv_wide_packed_ref(
        jnp.asarray(x, jd), jnp.asarray(gt), jnp.asarray(beta),
        jnp.asarray(jax_kernel, jd), jnp.asarray(bias, jd))
    got = kernels._igdn_deconv_ref(to_nchw(x).to(td), _t(gt), _t(beta),
                                   _t(invert_deconv_weight(jax_kernel), td),
                                   _t(bias, td))
    assert got.shape == (2, 64, 12, 20)
    _close(_pack_phase_major(to_nhwc(got.float())),
           np.asarray(wide, np.float32), dtype)

    _, gt3, beta3, k3, b3 = _conv_case(2, (1, 1, 1, 64), 3)
    mid = to_nhwc(got.float())
    tail = pk._igdn_deconv_tail_packed_ref(
        jnp.asarray(_pack_phase_major(mid), jd), jnp.asarray(gt3),
        jnp.asarray(beta3), jnp.asarray(k3, jd), jnp.asarray(b3, jd))
    got3 = kernels._igdn_deconv_ref(got, _t(gt3), _t(beta3),
                                    _t(invert_deconv_weight(k3), td),
                                    _t(b3, td))
    assert got3.shape == (2, 3, 24, 40)
    _close(to_nhwc(got3.float()), np.asarray(tail, np.float32), dtype)


def test_packed_pair_matches_composed_jax_refs():
    """wide → tail (the port's plain versions) == IGDN→deconv→IGDN→deconv
    composed from the JAX _igdn_deconv_ref, f32."""
    x, g1, b1, k1, s1 = _conv_case(3, (1, 4, 6, 64), 64)
    _, g2, b2, k2, s2 = _conv_case(4, (1, 1, 1, 64), 3)
    mid = pk._igdn_deconv_ref(jnp.asarray(x), jnp.asarray(g1),
                              jnp.asarray(b1), jnp.asarray(k1),
                              jnp.asarray(s1), 2)
    ref = pk._igdn_deconv_ref(mid, jnp.asarray(g2), jnp.asarray(b2),
                              jnp.asarray(k2), jnp.asarray(s2), 2)
    m = kernels.igdn_deconv_wide_packed(
        to_nchw(x), _t(g1), _t(b1), _t(invert_deconv_weight(k1)), _t(s1))
    got = kernels.igdn_deconv_tail_packed(
        m, _t(g2), _t(b2), _t(invert_deconv_weight(k2)), _t(s2))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=F32_ATOL)


def test_interpret_mode_kernels_match_port_plain_versions():
    """The TPU kernels themselves, run in Pallas interpret mode as
    tests/test_pallas.py runs them, against the port's plain versions at
    one tiny shape (f32; atol 2e-4 and 5e-4, that file's tolerances)."""
    x, gt, beta, kernel, bias = _conv_case(5, (1, 8, 16, 64), 48)
    got = pk.gdn_conv_fused(jnp.asarray(x), jnp.asarray(gt),
                            jnp.asarray(beta), jnp.asarray(kernel),
                            jnp.asarray(bias), True)
    plain = kernels._gdn_conv_ref(to_nchw(x), _t(gt), _t(beta),
                                  _t(invert_conv_weight(kernel)), _t(bias))
    np.testing.assert_allclose(np.asarray(got), to_nhwc(plain), atol=2e-4)

    x, g1, b1, k1, s1 = _conv_case(6, (1, 4, 6, 24), 32)
    _, g2, b2, k2, s2 = _conv_case(7, (1, 1, 1, 32), 3)
    packed = pk.igdn_deconv_wide_packed(
        jnp.asarray(x), jnp.asarray(g1), jnp.asarray(b1), jnp.asarray(k1),
        jnp.asarray(s1), True)
    got = pk.igdn_deconv_tail_packed(
        packed, jnp.asarray(g2), jnp.asarray(b2), jnp.asarray(k2),
        jnp.asarray(s2), True)
    m = kernels._igdn_deconv_ref(to_nchw(x), _t(g1), _t(b1),
                                 _t(invert_deconv_weight(k1)), _t(s1))
    np.testing.assert_allclose(
        np.asarray(pk._unpack_phase_major(packed, 32)), to_nhwc(m),
        atol=2e-4)
    plain = kernels._igdn_deconv_ref(m, _t(g2), _t(b2),
                                     _t(invert_deconv_weight(k2)), _t(s2))
    np.testing.assert_allclose(np.asarray(got), to_nhwc(plain), atol=5e-4)


@pytest.fixture
def msh():
    """MeanScaleHyperprior(64, 64) with the same weights in both packages
    (fresh for each test: casting to bf16 and back is lossy)."""
    rng = np.random.default_rng(8)
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    jax_m = JaxMSH(64, 64)
    jax_m.init(jnp.asarray(x))
    # perturb every leaf off its init, so the GDNs are not diagonal
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), jax_tree_numpy(jax_m.params))
    jax_m.params = jax.tree_util.tree_map(jnp.asarray, tree)
    port = MeanScaleHyperprior(64, 64, device="cpu")
    load_jax_params(port.module, tree)
    return jax_m, port, x


def _spy(monkeypatch):
    """Count the fused wrappers' calls (on the CPU they run the plain
    versions and add nothing to LAUNCHES)."""
    calls = {}
    for name in ("gdn_conv_fused", "igdn_deconv_wide_packed",
                 "igdn_deconv_tail_packed"):
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a)

        monkeypatch.setattr(kernels, name, counted)
    return calls


def _chain(seq, x):
    """The plain chain: every layer on its own."""
    for layer in seq.layers:
        x = layer(x)
    return x


def test_peepholes_fire_in_bf16_only_and_match_the_plain_chain(msh,
                                                               monkeypatch):
    """g_a fuses its three GDN→Conv pairs and g_s its last IGDN→Deconv
    quadruple at bf16 and nothing at f32, as in the JAX package; the fused
    chain matches the plain one (bf16 tolerance) with the plain chain's
    parameters and state-dict keys."""
    _, port, x = msh
    module = port.module
    keys = list(module.state_dict())
    calls = _spy(monkeypatch)
    with torch.no_grad():
        xt = to_nchw(x)
        y32 = module.g_a(xt)
        x32 = module.g_s(y32)
        assert calls == {}
        assert torch.equal(y32, _chain(module.g_a, xt))
        assert torch.equal(x32, _chain(module.g_s, y32))

        port.set_compute_dtype(torch.bfloat16)
        xb, yb = xt.to(torch.bfloat16), y32.to(torch.bfloat16)
        y16 = module.g_a(xb)
        x16 = module.g_s(yb)
        assert calls == {"gdn_conv_fused": 3,
                         "igdn_deconv_wide_packed": 1,
                         "igdn_deconv_tail_packed": 1}
        assert y16.dtype == x16.dtype == torch.bfloat16
        np.testing.assert_allclose(y16.float().numpy(),
                                   _chain(module.g_a, xb).float().numpy(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
        np.testing.assert_allclose(x16.float().numpy(),
                                   _chain(module.g_s, yb).float().numpy(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
        assert list(module.state_dict()) == keys


def test_bf16_transforms_match_jax_bf16(msh):
    """g_a and g_s at bf16 (fused dispatch, plain versions) against the JAX
    package's bf16 transforms on the same weights and input."""
    jax_m, port, x = msh
    jax_m.set_compute_dtype(jnp.bfloat16)
    port.set_compute_dtype(torch.bfloat16)
    y_ref = jax_m._apply(jnp.asarray(x), method="analysis")[0]
    x_ref = jax_m.get_x(y_ref)
    y = port.analysis(to_nchw(x))
    x_hat = port.get_x(to_nchw(np.asarray(y_ref, np.float32)))
    assert y.dtype == x_hat.dtype == torch.bfloat16
    np.testing.assert_allclose(to_nhwc(y.float()),
                               np.asarray(y_ref, np.float32),
                               atol=BF16_ATOL, rtol=BF16_RTOL)
    np.testing.assert_allclose(to_nhwc(x_hat.float()),
                               np.asarray(x_ref, np.float32),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


def test_gdn_bf16_matches_jax_gdn_bf16():
    """One GDN layer at bf16 in both packages: bf16 reparametrization, f32
    norm, bf16 output (one bf16 step: rtol 2⁻⁷)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 7, 64)).astype(np.float32)
    for inverse in (False, True):
        jg, tg = jl.GDN(64, inverse=inverse), tl.GDN(64, inverse=inverse)
        params = jax_tree_numpy(jg.init(jax.random.PRNGKey(0),
                                        jnp.asarray(x))["params"])
        params = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in params.items()}
        load_jax_params(tg, params)
        tg.to(torch.bfloat16)
        ref = jg.apply({"params": jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), params)},
            jnp.asarray(x, jnp.bfloat16))
        with torch.no_grad():
            got = tg(to_nchw(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_nhwc(got.float()),
                                   np.asarray(ref, np.float32),
                                   rtol=2**-7, atol=1e-6)


def test_set_compute_dtype_casts_floating_parameters_only():
    """Mirrors tests/test_bf16_serving.py::test_set_compute_dtype_casts_
    float_params_only, and the codec tables stay f32."""
    from spatiotemporalentropymodel_tpu_torch.models import (
        SpatioTemporalPriorModel,
    )

    m = MeanScaleHyperprior(8, 12, device="cpu")
    stem = SpatioTemporalPriorModel(16, 12, device="cpu")
    stem.update()
    tables = {k: np.array(v.cdf) for k, v in stem.tables.items()}
    for model in (m, stem):
        model.set_compute_dtype(torch.bfloat16)
        assert {p.dtype for p in model.module.parameters()} == {torch.bfloat16}
    assert stem._medians.dtype == stem._scale_table.dtype == torch.float32
    for k, v in stem.tables.items():
        np.testing.assert_array_equal(np.array(v.cdf), tables[k])
    # inputs: floating ones to the compute dtype, integer ones as they are
    assert m._cast_in(torch.zeros(1)).dtype == torch.bfloat16
    assert m._cast_in(torch.zeros(1, dtype=torch.int32)).dtype == torch.int32
    m.set_compute_dtype(None)
    assert {p.dtype for p in m.module.parameters()} == {torch.float32}
    assert m._cast_in(torch.zeros(1)).dtype == torch.float32
