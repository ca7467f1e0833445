"""The res AR codec at bf16: both packages after ``set_compute_dtype(bf16)``
on the same bridged weights, with nonzero biases (the JAX initialiser's
zeros would hide where a bias is added), on the CPU.

Where the two round must agree. Every elementwise step rounds at the same
points in both packages, so it gives the same bits. A product (a conv, the
masked conv's centre, EPM's rows) sums in another order than XLA's, so its
f32 sum may differ in the last bits and its bf16 output then moves by one
ulp: at under 1e-4 of the outputs of one layer fed the JAX layer's input,
and at up to 6e-3 of μ after the centre and EPM's three products chained
(six seeds of these data). A rounding point moved (a bias added inside the
product's f32 sum, an f32 slope where JAX multiplies by bf16(0.01)) moves a
quarter of a layer's outputs and a third of μ or more.

Why the decoded ŷ is not held element by element on the untiled plane. A
μ one ulp off changes the context of every later pixel of its tile, and so
their μ, in the last bits; on an 8×8 plane that reaches most of it, and
where a centre lies near a .5 boundary its symbol rounds the other way.
With (1, 4) tiles it stays within four pixels. So the AR rounds are held
with the JAX encoder's plane and priors fed to the port's (teacher
forcing); the codecs themselves are held to the same ẑ stream, the rate
within tests/test_torch_bf16_pipeline.py's 2 %, the quantizer's half step
on both schedules, and with (1, 4) tiles to ŷ within one step of JAX's and
within Y_MEAN on average (up to 2.4e-3 in six seeds; 8.5e-3 and more
with a rounding point moved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.models import (
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu.models import ar_wavefront as jwf
from spatiotemporalentropymodel_tpu_torch.convert import load_jax_params
from spatiotemporalentropymodel_tpu_torch.layers import LeakyReLU
from spatiotemporalentropymodel_tpu_torch.models import (
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.models import ar_wavefront as wf

from torch_port_util import jax_tree_numpy, to_nchw, to_nhwc

M, EBC, B, HW = 24, 32, 2, 8
TILES = [None, (1, 4)]
LAYER_FLIPS = 1e-3  # share of one product's outputs one ulp off
MU_FLIPS = 2e-2  # μ after the centre's product and EPM's three, chained
SYM_FLIPS = 1e-3  # symbols and CDF rows, which only a flip near an edge moves
RATE_RTOL = 2e-2  # tests/test_torch_bf16_pipeline.py's BPP_RTOL
Y_MEAN = 5e-3  # mean |Δŷ| with (1, 4) tiles


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _assert_close_bits(got, ref, flips, what):
    """got equals ref bit for bit but at ≤ ``flips`` of the elements, and
    is off there by no more than one bf16 ulp at ref's largest magnitude
    (the sum before a bias may be larger than the output after it)."""
    diff = got != ref
    assert diff.mean() <= flips, f"{what}: {diff.mean():.2e} differ"
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max(), what


@pytest.fixture(scope="module")
def bridged():
    """The JAX res model with random biases, the port with its weights,
    both at bf16, and latents (y_cur, y_cond) NHWC f32."""
    rng = np.random.default_rng(0)
    y_cur = rng.standard_normal((B, HW, HW, M)).astype(np.float32)
    y_cond = (y_cur + 0.3 * rng.standard_normal(y_cur.shape)).astype(
        np.float32)
    jm = JaxStem(variant="res", entropy_bottleneck_channels=EBC,
                 in_channels=M)
    d = jnp.zeros((1, 4, 4, M))
    jm.init(d, d)
    brng = np.random.default_rng(7)

    def with_bias(path, p):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return jnp.asarray(0.1 * brng.standard_normal(p.shape), p.dtype)
        return p

    jm.params = jax.tree_util.tree_map_with_path(with_bias, jm.params)
    jm.update()
    pm = SpatioTemporalPriorModel(variant="res",
                                  entropy_bottleneck_channels=EBC,
                                  in_channels=M, device="cpu")
    load_jax_params(pm.module, jax_tree_numpy(jm.params))
    pm.update()
    jm.set_compute_dtype(jnp.bfloat16)
    pm.set_compute_dtype(torch.bfloat16)
    return jm, pm, y_cur, y_cond


def _jax_layer_outputs(jm, net, x):
    def run(mdl, x, train=False):
        outs = []
        for layer in getattr(mdl, net).layers:
            x = layer(x)
            outs.append(x)
        return outs

    return [np.asarray(o.astype(jnp.float32))
            for o in jm._apply(jnp.asarray(x), method=run)]


@pytest.mark.parametrize("net", ["HE", "HD", "TPM", "EPM"])
def test_bf16_layers_round_like_jax(net, bridged):
    """Each layer of the net, fed the JAX layer's input: LeakyReLU gives
    JAX's bits, each conv its bits but at ≤ LAYER_FLIPS of the outputs."""
    jm, pm, y_cur, y_cond = bridged
    rng = np.random.default_rng(1)
    x = {"HE": np.concatenate([y_cur, y_cond], -1),
         "HD": np.round(rng.standard_normal((B, HW // 4, HW // 4, EBC))),
         "TPM": y_cond,
         "EPM": rng.standard_normal((B, HW, HW, 6 * M))}[net]
    x = _bf16(x.astype(np.float32))
    outs = _jax_layer_outputs(jm, net, x)
    with torch.no_grad():
        for layer, inp, ref in zip(getattr(pm.module, net).layers,
                                   [x] + outs[:-1], outs):
            got = to_nhwc(layer(to_nchw(inp).bfloat16()).float())
            if isinstance(layer, LeakyReLU):
                np.testing.assert_array_equal(got, ref)
            else:
                _assert_close_bits(got, ref, LAYER_FLIPS,
                                   f"{net} {type(layer).__name__}")


def test_bf16_masked_conv_rounds_like_jax(bridged):
    """The masked conv's centre (the AR entry) and its full plane."""
    jm, pm, _, _ = bridged
    crops = _bf16(np.random.default_rng(2).standard_normal(
        (64, 5, 5, M)).astype(np.float32))

    def ctx(mdl, c, train=False):
        return mdl.context_prediction(c)

    ref = np.asarray(jm._apply(jnp.asarray(crops), method=ctx).astype(
        jnp.float32))
    cp = pm.module.context_prediction
    with torch.no_grad():
        x = to_nchw(crops).bfloat16()
        full = to_nhwc(cp(x).float())
        centre = cp.center(cp.causal_taps(x)).float().numpy()
    _assert_close_bits(full, ref, LAYER_FLIPS, "masked conv")
    _assert_close_bits(centre, ref[:, 2, 2, :], LAYER_FLIPS, "centre")


@pytest.fixture(scope="module")
def jax_encode(bridged):
    """tile → the JAX wavefront encoder's (priors, target, symbols, CDF
    rows, plane) as tile batches, on the port's ẑ."""
    jm, pm, y_cur, y_cond = bridged
    cache = {}

    def get(tile):
        if tile not in cache:
            jm.wavefront_tile = tile
            pm.wavefront_tile = tile
            _, z_hat = pm._code_z(to_nchw(y_cur), to_nchw(y_cond))
            priors = jm._prior_feats_fn()(jnp.asarray(to_nhwc(z_hat)),
                                          jnp.asarray(y_cond))
            target = jnp.asarray(y_cur - y_cond)
            th, tw, nt = pm._tile_dims(HW, HW)
            if nt > 1:
                priors = jwf.tile_plane(priors, th, tw)
                target = jwf.tile_plane(target, th, tw)
            coords, valid, encoder, *_ = jm._wavefront_setup(th, tw)
            syms, idxs, plane = encoder(target, priors, coords, valid)
            cache[tile] = (np.array(priors.astype(jnp.float32)),
                           np.array(target), np.array(syms), np.array(idxs),
                           np.array(plane))
        return cache[tile]

    return get


@pytest.mark.parametrize("tile", TILES)
def test_bf16_ar_rounds_match_jax(tile, jax_encode, bridged):
    """Teacher forcing: each of the port's rounds on the JAX encoder's
    plane and priors gives the JAX encoder's μ (its plane less its symbol),
    CDF rows and symbols, within the bounds above. σ meets the table cast
    to bf16, the symbol is round(f32 centre − μ)."""
    _, pm, _, _ = bridged
    priors, target, j_sym, j_idx, j_plane = jax_encode(tile)
    j_mu = j_plane - j_sym.astype(np.float32)
    th, tw = j_plane.shape[1:3]
    _, _, rounds, *_ = pm._wavefront_setup(th, tw)
    plane = torch.nn.functional.pad(torch.from_numpy(j_plane),
                                    (0, 0, 2, 2, 2, 2))
    priors = torch.from_numpy(priors).bfloat16()
    target = torch.from_numpy(target)
    mu, idx, sym = (np.zeros_like(a) for a in (j_mu, j_idx, j_sym))
    n = plane.shape[0]
    with torch.no_grad():
        for rnd in rounds:
            means, rows = wf._params(pm._ar_step, pm._scale_table, plane,
                                     priors, rnd)
            means = means.float().view(n, -1, M)
            centre = target[:, rnd.h, rnd.w, :]
            hh, ww = rnd.h.numpy(), rnd.w.numpy()
            mu[:, hh, ww] = means.numpy()
            idx[:, hh, ww] = rows.view(n, -1, M).numpy()
            sym[:, hh, ww] = torch.round(centre - means).numpy()
    _assert_close_bits(mu, j_mu, MU_FLIPS, "μ")
    assert (idx != j_idx).mean() <= SYM_FLIPS
    assert (sym != j_sym).mean() <= SYM_FLIPS


@pytest.mark.parametrize("tile", TILES)
def test_bf16_codec_matches_jax(tile, bridged):
    """Both packages' bf16 codecs on the same latents: the same ẑ stream;
    y streams of the same size within RATE_RTOL; ŷ within the quantizer's
    half step of the latent; with (1, 4) tiles, ŷ within one step of
    JAX's everywhere and Y_MEAN on average."""
    jm, pm, y_cur, y_cond = bridged
    jm.wavefront_tile = pm.wavefront_tile = tile
    jenc = jm.compress(jnp.asarray(y_cur), jnp.asarray(y_cond))
    jhat = np.asarray(jm.decompress(jenc["strings"], jenc["shape"],
                                    jnp.asarray(y_cond))["y_hat"], np.float32)
    penc = pm.compress(to_nchw(y_cur), to_nchw(y_cond))
    phat = to_nhwc(pm.decompress(penc["strings"], penc["shape"],
                                 to_nchw(y_cond))["y_hat"])
    assert penc["strings"][1] == jenc["strings"][1]
    size = [sum(len(s) for s in e["strings"][0]) for e in (penc, jenc)]
    np.testing.assert_allclose(size[0], size[1], rtol=RATE_RTOL)
    for y_hat in (phat, jhat):
        assert np.abs(y_hat - y_cur).max() <= 0.5 + 1e-5
    if tile is not None:
        dy = np.abs(phat - jhat)
        assert dy.max() <= 1 + 1e-4 and dy.mean() <= Y_MEAN
        for a, b in zip(penc["strings"][0], jenc["strings"][0]):
            np.testing.assert_allclose(len(a), len(b), rtol=RATE_RTOL)
