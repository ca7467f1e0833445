"""The port's charm (models/charm.py), the channel-autoregressive STEM,
against the JAX package's on the CPU, with the JAX weights carried across.

JAX tests/test_charm.py's size: M 16, EB 16, G 4, 8×8 latents, f32, and G 3
(M 12) with LRP and the residual off. The port's weights from its seed,
with N(0, 0.1) biases (the initialiser's zeros would hide where a bias is
added), go to the JAX model through the bridge. Forward ŷ within 1e-5 and
the likelihoods within rtol 1e-4 (atol 1e-6, as tests/test_torch_forward.py
holds them); compress strings and counts byte for byte in both transports;
each decode's ŷ within 1e-5 of the JAX decode of the same strings (a
differing symbol would move it by a whole step); the overflow fallback to
dense, the fetch-free decode through the NumPy coder, a bf16 round trip,
and the port's copies of the JAX package's own charm tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu import zoo as jax_zoo
from spatiotemporalentropymodel_tpu.eval import video_codec as jvc
from spatiotemporalentropymodel_tpu.models import (
    SpatioTemporalPriorModelChannelAR as JaxCharm,
)
from spatiotemporalentropymodel_tpu_torch import zoo
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_tree, load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.entropy.base import (
    unpack_symbol_buffer,
)
from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
from spatiotemporalentropymodel_tpu_torch.models import (
    ChannelARSTEMModule,
    SpatioTemporalPriorModelChannelAR,
)

from torch_port_util import random_biases, to_nchw, to_nhwc

EBC, HW = 16, 8
# name → (groups, in_channels, lrp, residual)
CONFIGS = {"g4": (4, 16, True, True), "g3_plain": (3, 12, False, False)}
F32_ATOL = 1e-5
LK_RTOL, LK_ATOL = 1e-4, 1e-6


def _port(name, seed=1, scale=None, **kw):
    groups, m, lrp, residual = CONFIGS[name]
    pm = SpatioTemporalPriorModelChannelAR(
        groups=groups, entropy_bottleneck_channels=EBC, in_channels=m,
        residual=residual, lrp=lrp, device="cpu", seed=seed, **kw)
    tree = random_biases(jax_tree(pm.module), seed)
    if scale is not None:  # toward zero: a converged model's sparse regime
        tree = jax.tree_util.tree_map(lambda p: p * np.float32(scale), tree)
    load_jax_params(pm.module, tree)
    pm.update()
    return pm, tree


def _pair(name, seed=1, scale=None):
    """The port's model and the JAX model with its weights, both with
    their tables."""
    pm, tree = _port(name, seed, scale)
    groups, m, lrp, residual = CONFIGS[name]
    jm = JaxCharm(groups=groups, entropy_bottleneck_channels=EBC,
                  in_channels=m, residual=residual, lrp=lrp)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm.update()
    return jm, pm


def _latents(name, seed=0, b=1):
    """(y_cur, y_cond) NHWC: y_cond N(0, 1); y_cur y_cond + 0.3·ε, or 0.3·ε
    where the model codes y_cur itself (no residual), so that the scaled
    models code mostly zeros either way."""
    rng = np.random.default_rng(seed)
    m, residual = CONFIGS[name][1], CONFIGS[name][3]
    y_cond = rng.standard_normal((b, HW, HW, m)).astype(np.float32)
    eps = 0.3 * rng.standard_normal(y_cond.shape)
    y_cur = (y_cond + eps if residual else eps).astype(np.float32)
    return y_cur, y_cond


@pytest.fixture(scope="module")
def pairs():
    return {(name, scale): _pair(name, scale=scale)
            for name in CONFIGS for scale in (None, 0.01)}


# ---- against the JAX package -----------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(pairs, name):
    jm, pm = pairs[(name, None)]
    y_cur, y_cond = _latents(name)
    want = jm.forward(jnp.asarray(y_cur), jnp.asarray(y_cond))
    got = pm.forward(to_nchw(y_cur), to_nchw(y_cond))
    np.testing.assert_allclose(to_nhwc(got["y_hat"]),
                               np.asarray(want["y_hat"]), atol=F32_ATOL)
    for key in ("y", "z"):
        np.testing.assert_allclose(to_nhwc(got["likelihoods"][key]),
                                   np.asarray(want["likelihoods"][key]),
                                   rtol=LK_RTOL, atol=LK_ATOL)


def _compress_both(jm, pm, y_cur, y_cond, mode):
    want = jm.compress(jnp.asarray(y_cur), jnp.asarray(y_cond),
                       transport_mode=mode)
    got = pm.compress(to_nchw(y_cur), to_nchw(y_cond), transport_mode=mode)
    return got, want


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_compress_streams_and_counts_match_jax(pairs, name, mode):
    """The scaled weights' frames ship sparse; the unscaled ones overflow
    int8 and fall back to dense: the same bytes either way."""
    for scale, want_transport in ((0.01, mode), (None, "dense")):
        jm, pm = pairs[(name, scale)]
        y_cur, y_cond = _latents(name, seed=2)
        got, want = _compress_both(jm, pm, y_cur, y_cond, mode)
        assert got["transport"] == want["transport"] == want_transport
        assert got["shape"] == want["shape"] == (HW // 4, HW // 4)
        assert got["strings"] == want["strings"]
        assert len(got["strings"][0][0]) == CONFIGS[name][0]
        if want_transport == "sparse":
            np.testing.assert_array_equal(got["counts"], want["counts"])
            assert got["counts"].shape == (1, CONFIGS[name][0], 64)
        else:
            assert "counts" not in got


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("decode", ["fetchfree", "per_group", "dense"])
def test_decompress_matches_jax(pairs, name, decode):
    """The port's decode of the JAX package's strings against the JAX
    decode of the same strings, with each of the three decodes, two
    elements a batch."""
    jm, pm = pairs[(name, 0.01)]
    y_cur, y_cond = _latents(name, seed=3, b=2)
    mode = "dense" if decode == "dense" else "sparse"
    want = jm.compress(jnp.asarray(y_cur), jnp.asarray(y_cond),
                       transport_mode=mode)
    assert want["transport"] == mode
    counts = want.get("counts") if decode == "fetchfree" else None
    ref = jm.decompress(want["strings"], want["shape"], jnp.asarray(y_cond),
                        transport_mode=mode, counts=counts)["y_hat"]
    got = pm.decompress(want["strings"], want["shape"], to_nchw(y_cond),
                        transport_mode=mode, counts=counts)["y_hat"]
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=F32_ATOL)


def test_overflow_falls_back_to_dense_in_both(pairs):
    """A target 300 away from its mean at one element (|symbol| > 127)
    sends the sparse request dense in both packages, with the same
    bytes."""
    jm, pm = pairs[("g4", 0.01)]
    y_cur, y_cond = _latents("g4", seed=4)
    y_cur[0, 3, 5, 7] += 300.0
    got, want = _compress_both(jm, pm, y_cur, y_cond, "sparse")
    assert got["transport"] == want["transport"] == "dense"
    assert got["strings"] == want["strings"]
    dec = pm.decompress(got["strings"], got["shape"], to_nchw(y_cond),
                        transport_mode="dense")["y_hat"]
    assert abs(float(to_nhwc(dec)[0, 3, 5, 7] - y_cur[0, 3, 5, 7])) <= 1.0


def test_fetchfree_decode_through_the_numpy_coder(pairs):
    """The NumPy coder has no run-based path: its sparse streams go
    through the indexed coder (rows from the counts), the JAX package's
    bytes, and the fetch-free decode falls back to decode_grouped +
    pack_decode_payload; ŷ equals the native coder's."""
    _, pm = pairs[("g4", 0.01)]
    npm, tree = _port("g4", scale=0.01, entropy_coder="numpy")
    jm = JaxCharm(groups=4, entropy_bottleneck_channels=EBC, in_channels=16,
                  entropy_coder="numpy")
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm.update()
    y_cur, y_cond = _latents("g4", seed=5)
    got, want = _compress_both(jm, npm, y_cur, y_cond, "sparse")
    assert got["transport"] == "sparse" and got["strings"] == want["strings"]
    native = pm.compress(to_nchw(y_cur), to_nchw(y_cond))
    assert native["strings"][0] != got["strings"][0]  # another container
    y_hat = npm.decompress(got["strings"], got["shape"], to_nchw(y_cond),
                           counts=got["counts"])["y_hat"]
    ref = pm.decompress(native["strings"], native["shape"], to_nchw(y_cond),
                        counts=native["counts"])["y_hat"]
    assert torch.equal(y_hat, ref)


def test_zoo_builds_stpm_charm_with_the_jax_hash():
    """zoo.stem_models["stpm_charm"] builds the JAX package's type, and
    params_hash of the bridged weights equals the JAX model's, in f32 and
    after set_compute_dtype(bf16) on both."""
    pm = zoo.stem_models["stpm_charm"](
        entropy_bottleneck_channels=EBC, in_channels=16, device="cpu")
    jm = jax_zoo.stem_models["stpm_charm"](entropy_bottleneck_channels=EBC,
                                           in_channels=16)
    assert type(pm).__name__ == type(jm).__name__
    jm.params = jax.tree_util.tree_map(jnp.asarray, jax_tree(pm.module))
    assert vc.params_hash(pm) == jvc.params_hash(jm)
    pm.set_compute_dtype(torch.bfloat16)
    jm.set_compute_dtype(jnp.bfloat16)
    assert vc.params_hash(pm) == jvc.params_hash(jm)


def test_bf16_round_trip_stays_near_f32(pairs):
    """set_compute_dtype(bf16): the three decodes give the same ŷ bit for
    bit, the encoder's carry equals it, and it stays within 0.25 on
    average of the f32 ŷ (JAX tests/test_bf16_serving.py:96)."""
    _, f32 = pairs[("g4", 0.01)]
    pm, _ = _port("g4", scale=0.01)
    pm.set_compute_dtype(torch.bfloat16)
    y_cur, y_cond = [to_nchw(a) for a in _latents("g4", seed=6)]
    ref = f32.decompress(**_dec_args(f32.compress(y_cur, y_cond), y_cond))
    enc = pm.compress(y_cur, y_cond)
    assert enc["transport"] == "sparse"
    outs = [pm.decompress(enc["strings"], enc["shape"], y_cond,
                          counts=enc["counts"])["y_hat"],
            pm.decompress(enc["strings"], enc["shape"], y_cond)["y_hat"]]
    dense = pm.compress(y_cur, y_cond, transport_mode="dense")
    outs.append(pm.decompress(**_dec_args(dense, y_cond))["y_hat"])
    _, carry = pm.fused_encode_sparse_carry_expr(y_cur, y_cond)
    for out in outs[1:] + [carry]:
        assert torch.equal(out, outs[0])
    assert outs[0].dtype == torch.float32
    assert float((outs[0] - ref["y_hat"]).abs().mean()) <= 0.25


def _dec_args(enc, y_cond):
    return dict(strings=enc["strings"], shape=enc["shape"],
                y_conditioned=y_cond, transport_mode=enc["transport"],
                counts=enc.get("counts"))


# ---- the port alone: copies of JAX tests/test_charm.py ----------------------

@pytest.fixture(scope="module")
def model():
    pm, _ = _port("g4")
    return pm


def _t(name="g4", **kw):
    return [to_nchw(a) for a in _latents(name, **kw)]


def test_contract(model):
    y_cur, y_cond = _t()
    out = model.forward(y_cur, y_cond)
    assert out["y_hat"].shape == y_cur.shape
    lk = out["likelihoods"]["y"]
    assert lk.shape == y_cur.shape
    assert bool((lk > 0).all()) and bool((lk <= 1).all())


def test_train_noise(model):
    """U(-½, ½) noise plus the LRP refinement's bound (0.5·tanh)."""
    y_cur, y_cond = _t()
    gen = torch.Generator().manual_seed(0)
    out = model.forward(y_cur, y_cond, train=True, generator=gen)
    assert float((out["y_hat"] - y_cur).detach().abs().max()) <= 1.0 + 1e-5


def test_channel_context_matters(model):
    """Moving group 0's input changes the later groups' likelihoods."""
    y_cur, y_cond = _t()
    base = model.forward(y_cur, y_cond)["likelihoods"]["y"]
    y_pert = y_cur.clone()
    y_pert[:, :4] += 3.0
    pert = model.forward(y_pert, y_cond)["likelihoods"]["y"]
    assert not torch.allclose(base[:, 4:], pert[:, 4:])


def test_aux_loss(model):
    assert float(model.aux_loss().detach()) > 0


def test_roundtrip_lossless(model):
    """Two elements, G streams each; the decoder rebuilds the encoder's
    own group recursion, recomputed here from the dense encode's symbols
    with the module's group functions."""
    y_cur, y_cond = _t(b=2)
    enc = model.compress(y_cur, y_cond)
    assert len(enc["strings"][0]) == 2 and len(enc["strings"][0][0]) == 4
    dec = model.decompress(**_dec_args(enc, y_cond))
    b, m, h, w = y_cur.shape
    zt = model.tables["entropy_bottleneck"]
    packed, _ = model.fused_encode_carry_expr(y_cur, y_cond)
    y_sym, z_sym, _ = unpack_symbol_buffer(
        packed.numpy(), (b, h, w, m), (b, h // 4, w // 4, zt.rows))
    mod = model.module
    with torch.no_grad():
        priors = mod.priors(to_nchw(z_sym.astype(np.float32))
                            + model._medians, y_cond)
        decoded = []
        for g in range(4):
            ctx = torch.cat(decoded, dim=1) if decoded else None
            _, means = mod.group_params(priors, ctx, g)
            sym = to_nchw(y_sym[..., 4 * g:4 * g + 4].astype(np.float32))
            decoded.append(mod.lrp_refine(priors, ctx, sym + means, g))
        expected = torch.cat(decoded, dim=1) + y_cond
    torch.testing.assert_close(dec["y_hat"], expected, atol=1e-5, rtol=0)


def test_forward_matches_serving_reconstruction(model):
    """The eval forward quantizes the context as the coder does, so its ŷ
    equals decompress's bit for bit."""
    y_cur, y_cond = _t(seed=3)
    out = model.forward(y_cur, y_cond)
    enc = model.compress(y_cur, y_cond)
    dec = model.decompress(**_dec_args(enc, y_cond))
    assert torch.equal(out["y_hat"], dec["y_hat"])


def test_bitstream_deterministic(model):
    y_cur, y_cond = _t()
    assert model.compress(y_cur, y_cond)["strings"] == model.compress(
        y_cur, y_cond)["strings"]


def test_sparse_and_dense_transports_agree(pairs):
    _, pm = pairs[("g4", 0.01)]
    y_cur, y_cond = _t(seed=5)
    dec_d = pm.decompress(**_dec_args(
        pm.compress(y_cur, y_cond, transport_mode="dense"), y_cond))
    enc_s = pm.compress(y_cur, y_cond, transport_mode="sparse")
    assert enc_s["transport"] == "sparse"
    dec_s = pm.decompress(enc_s["strings"], enc_s["shape"], y_cond)
    torch.testing.assert_close(dec_s["y_hat"], dec_d["y_hat"], atol=1e-5,
                               rtol=0)
    dec_f = pm.decompress(**_dec_args(enc_s, y_cond))
    assert torch.equal(dec_f["y_hat"], dec_s["y_hat"])


def test_lrp_refinement_bounded_and_live(model):
    """LRP moves group 0's reconstruction (its context is empty, so it
    codes the same symbols without LRP), by at most half a bin."""
    y_cur, y_cond = _t(seed=9)
    base = SpatioTemporalPriorModelChannelAR(
        groups=4, entropy_bottleneck_channels=EBC, in_channels=16,
        lrp=False, device="cpu")
    own = model.module.state_dict()
    base.module.load_state_dict({k: own[k]
                                 for k in base.module.state_dict()})
    base.update()
    dec = model.decompress(**_dec_args(model.compress(y_cur, y_cond),
                                       y_cond))
    dec_b = base.decompress(**_dec_args(base.compress(y_cur, y_cond),
                                        y_cond))
    d = (dec["y_hat"] - dec_b["y_hat"])[:, :4].abs()
    assert float(d.max()) <= 0.5 + 1e-5
    assert float(d.max()) > 0


def test_lrp_off_module_has_no_lrp_params():
    module = ChannelARSTEMModule(4, EBC, 16, lrp=False)
    assert not any(k.startswith("LRP") for k in module.state_dict())
    assert sorted({k.split(".")[0] for k in module.state_dict()}) == [
        "EPM_0", "EPM_1", "EPM_2", "EPM_3", "HD", "HE", "TPM",
        "entropy_bottleneck"]
    pm, _ = _port("g3_plain")
    y_cur, y_cond = _t("g3_plain")
    dec = pm.decompress(**_dec_args(pm.compress(y_cur, y_cond), y_cond))
    assert bool(torch.isfinite(dec["y_hat"]).all())


def test_other_group_counts_roundtrip():
    """G = 8: one stream per group, the decodes with and without the
    counts equal."""
    pm = SpatioTemporalPriorModelChannelAR(
        groups=8, entropy_bottleneck_channels=EBC, in_channels=16,
        device="cpu", seed=13)
    with torch.no_grad():
        for p in pm.module.parameters():
            p.mul_(0.01)
    pm.update()
    y_cur, y_cond = _t(seed=13)
    assert pm.forward(y_cur, y_cond)["likelihoods"]["y"].shape == \
        y_cur.shape
    enc = pm.compress(y_cur, y_cond)
    assert len(enc["strings"][0][0]) == 8
    dec = pm.decompress(**_dec_args(enc, y_cond))
    dec2 = pm.decompress(enc["strings"], enc["shape"], y_cond,
                         transport_mode=enc["transport"])
    assert torch.equal(dec["y_hat"], dec2["y_hat"])


def test_latent_sides_must_be_multiples_of_4(model):
    """The JAX package rebuilds the latent as 4× ẑ (and its dense path
    floors ẑ's shape), so a 6×8 latent cannot round-trip there; the port
    says so before coding."""
    y_cur, y_cond = _t()
    with pytest.raises(ValueError, match="multiples of 4"):
        model.compress(y_cur[:, :, :6], y_cond[:, :, :6])
    enc = model.compress(y_cur, y_cond)
    with pytest.raises(ValueError, match="y_conditioned"):
        model.decompress(enc["strings"], enc["shape"], y_cond[:, :, :4])
