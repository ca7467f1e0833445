"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py). Data crosses between the two as NumPy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatiotemporalentropymodel_tpu.entropy.bottleneck as jax_eb
import spatiotemporalentropymodel_tpu.entropy.gaussian as jax_gc
import spatiotemporalentropymodel_tpu.models.priors as jax_priors
import spatiotemporalentropymodel_tpu.models.stem as jax_stem
import spatiotemporalentropymodel_tpu_torch.entropy.bottleneck as port_eb
import spatiotemporalentropymodel_tpu_torch.entropy.gaussian as port_gc
import spatiotemporalentropymodel_tpu_torch.models.priors as port_priors
import spatiotemporalentropymodel_tpu_torch.models.stem as port_stem

from spatiotemporalentropymodel_tpu.models import (
    Cheng2020Anchor as JaxAnchor,
    Cheng2020Attention as JaxAttention,
    JointAutoregressiveHierarchicalPriors as JaxJAHP,
    MeanScaleHyperprior as JaxMSH,
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_tree,
    load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (  # noqa: F401
    match_latent_to_prior,
    realistic_stem,
    tame_roi,
)
from spatiotemporalentropymodel_tpu_torch.layers import (
    Conv, Deconv, MaskedConv2d,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    Cheng2020Anchor,
    Cheng2020Attention,
    JointAutoregressiveHierarchicalPriors,
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)

# One intra-op thread: the tests run in several processes at once (pytest
# -n 6 on 8 cores), and torch's CPU pool of one thread per core then spins
# against the others' pools: one joint ROI train step at 64² took 6.2-7.4 s
# in each of six processes run at once with one thread, 351-355 s with
# eight (5.0 s alone with eight, 6.4 s with one).
torch.set_num_threads(1)

# the small slice: 64×64 frames, N = M = 64, EB 32
N = M = 64
EBC = 32
B, H, W = 2, 64, 64


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def to_nhwc(t):
    return np.moveaxis(t.detach().cpu().numpy(), 1, -1)


def pack_phase_major(y):
    """Logical NHWC (B, 2H, 2W, O) → the TPU's phase-major packed
    (B, H, W, 4O) (pallas_kernels.py::_igdn_deconv_wide_packed_ref)."""
    b, h2, w2, o = y.shape
    v = y.reshape(b, h2 // 2, 2, w2 // 2, 2, o)
    return v.transpose(0, 1, 3, 2, 4, 5).reshape(b, h2 // 2, w2 // 2, 4 * o)


def export_jax_tree(module: torch.nn.Module) -> dict:
    """The port's weights as a JAX parameter tree (the inverse of
    convert.load_jax_params)."""
    tree = {}
    for name, p in module.state_dict().items():
        parts = name.split(".")
        owner, leaf = parts[:-1], parts[-1]
        val = p.detach().cpu().numpy()
        if leaf == "weight":
            sub = module.get_submodule(".".join(owner))
            if isinstance(sub, Deconv):  # (I, O, kh, kw) → flipped HWIO
                val = np.transpose(val, (2, 3, 0, 1))[::-1, ::-1]
            elif isinstance(sub, (Conv, MaskedConv2d)):
                val = np.transpose(val, (2, 3, 1, 0))
            leaf = "kernel"
        keys, i = [], 0
        while i < len(owner):
            if owner[i] == "layers":
                keys.append(f"layers_{owner[i + 1]}")
                i += 2
            else:
                keys.append(owner[i])
                i += 1
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(val)
    return tree


def jax_tree_numpy(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def frames(seed: int, n: int):
    """n frames (B, H, W, 3) NHWC in [0, 1) and a conditioning latent."""
    rng = np.random.default_rng(seed)
    xs = [rng.random((B, H, W, 3), dtype=np.float32) for _ in range(n)]
    y_cond = (0.5 * rng.standard_normal((B, H // 16, W // 16, M))).astype(
        np.float32)
    return xs, y_cond


def build_slice(seed: int = 0, surgery: bool = True):
    """JAX and port models of the small slice with the same weights.

    The JAX models are initialised, carried into the port, given the
    benchmark workload's surgery there (realistic_stem, then
    match_latent_to_prior on the first frame) and carried back, so both
    sides code the same operating point. Returns (jax_i, jax_stem, port_i, port_stem, xs, y_cond).
    """
    xs, y_cond = frames(seed, 3)
    jax_i = JaxMSH(N, M)
    jax_i.init(jnp.asarray(xs[0]))
    jax_stem = JaxStem(variant="without_spm",
                       entropy_bottleneck_channels=EBC, in_channels=M)
    d = jnp.zeros((1, 4, 4, M))
    jax_stem.init(d, d)

    port_i = MeanScaleHyperprior(N, M, device="cpu")
    port_stem = SpatioTemporalPriorModel(
        variant="without_spm", entropy_bottleneck_channels=EBC, in_channels=M,
        device="cpu")
    load_jax_params(port_i.module, jax_tree_numpy(jax_i.params))
    load_jax_params(port_stem.module, jax_tree_numpy(jax_stem.params))
    port_stem.update()
    if surgery:
        realistic_stem(port_stem)
        match_latent_to_prior(port_i, port_stem, to_nchw(xs[0]),
                              to_nchw(y_cond))
        jax_i.params = jax.tree_util.tree_map(
            jnp.asarray, export_jax_tree(port_i.module))
        jax_stem.params = jax.tree_util.tree_map(
            jnp.asarray, export_jax_tree(port_stem.module))
    jax_stem.update(force=True)
    return jax_i, jax_stem, port_i, port_stem, xs, y_cond


# the training tests' fed noise (tests/test_torch_train_step.py): one phase
# per call site, so the SPM variants' two draws differ as real draws do; a
# low frequency, as a steep function would amplify the last-bit differences
# of the two packages' latents
NOISE_FREQ = 7.0
NOISE_SITES = {"bottleneck": (jax_eb, port_eb, 0.1),
               "gaussian": (jax_gc, port_gc, 0.7),
               "priors": (jax_priors, port_priors, 1.3),
               "stem": (jax_stem, port_stem, 2.9)}


@pytest.fixture
def fed_noise(monkeypatch):
    """Both packages' quantize_noise, in each module that imported it by
    name, replaced by x + 0.45·sin(7·x + k) with the identity's gradient."""
    for jax_mod, port_mod, k in NOISE_SITES.values():
        monkeypatch.setattr(
            jax_mod, "quantize_noise",
            lambda x, rng, k=k: x + jax.lax.stop_gradient(
                0.45 * jnp.sin(NOISE_FREQ * x + k)))
        monkeypatch.setattr(
            port_mod, "quantize_noise",
            lambda x, generator, k=k: x + (
                0.45 * torch.sin(NOISE_FREQ * x + k)).detach())


def paths(tree) -> dict:
    """{tuple of keys: NumPy leaf} of a nested dict tree (JAX params)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): np.asarray(v) for path, v in flat}


# ---- the autoregressive image models (tests/test_torch_image_ar*.py) -----

HW = 64
# name → (JAX model, port model(**kw)) at the tests' widths
AR_MODELS = {
    "mbt2018": (lambda: JaxJAHP(8, 12),
                lambda **kw: JointAutoregressiveHierarchicalPriors(
                    8, 12, device="cpu", **kw)),
    "cheng2020-anchor": (lambda: JaxAnchor(16),
                         lambda **kw: Cheng2020Anchor(16, device="cpu", **kw)),
    "cheng2020-attn": (lambda: JaxAttention(16),
                       lambda **kw: Cheng2020Attention(16, device="cpu",
                                                       **kw)),
}


def ar_image(b=1, seed=0, hw=HW):
    """(b, hw, hw, 3) NHWC in [0, 1): smooth structure plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw] / HW
    base = 0.5 + 0.3 * np.sin(6 * xx + 4 * yy)[None, :, :, None]
    return np.clip(base + 0.1 * rng.standard_normal((b, hw, hw, 3)), 0,
                   1).astype(np.float32)


def _nodes(tree):
    yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from _nodes(v)


def random_biases(tree, seed):
    """The tree (nested dicts of NumPy leaves) with N(0, 0.1) biases: the
    initialisers' zeros would hide where a bias is added."""
    rng = np.random.default_rng(seed)
    for node in _nodes(tree):
        if "bias" in node:
            node["bias"] = (0.1 * rng.standard_normal(
                node["bias"].shape)).astype(np.float32)
    return tree


def tame(tree):
    """The tree with every kernel × 0.7 and g_s's × 0.49. Cheng2020 at its
    initialisation grows without bound: y reaches 20-170 at 64², and each
    of g_s's three upsampling blocks ends in an IGDN, x·sqrt(β + γ·x²), so
    x̂ reaches 1e9 (the anchor) to 1e19 (the attention model), where no f32
    tolerance means anything, and the fed noise's sine turns the last bits
    of so large a y into likelihoods 1e-4 apart. Tamed, y stays within
    about 2.5 (anchor) and 8 (attention) and x̂ within about 7."""
    for key, sub in tree.items():
        scale = np.float32(0.49 if key == "g_s" else 0.7)
        for node in _nodes(sub) if isinstance(sub, dict) else ():
            if "kernel" in node:
                node["kernel"] = node["kernel"] * scale
    return tree


def bridge_ar(name, seed=0, **kw):
    """The port's model from its seed with random biases (the Cheng2020
    models tamed) and the JAX model with its weights (convert.jax_tree: a
    JAX init costs 5-25 s here), both with their tables."""
    pm = AR_MODELS[name][1](seed=seed, **kw)
    tree = random_biases(jax_tree(pm.module), seed)
    if name.startswith("cheng"):
        tree = tame(tree)
    load_jax_params(pm.module, tree)
    pm.update()
    jm = AR_MODELS[name][0]()
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm.update()
    return jm, pm


# ---- the ROI family (tests/test_torch_roi*.py) ---------------------------

ROI_EBC, ROI_M, ROI_HW = 16, 12, 64
# model name → (JAX class, port class), the zoo's names
ROI_MODELS = {
    "stem_baseline": ("StemBaseline", "StemBaseline"),
    "stem_baselinev2": ("StemBaselineV2", "StemBaselineV2"),
    "stem_roi": ("StemROI", "StemROI"),
    "stem_roi_wo_gsc": ("StemROIWoGsc", "StemROIWoGsc"),
    "stem_roi_i": ("StemROI_I", "StemROI_I"),
}


def bridge_roi(name, seed=1):
    """The port's ROI-family model from its seed, tamed, with random biases,
    and the JAX model with its weights, both with their tables."""
    import spatiotemporalentropymodel_tpu.models as jmodels
    import spatiotemporalentropymodel_tpu_torch.models as pmodels

    jcls, pcls = ROI_MODELS[name]
    kw = dict(entropy_bottleneck_channels=ROI_EBC, in_channels=ROI_M)
    pm = getattr(pmodels, pcls)(device="cpu", seed=seed, **kw)
    tree = random_biases(jax_tree(tame_roi(pm.module)), seed)
    load_jax_params(pm.module, tree)
    pm.update()
    jm = getattr(jmodels, jcls)(**kw)
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jm.update()
    return jm, pm


def roi_args(name, seed=0, hw=ROI_HW, b=1):
    """The model's NHWC inputs: (x_cur, x_conditioned, qmap) for the ROI
    P-models, (x_cur, qmap) for stem_roi_i, (x_cur, x_conditioned) for the
    baselines; frames in [0, 1), the conditioning frame x_cur plus noise,
    the map uniform in [0, 1). ``hw``: a side, or (H, W)."""
    rng = np.random.default_rng(seed)
    h, w = (hw, hw) if np.isscalar(hw) else hw
    x = rng.random((b, h, w, 3), dtype=np.float32)
    xc = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    q = rng.random((b, h, w, 1), dtype=np.float32)
    if name == "stem_roi_i":
        return x, q
    return (x, xc, q) if name.startswith("stem_roi") else (x, xc)
