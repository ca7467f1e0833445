"""The port's joint I+P training of the ROI family (train_stem_roi) against
the JAX package's, on the CPU, with the same weights and the same fed
noise (``torch_port_util.fed_noise``: x + 0.45·sin(7x + k) in place of
each draw).

  * One ``make_joint_sequence_step`` per mode on a 2-frame sequence of
    2 × 64²: roi (stem_roi_i + stem_roi at EB 16, M 12, tamed, random
    biases; the pixelwise loss on a synthesized map) with the per-frame
    guard, baseline (MeanScaleHyperprior(16, 16) + stem_baselinev2) with
    one whole-sequence gradient. The last frame's losses within 1e-4
    relative (tests/test_torch_train_step.py's); each gradient leaf of both
    models, read from the Adam first moments the step leaves (g = μ/0.1,
    clipped), within 5e-3 of its max|g|. That file's 1e-4 does not hold
    here, and not for want of agreement: the weight gradients of the SFT
    layers and the quality-map pyramids are sums over every pixel that
    cancel to a small part of their terms, so the f32 rounding of the sum
    shows. In the roi step with the per-frame guard, measured against the
    port's own gradient in f64, the port's f32 one is off by up to 2.0e-3
    of a leaf's max|g| (qmap_feature_gs3's first kernel; torch's CPU conv
    backward) and the JAX package's by up to 2.3e-4 (qmap_feature_ga1),
    each on leaves where the other is close to the f64 one.
  * The validity flag, on the port alone: a frame whose loss passes the
    threshold adds nothing, nor does any later one.
  * ``VimeoSepTupletQMap`` gives the JAX package's frames and maps for
    the same seed; the config is the JAX package's plus ``device``
    (``train_stem_roi`` itself runs in tests/test_torch_roi_eval.py).
"""

import copy
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.data import vimeo as jvimeo
from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    StemBaselineModule as JaxBaseline,
    StemROIModule as JaxROI,
)
from spatiotemporalentropymodel_tpu.training import train_stem_roi as jtrain
from spatiotemporalentropymodel_tpu.utils import config as jconfig
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_tree, load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.data import png, qmap as pqmap
from spatiotemporalentropymodel_tpu_torch.data import vimeo as pvimeo
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior, StemBaselineModule, StemROIModule,
)
from spatiotemporalentropymodel_tpu_torch.training import (
    train_stem_roi as ptrain,
)
from spatiotemporalentropymodel_tpu_torch.utils import config as pconfig

from test_torch_train_step import (
    _close, _jax_moments, _jax_pair, _port_moments, _port_pair,
)
from torch_port_util import (  # noqa: F401 (fed_noise: a fixture)
    ROI_EBC, ROI_M, fed_noise, random_biases, tame_roi, to_nchw,
)

B, T, HW = 2, 2, 64
GRAD_TOL = 5e-3  # × max|g| of the leaf (the module's docstring)


def _modules(mode):
    """(JAX I, JAX P, port I, port P, JAX trees) of the mode, the weights
    drawn by the port."""
    g = torch.Generator().manual_seed(5)
    if mode == "roi":
        ports = (StemROIModule(ROI_EBC, ROI_M, conditional=False,
                               generator=g),
                 StemROIModule(ROI_EBC, ROI_M, generator=g))
        jaxes = (JaxROI(ROI_EBC, ROI_M, conditional=False),
                 JaxROI(ROI_EBC, ROI_M))
    else:
        ports = (MeanScaleHyperprior(16, 16, device="cpu", seed=5).module,
                 StemBaselineModule(ROI_EBC, ROI_M,
                                    separate_condition_encoder=True,
                                    generator=g))
        jaxes = (JaxMSH(16, 16).module,
                 JaxBaseline(ROI_EBC, ROI_M, separate_condition_encoder=True))
    trees = []
    for i, m in enumerate(ports):
        tree = random_biases(jax_tree(tame_roi(m)), 6 + i)
        load_jax_params(m, tree)
        trees.append(tree)
    return (*jaxes, *ports, trees)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((B, T, HW, HW, 3), dtype=np.float32)
    q = np.stack([pqmap.synthesize_qmap(HW, rng=random.Random(seed + i))
                  for i in range(B)])
    return frames, q


def _frames_nchw(frames):
    return to_nchw(frames.reshape(B * T, HW, HW, 3)).reshape(B, T, 3, HW, HW)


def _port_step(mode, guard, pi, pp, frames, q):
    """One port step on copies of the modules; returns (the two train
    states, metrics)."""
    pi, pp = copy.deepcopy(pi), copy.deepcopy(pp)
    (popt_i, pst_i), (popt_p, pst_p) = _port_pair(pi), _port_pair(pp)
    step = ptrain.make_joint_sequence_step(
        pi, pp, popt_i, popt_p, mode=mode, loss_threshold=1e9, guard=guard)
    pst_i, pst_p, metrics = step(pst_i, pst_p, _frames_nchw(frames),
                                 to_nchw(q), torch.Generator())
    return (pst_i, pst_p), metrics


def _grads_of(state):
    return {k: m / 0.1 for k, (m, _) in state.items()}


def _assert_grads_within(port, ref, tol):
    assert port.keys() == ref.keys()
    for key, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(port[key] - r).max()) <= tol * scale, key


@pytest.mark.parametrize("mode,guard", [("roi", "none"),
                                        ("baseline", "per_frame")])
def test_joint_step_matches_jax(fed_noise, mode, guard):
    """One step: the last frame's losses, and the gradients of both
    models within GRAD_TOL of each leaf's max|g|."""
    ji, jp, pi, pp, (ti, tp) = _modules(mode)
    opt_i, st_i = _jax_pair(ti)
    opt_p, st_p = _jax_pair(tp)
    frames, q = _batch()
    jstep = jax.jit(jtrain.make_joint_sequence_step(
        ji, jp, opt_i, opt_p, mode=mode, loss_threshold=1e9, guard=guard))
    st_i, st_p, metrics = jstep(st_i, st_p, jnp.asarray(frames),
                                jnp.asarray(q), jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["loss"]))
    states, pmetrics = _port_step(mode, guard, pi, pp, frames, q)
    assert metrics.keys() == pmetrics.keys()
    for k in metrics:
        _close(pmetrics[k], metrics[k])
    for jstate, pstate in zip((st_i, st_p), states):
        assert pstate.step == int(jstate.step) == 1
        _assert_grads_within(_grads_of(_port_moments(pstate)),
                             _grads_of(_jax_moments(jstate)), GRAD_TOL)


def test_a_bad_frame_breaks_the_gop(fed_noise):
    """The validity flag (the recipes share it; the baseline's modules are
    the cheaper): with the threshold above both frames' losses the step's
    gradient is the sum of theirs; between them, frame 0's alone where
    frame 0 passes, and nothing where it fails, though frame 1's loss is
    under the threshold then (the GOP is broken); below both, nothing."""
    _, _, pi, pp, _ = _modules("baseline")
    frames, q = _batch(1)
    x, qt = _frames_nchw(frames), to_nchw(q)
    losses = ptrain.run_sequence(pi, pp, x, qt, None, "baseline", 1e-2)
    l0, l1 = (float(lt["loss"].detach()) for lt in losses)
    params = [p for n, p in pi.named_parameters() if "quantiles" not in n]
    first = torch.autograd.grad(losses[0]["loss"], params,
                                retain_graph=True)
    both = torch.autograd.grad(losses[0]["loss"] + losses[1]["loss"],
                               params)
    for threshold, expect in ((2 * max(l0, l1), both),
                              ((l0 + l1) / 2, first if l0 < l1 else None),
                              (min(l0, l1) / 2, None)):
        mi, mp = copy.deepcopy(pi), copy.deepcopy(pp)
        opt_i, opt_p = (ptrain.configure_optimizers(m) for m in (mi, mp))
        step = ptrain.make_joint_sequence_step(
            mi, mp, opt_i, opt_p, mode="baseline", loss_threshold=threshold)
        _, _, metrics = step(ptrain.init_train_state(mi, opt_i),
                             ptrain.init_train_state(mp, opt_p), x, qt,
                             None)
        # the flag after the last frame, times T (the JAX package's metric)
        assert float(metrics["valid_frames"]) == (
            T if threshold > max(l0, l1) else 0)
        moments = [opt_i.main.state[p]["exp_avg"] / 0.1 for p in
                   (q for n, q in mi.named_parameters()
                    if "quantiles" not in n)]
        if expect is None:
            assert all(float(m.abs().max()) == 0 for m in moments)
        else:
            norm = float(torch.sqrt(sum((g ** 2).sum() for g in expect)))
            scale = min(1.0, 1.0 / norm)
            for m, g in zip(moments, expect):
                # per-frame gradients summed against the sum's gradient
                tol = 1e-5 * float((g * scale).abs().max())
                torch.testing.assert_close(m, g * scale, rtol=0, atol=tol)


def test_config_matches_jax():
    """TrainStemRoiConfig: the JAX package's fields and defaults, and
    ``device``."""
    jf = {f.name: f.default for f in dataclasses.fields(
        jconfig.TrainStemRoiConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(
        pconfig.TrainStemRoiConfig)}
    assert pf.pop("device") == "cuda"
    assert pf == jf
    cfg = pconfig.parse_config(pconfig.TrainStemRoiConfig,
                               ["--mode", "baseline", "--device", "cpu"])
    assert (cfg.mode, cfg.device, cfg.batch_size) == ("baseline", "cpu", 4)


@pytest.fixture(scope="module")
def vimeo_root(tmp_path_factory):
    """Two septuplets of 72 × 80 PNG frames and both list files."""
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(3)
    names = ["00001/0001", "00001/0002"]
    for name in names:
        d = root / "sequences" / name
        d.mkdir(parents=True)
        for i in range(1, 8):
            png.write_png(d / f"im{i}.png", (255 * rng.random(
                (72, 80, 3))).astype(np.uint8))
    for split in ("sep_trainlist.txt", "sep_testlist.txt"):
        (root / split).write_text("\n".join(names) + "\n")
    return str(root)


@pytest.mark.parametrize("training", [True, False])
def test_vimeo_qmap_dataset_matches_jax(vimeo_root, training):
    """The same seed gives the same crops, reversals and maps (train), or
    the centre crops and the uniform map at the level (test)."""
    jd = jvimeo.VimeoSepTupletQMap(vimeo_root, training, 64, level=30,
                                   rng=random.Random(4))
    pd = pvimeo.VimeoSepTupletQMap(vimeo_root, training, 64, level=30,
                                   rng=random.Random(4))
    for i in (0, 1, 0):
        (jf, jq), (pf, pq) = jd[i], pd[i]
        np.testing.assert_array_equal(pf, jf)
        assert pq.dtype == jq.dtype and pq.tobytes() == jq.tobytes()
        assert pf.shape == (7, 64, 64, 3) and pq.shape == (64, 64, 1)
