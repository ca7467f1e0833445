"""The port's GOP evaluation (eval/eval_stem.py), its CLI and
``EvalStemConfig``, and a charm train step, against the JAX package's on
the CPU.

A charm (G 4, EB 16, M 16; the port's seeded weights × 0.02) behind a
MeanScaleHyperprior(8, 16) (seeded, × 0.05) through
``eval_sequence`` on a 3-frame GOP of 64² frames: with the coder, the bpp
(the counts the container carries included) equals the JAX figure exactly
and PSNR is within 1e-4 dB, the log file's lines carry the same frame
kinds and bpp; with ``entropy_estimation=True``, bpp within rtol 1e-4.
``main`` on a folder of PNGs with the hero I checkpoint and a STEM
checkpoint written by the JAX package, with ``--out-json``, gives the JAX
``main``'s averages. One ``train_stem`` step with a charm ``module=``, from
the JAX trainer's own initialisation and with the fed noise of
tests/test_torch_train_step.py, gives the JAX loss within rtol 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval import eval_stem as jax_eval_stem
from spatiotemporalentropymodel_tpu.models import (
    ChannelARSTEMModule as JaxCharmModule,
    MeanScaleHyperprior as JaxMSH,
    SpatioTemporalPriorModel as JaxStem,
    SpatioTemporalPriorModelChannelAR as JaxCharm,
)
from spatiotemporalentropymodel_tpu.training.checkpoints import (
    save_checkpoint as jax_save_checkpoint,
)
from spatiotemporalentropymodel_tpu.training.train_stem import (
    train_stem as jax_train_stem,
)
from spatiotemporalentropymodel_tpu.utils import config as jax_config
from spatiotemporalentropymodel_tpu_torch.convert import (
    jax_tree, load_jax_params,
)
from spatiotemporalentropymodel_tpu_torch.data import ArraySequence
from spatiotemporalentropymodel_tpu_torch.data.png import write_png
from spatiotemporalentropymodel_tpu_torch.eval import eval_stem
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    HERO_DIR,
    hero_gop_set,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    ChannelARSTEMModule,
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
    SpatioTemporalPriorModelChannelAR,
)
from spatiotemporalentropymodel_tpu_torch.training.train_stem import (
    train_stem,
)
from spatiotemporalentropymodel_tpu_torch.utils import config as port_config

from torch_port_util import (  # noqa: F401 (fed_noise: a fixture)
    export_jax_tree, fed_noise,
)

M = EBC = 16
PSNR_DB = 1e-4
EST_RTOL = 1e-4


def _sequence():
    """3 frames of 64² (the hero eval set's first, cropped), GOP 3."""
    frames = [f[:64, :64] for f in hero_gop_set(1, 3)[0].frames]
    return ArraySequence(frames, 3, "seq")


@pytest.fixture(scope="module")
def charm_pair():
    """((JAX MSH, JAX charm), (port MSH, port charm)), same weights, all
    drawn by the port (a JAX init costs seconds here)."""
    p_i = MeanScaleHyperprior(8, M, device="cpu", seed=4)
    with torch.no_grad():
        for p in p_i.module.parameters():
            p.mul_(0.05)
    p_i.update()
    j_i = JaxMSH(8, M)
    j_i.params = jax.tree_util.tree_map(jnp.asarray, jax_tree(p_i.module))
    j_i.update()
    p_s = SpatioTemporalPriorModelChannelAR(
        groups=4, entropy_bottleneck_channels=EBC, in_channels=M,
        device="cpu", seed=5)
    with torch.no_grad():
        for p in p_s.module.parameters():
            p.mul_(0.02)
    p_s.update()
    j_s = JaxCharm(groups=4, entropy_bottleneck_channels=EBC, in_channels=M)
    j_s.params = jax.tree_util.tree_map(jnp.asarray, jax_tree(p_s.module))
    j_s.update()
    return (j_i, j_s), (p_i, p_s)


def test_charm_eval_sequence_matches_jax(charm_pair, tmp_path):
    (j_i, j_s), (p_i, p_s) = charm_pair
    logs = tmp_path / "port.log", tmp_path / "jax.log"
    got = eval_stem.eval_sequence(p_i, p_s, _sequence(), False, False,
                                  str(logs[0]))
    want = jax_eval_stem.eval_sequence(j_i, j_s, _sequence(), False, False,
                                       str(logs[1]))
    assert got["frames"] == want["frames"] == 3
    assert got["bpp"] == want["bpp"]
    assert got["psnr"] == pytest.approx(want["psnr"], abs=PSNR_DB)
    assert got["bpp_est"] == pytest.approx(want["bpp_est"], rel=EST_RTOL)
    # the P-frames' bpp holds the charm counts: the strings alone are less
    enc = p_s.compress(*_p_latents(p_i, p_s))
    assert enc["transport"] == "sparse"
    ours, theirs = (p.read_text().splitlines() for p in logs)
    assert [line.split()[:2] for line in ours] == [
        line.split()[:2] for line in theirs] == [["0001", "I"], ["0002",
                                                                "P"],
                                                 ["0003", "P"]]
    assert [line.split()[4] for line in ours] == [line.split()[4]
                                                  for line in theirs]


def _p_latents(i_model, stem):
    """(y_cur, y_cond) of the sequence's second frame on its first."""
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    frames = [torch.from_numpy(np.moveaxis(f.image, -1, 0))[None]
              for f in _sequence()]
    x0, x1 = (pad_centered(x, 64)[0] for x in frames[:2])
    enc = i_model.compress(x0)
    y_cond = i_model.decompress(enc["strings"], enc["shape"])["y_hat"]
    return i_model.get_y(x1)[0], y_cond


def test_charm_entropy_estimation_matches_jax(charm_pair):
    (j_i, j_s), (p_i, p_s) = charm_pair
    got = eval_stem.eval_sequence(p_i, p_s, _sequence(), True, False)
    want = jax_eval_stem.eval_sequence(j_i, j_s, _sequence(), True, False)
    assert got["bpp"] == got["bpp_est"]
    assert got["bpp"] == pytest.approx(want["bpp"], rel=EST_RTOL)
    assert got["psnr"] == pytest.approx(want["psnr"], abs=PSNR_DB)
    assert got["enc_time"] == got["dec_time"] == 0.0


def test_eval_stem_config_matches_jax():
    """The JAX package's fields and defaults, plus ``device`` (cuda), and
    the same command-line binding."""
    port_fields = {f.name: f.default for f in dataclasses.fields(
        port_config.EvalStemConfig)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(
        jax_config.EvalStemConfig)}
    assert port_fields.pop("device") == "cuda"
    assert port_fields == jax_fields
    argv = ["--dataset", "hevc", "--n-gops", "1", "--entropy-estimation",
            "true", "--out-json", "a.json"]
    got = port_config.parse_config(port_config.EvalStemConfig, argv)
    want = jax_config.parse_config(jax_config.EvalStemConfig, argv)
    assert {k: v for k, v in dataclasses.asdict(got).items()
            if k != "device"} == dataclasses.asdict(want)


def test_main_matches_jax_main(tmp_path, capsys):
    """Both mains on one sequence folder of 3 PNGs (HEVC GOP 10, one GOP),
    variant without_spm, the hero I checkpoint (mbt2018-mean, quality 3)
    and a STEM checkpoint the JAX package wrote (the port's seeded STEM;
    not the benchmark's surgery, whose nearly constant z sits on a
    rounding boundary of its sharpened prior, where the last bit decides
    a likelihood of 1 or 1e-9): the same averages in --out-json, bpp
    exactly, PSNR within 1e-4 dB, the estimated bpp within rtol 1e-4."""
    seq = tmp_path / "data" / "seq0"
    seq.mkdir(parents=True)
    for i, f in enumerate(_sequence().frames):
        write_png(seq / f"im{i + 1}.png", f)
    stem = SpatioTemporalPriorModel(variant="without_spm", device="cpu",
                                    seed=2)
    j_stem = JaxStem(variant="without_spm")
    j_stem.params = jax.tree_util.tree_map(jnp.asarray, jax_tree(stem.module))
    j_stem.update()
    ckpt = tmp_path / "stem.pkl.gz"
    jax_save_checkpoint({"model": j_stem.state_dict()}, str(ckpt))
    common = ["--dataset-root", str(tmp_path / "data"), "--dataset", "hevc",
              "--n-gops", "1", "--variant", "without_spm", "--i-quality",
              "3", "--i-checkpoint", str(HERO_DIR / "ckpt_i_0.012.pkl.gz"),
              "--stem-checkpoint", str(ckpt)]
    eval_stem.main(common + ["--out-json", str(tmp_path / "port.json"),
                             "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    jax_eval_stem.main(common + ["--out-json", str(tmp_path / "jax.json")])
    got, want = (json.loads((tmp_path / f"{n}.json").read_text())
                 for n in ("port", "jax"))
    assert set(got) == set(want) == {"seq0", "average"}
    assert printed == got["average"]
    assert got["seq0"]["frames"] == 3
    assert got["average"]["bpp"] == want["average"]["bpp"]
    assert got["average"]["psnr"] == pytest.approx(want["average"]["psnr"],
                                                   abs=PSNR_DB)
    assert got["average"]["bpp_est"] == pytest.approx(
        want["average"]["bpp_est"], rel=EST_RTOL)


def test_train_stem_step_with_a_charm_module_matches_jax(fed_noise,
                                                         tmp_path):
    """train_stem(module=ChannelARSTEMModule) for one per_sequence step
    at 2×64² (M 16, EB 16): the JAX trainer initialises its module from
    its seed's first key split; the port's module gets those weights. The
    step's losses within rtol 1e-4 (the aux loss that of charm's
    bottleneck), and every parameter moves but the last group's LRP: the
    rate loss does not reach it (its refinement feeds only the ŷ carry,
    which the next frame takes detached), in the JAX trainer too."""
    seed = 3
    i_params = export_jax_tree(MeanScaleHyperprior(M, M, device="cpu").module)
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    d = jnp.zeros((1, 4, 4, M))
    jmod = JaxCharmModule(4, EBC, M)
    params = jax.jit(lambda k: jmod.init({"params": k, "noise": k}, d, d,
                                         train=True)["params"])(k)
    module = ChannelARSTEMModule(4, EBC, M)
    load_jax_params(module, jax.tree_util.tree_map(np.asarray, params))
    before = {n: p.detach().clone() for n, p in module.named_parameters()}

    def cfg(cls, sub, **kw):
        return cls(in_channels=M, entropy_bottleneck_channels=EBC,
                   cropsize=64, batch_size=2, seed=seed,
                   step_mode="per_sequence", workdir=str(tmp_path / sub),
                   **kw)

    j_i = JaxMSH(M, M)
    j_i.params = jax.tree_util.tree_map(jnp.asarray, i_params)
    _, want = jax_train_stem(cfg(jax_config.TrainStemConfig, "jax"),
                             max_steps=1, i_model=j_i, module=jmod)
    p_i = MeanScaleHyperprior(M, M, device="cpu")
    load_jax_params(p_i.module, i_params)
    state, got = train_stem(cfg(port_config.TrainStemConfig, "port",
                                device="cpu"),
                            max_steps=1, i_model=p_i, module=module)
    assert state.step == 1
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    for name, p in module.named_parameters():
        assert torch.equal(p, before[name]) == name.startswith("LRP_3."), \
            name
