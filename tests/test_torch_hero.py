"""The trained hero models (artifacts/trained/hero) in the port, against
the JAX package, on the CPU: the checkpoints read with jax blocked equal
the JAX package's load_checkpoint leaf for leaf, and the GOP eval of both
packages gives the same streams on a 64×64 crop of the hero eval set."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.eval.eval_stem import (
    eval_sequence as jax_eval_sequence,
)
from spatiotemporalentropymodel_tpu.models import (
    MeanScaleHyperprior as JaxMSH,
    SpatioTemporalPriorModel as JaxStem,
)
from spatiotemporalentropymodel_tpu.training.checkpoints import (
    load_checkpoint as jax_load_checkpoint,
)
from spatiotemporalentropymodel_tpu_torch.convert import state_dict_from_jax
from spatiotemporalentropymodel_tpu_torch.data import ArraySequence
from spatiotemporalentropymodel_tpu_torch.eval.eval_stem import eval_sequence
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    HERO_DIR,
    hero_config,
    hero_gop_set,
    load_hero,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)

ROOT = Path(__file__).resolve().parents[1]
CFG = hero_config()["config"]
FILES = {"i": f"ckpt_i_{CFG['lmbda']}.pkl.gz",
         "res": f"ckpt_p_res_{CFG['lmbda']}.pkl.gz",
         "without_spm": f"ckpt_p_without_spm_{CFG['lmbda']}.pkl.gz"}

# in a process where ``import jax`` fails: load_hero, then every model's
# parameters to a file
_NO_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    import torch
    from spatiotemporalentropymodel_tpu_torch.eval.workload import load_hero
    models = load_hero(device="cpu")
    torch.save({k: m.module.state_dict() for k, m in models.items()},
               sys.argv[1])
""")


def test_checkpoints_load_without_jax_and_match_jax_leaf_for_leaf(
        tmp_path):
    out = tmp_path / "hero_state.pt"
    subprocess.run([sys.executable, "-c", _NO_JAX, str(out)], cwd=ROOT,
                   check=True, timeout=300)
    got = torch.load(out)
    assert set(got) == {"i", "res", "without_spm"}
    modules = {"i": MeanScaleHyperprior(CFG["N"], CFG["M"],
                                         device="cpu").module,
               **{v: SpatioTemporalPriorModel(
                   variant=v, entropy_bottleneck_channels=CFG["EBC"],
                   in_channels=CFG["M"], device="cpu").module
                  for v in ("res", "without_spm")}}
    for key, name in FILES.items():
        ckpt = jax_load_checkpoint(str(HERO_DIR / name))
        tree = (ckpt["model"]["params"] if key == "i"
                else ckpt["params"])
        want = state_dict_from_jax(modules[key], jax.tree_util.tree_map(
            np.asarray, tree))
        assert set(want) == set(got[key]), key
        for k, v in want.items():
            assert torch.equal(got[key][k], v), (key, k)
        if key == "i":  # the leaves after the params: the codec tables
            assert len(jax.tree_util.tree_leaves(ckpt["model"]["tables"])) \
                == 8


def _jax_hero(variant):
    """The JAX models as tools/bakeoff.py::_load_i and _load_p load them."""
    i_model = JaxMSH(CFG["N"], CFG["M"])
    i_model.init(jnp.zeros((1, 64, 64, 3)))
    i_model.load_state_dict(jax_load_checkpoint(
        str(HERO_DIR / FILES["i"]))["model"])
    i_model.update(force=True)
    stem = JaxStem(variant=variant, entropy_bottleneck_channels=CFG["EBC"],
                   in_channels=CFG["M"])
    d = jnp.zeros((1, 4, 4, CFG["M"]))
    stem.init(d, d)
    stem.params = jax.tree_util.tree_map(jnp.asarray, jax_load_checkpoint(
        str(HERO_DIR / FILES[variant]))["params"])
    stem.update(force=True)
    return i_model, stem


def _recording(model, log):
    """model.compress, its streams appended to log."""
    compress = model.compress

    def wrapped(*args):
        enc = compress(*args)
        log.append(enc["strings"])
        return enc

    return wrapped


@pytest.mark.parametrize("variant", ["res", "without_spm"])
def test_hero_gop_eval_matches_jax(variant):
    """A 64×64 crop of the eval set's first three frames as one GOP of 3
    (an I-frame, two P-frames) through both packages' eval_sequence, f32:
    the same streams, bpp rtol 1e-3, PSNR within 1e-3 dB."""
    frames = [f[:64, :64] for f in hero_gop_set(1, 3)[0].frames]
    seq = ArraySequence(frames, 3, "crop")
    port = load_hero(device="cpu", variants=(variant,))
    j_i, j_stem = _jax_hero(variant)
    logs = {"port": [], "jax": []}
    for tag, (i_model, stem) in (("port", (port["i"], port[variant])),
                                 ("jax", (j_i, j_stem))):
        i_model.compress = _recording(i_model, logs[tag])
        stem.compress = _recording(stem, logs[tag])
    got = eval_sequence(port["i"], port[variant], seq, compute_msssim=False)
    want = jax_eval_sequence(j_i, j_stem, seq, compute_msssim=False)
    assert len(logs["port"]) == 3 and logs["port"] == logs["jax"]
    assert got["frames"] == want["frames"] == 3
    assert got["bpp"] == pytest.approx(want["bpp"], rel=1e-3)
    assert got["bpp_est"] == pytest.approx(want["bpp_est"], rel=1e-3)
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-3)
