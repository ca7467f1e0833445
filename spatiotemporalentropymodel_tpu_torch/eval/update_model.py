"""Post-training CDF update and hash-stamped re-export.

Counterpart of spatiotemporalentropymodel_tpu/eval/update_model.py
(compressai/utils/update_model, __main__.py:100-137): load a training
checkpoint, rebuild the codec tables (``update(force=True)``) and write a
deployment checkpoint whose file name carries a SHA-256 prefix.

The checkpoint is read without jax (``training/checkpoints.py``): its
``"model"`` entry (parameters and tables, ``load_state_leaves``) or the
parameters that lead its ``"train_state"`` (``convert.load_jax_leaves``).
A checkpoint with neither raises ``KeyError``; the JAX package keeps the
model's initial parameters then. The export is ``{"model": {"params",
"tables"}}`` in the JAX package's ``state_dict`` layout, written with the
port's empty treedef (``training/checkpoints.py``).

    python -m spatiotemporalentropymodel_tpu_torch.eval.update_model \\
        CKPT -a bmshj2018-factorized -q 1 -d OUT_DIR [--device cuda|cpu]
"""

import argparse
import hashlib
import os

import numpy as np
import torch

from ..convert import load_jax_leaves
from ..entropy.bottleneck import solve_quantiles
from ..training.checkpoints import load_checkpoint, save_checkpoint

# a solved quantile this far out means the bisection's bracket (±1e4) was
# hit: the channel keeps its trained quantiles
_BRACKET_HIT = 9e3


def update_checkpoint(model, in_path: str, out_dir: str,
                      name: str = "model", solve_aux: bool = True) -> str:
    """Rebuild tables and export {name}-{sha256[:8]}.pkl; returns the path.

    ``solve_aux``: set every EntropyBottleneck's quantiles to the aux
    loss's optimum in closed form (``entropy/bottleneck.py::
    solve_quantiles``) before the tables are built, where no channel hits
    the bracket; the aux Adam only approximates it.
    """
    state = load_checkpoint(in_path)
    if "model" in state:
        model.load_state_leaves(state["model"])
    elif "train_state" in state:
        load_jax_leaves(model.module, state["train_state"])
    else:
        raise KeyError(f"{in_path} holds neither 'model' nor 'train_state' "
                       f"(keys: {sorted(state)})")
    if solve_aux:
        for bn in model.bottleneck_names:
            eb = model.module.get_submodule(bn)
            q = solve_quantiles(eb.numpy_params())
            if np.all(np.abs(q) < _BRACKET_HIT):
                with torch.no_grad():
                    eb.quantiles.copy_(torch.from_numpy(q.astype(np.float32)))
    model.update(force=True)

    os.makedirs(out_dir, exist_ok=True)
    tmp_path = os.path.join(out_dir, f"{name}.pkl")
    save_checkpoint({"model": model.state_tree()}, tmp_path)
    with open(tmp_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    final = os.path.join(out_dir, f"{name}-{digest}.pkl")
    os.replace(tmp_path, final)
    return final


def main(argv=None):
    from ..zoo import cfgs, model_architectures

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint")
    parser.add_argument("-a", "--architecture", required=True,
                        choices=list(model_architectures))
    parser.add_argument("-q", "--quality", type=int, default=1)
    parser.add_argument("-d", "--dir", default=".")
    parser.add_argument("-n", "--name", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    model = model_architectures[args.architecture](
        *cfgs[args.architecture][args.quality], device=args.device
    )
    name = args.name or args.architecture
    out = update_checkpoint(model, args.checkpoint, args.dir, name)
    print(out)


if __name__ == "__main__":
    main()
