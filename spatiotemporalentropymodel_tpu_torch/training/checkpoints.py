"""Checkpoints in the JAX package's file layout, read without jax.

Counterpart of spatiotemporalentropymodel_tpu/training/checkpoints.py. A
checkpoint there is a pickle (gzip'd when the name ends in ``.gz``) of
``{key: {"leaves": [NumPy arrays], "treedef": bytes}}``, one entry per
saved pytree, the leaves in jax's flatten order: dict keys sorted as
strings at every level, so a parameter tree's leaves come in
``convert.jax_param_paths`` order. The treedef is a pickle of a jax object,
so only it needs jax; the outer pickle holds it as plain bytes.

Reading (``load_checkpoint``) gives each key's leaves and never opens a
treedef. Writing (``save_checkpoint``) keeps the layout and the order: a
saved value is a tree of dicts, lists and tuples whose leaves are arrays or
tensors (tensors are saved as NumPy arrays; other values are kept as they
are in the tree's structure). A tree that holds a module's parameters as
``convert.jax_tree`` gives them reads back through ``load_checkpoint`` and
``convert.load_jax_leaves``. The port cannot write a jax treedef without
jax: it writes empty treedef bytes and its own structure beside them
(``"structure"``), which ``load_trees`` reads back. The JAX package cannot
resume these files (ROADMAP.md).
"""

import gzip
import os
import pickle
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_LEAF = "__leaf__"


def _flatten(tree, leaves):
    """The structure of ``tree`` with each array leaf replaced by its index
    in ``leaves`` (appended in jax's order: dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        leaves.append(tree)
        return (_LEAF, len(leaves) - 1)
    return tree


def _unflatten(structure, leaves):
    if isinstance(structure, dict):
        return {k: _unflatten(v, leaves) for k, v in structure.items()}
    if isinstance(structure, tuple) and len(structure) == 2 \
            and structure[0] == _LEAF:
        return leaves[structure[1]]
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(v, leaves) for v in structure)
    return structure


def _opener(path):
    return gzip.open if str(path).endswith(".gz") else open


def save_checkpoint(state: Dict[str, Any], path) -> None:
    """Atomically write ``{key: tree}`` (a temporary file, then a rename)."""
    payload = {}
    for key, tree in state.items():
        leaves: List[np.ndarray] = []
        structure = _flatten(tree, leaves)
        payload[key] = {"leaves": leaves, "treedef": b"",
                        "structure": structure}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        os.close(fd)
        with _opener(path)(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _payload(path):
    with _opener(path)(path, "rb") as f:
        return pickle.load(f)


def load_checkpoint(path) -> Dict[str, List[np.ndarray]]:
    """``{key: leaves}`` of the checkpoint at ``path``, each leaf a NumPy
    array, in jax's flatten order. The treedef bytes are not unpickled."""
    return {key: [np.asarray(leaf) for leaf in blob["leaves"]]
            for key, blob in _payload(path).items()}


def load_trees(path) -> Dict[str, Any]:
    """``{key: tree}`` of a checkpoint the port wrote (``save_checkpoint``);
    raises for one the JAX package wrote, whose structure is a jax
    treedef."""
    out = {}
    for key, blob in _payload(path).items():
        if "structure" not in blob:
            raise ValueError(f"{path}: {key!r} has a jax treedef; the port "
                             f"restores only checkpoints it wrote")
        out[key] = _unflatten(blob["structure"],
                              [np.asarray(v) for v in blob["leaves"]])
    return out


class CheckpointManager:
    """latest/best rotation (trainSTEM.py:238-248 keeps a best copy)."""

    def __init__(self, directory, prefix: str = "ckpt"):
        self.directory = str(directory)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric = float("inf")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, f"{self.prefix}_latest.pkl")

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, f"{self.prefix}_best.pkl")

    def save(self, state: Dict[str, Any],
             metric: Optional[float] = None) -> bool:
        """Save latest; copy to best if metric improved. Returns is_best."""
        save_checkpoint(state, self.latest_path)
        if metric is not None and metric < self.best_metric:
            self.best_metric = metric
            save_checkpoint(state, self.best_path)
            return True
        return False

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        """The latest checkpoint's trees (``load_trees``), or None."""
        if os.path.exists(self.latest_path):
            return load_trees(self.latest_path)
        return None
