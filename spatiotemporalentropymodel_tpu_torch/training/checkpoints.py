"""Read the JAX package's checkpoints, with no jax.

Counterpart of the reading half of spatiotemporalentropymodel_tpu/
training/checkpoints.py. A checkpoint there is a pickle (gzip'd when the
name ends in ``.gz``) of ``{key: {"leaves": [NumPy arrays], "treedef":
bytes}}``, one entry per saved pytree. The treedef is itself a pickle of a
jax object, so only it needs jax to load; the outer pickle holds it as
plain bytes and never opens it. The leaves come in jax's flatten order:
dict keys sorted as strings at every level (``convert.jax_param_paths``
rebuilds that order from a port module).
"""

import gzip
import pickle
from typing import Dict, List

import numpy as np


def load_checkpoint(path) -> Dict[str, List[np.ndarray]]:
    """``{key: leaves}`` of the checkpoint at ``path``, each leaf a NumPy
    array, in jax's flatten order. The treedef bytes are not unpickled."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        payload = pickle.load(f)
    return {key: [np.asarray(leaf) for leaf in blob["leaves"]]
            for key, blob in payload.items()}
