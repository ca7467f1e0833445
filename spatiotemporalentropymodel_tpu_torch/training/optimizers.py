"""Main/aux optimizer split, the plateau schedule and a moving average.

Counterpart of spatiotemporalentropymodel_tpu/training/optimizers.py
(configure_optimizers of root utils.py:104-135 of the reference): the
auxiliary Adam trains only the parameters named ``quantiles`` (the
EntropyBottleneck tail trackers); the main Adam trains everything else,
its gradients first clipped to a global norm taken over the main
parameters only (trainSTEM.py:213-214).

The JAX package builds both as ``optax.masked`` transforms over the whole
parameter tree, and a masked transform passes the other partition's
gradient through unchanged. In a train step that gradient is zero: train
mode never reads the medians, so the main loss does not reach
``quantiles``, and the aux loss detaches all but ``quantiles``. Here each
``torch.optim.Adam`` holds its own partition only, which computes the same
update (optax's Adam and torch's are the same formula, bias corrections
and ε outside the root).
"""

import math
from collections import deque
from typing import List, NamedTuple

import torch


def is_quantiles(name: str) -> bool:
    """Whether the parameter at a dotted module path is a ``quantiles``."""
    return "quantiles" in name.split(".")


def main_parameters(module) -> List[torch.nn.Parameter]:
    return [p for n, p in module.named_parameters() if not is_quantiles(n)]


def quantiles_parameters(module) -> List[torch.nn.Parameter]:
    return [p for n, p in module.named_parameters() if is_quantiles(n)]


class OptimizerPair(NamedTuple):
    main: torch.optim.Adam
    aux: torch.optim.Adam
    max_grad_norm: float


def configure_optimizers(module, learning_rate: float = 1e-4,
                         aux_learning_rate: float = 1e-3,
                         max_grad_norm: float = 1.0) -> OptimizerPair:
    """(main, aux) Adams over ``module``'s two partitions, and the main
    gradients' clip norm."""
    main = torch.optim.Adam(main_parameters(module), lr=learning_rate)
    aux = torch.optim.Adam(quantiles_parameters(module), lr=aux_learning_rate)
    return OptimizerPair(main, aux, float(max_grad_norm))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm`` does: by
    max_norm/norm where norm ≥ max_norm, else not at all (torch's
    ``clip_grad_norm_`` scales by max_norm/(norm + 1e-6) always). Returns
    the global norm; the choice stays on the device (no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def set_main_learning_rate(main_opt: torch.optim.Optimizer,
                           learning_rate: float) -> None:
    for group in main_opt.param_groups:
        group["lr"] = float(learning_rate)


def get_main_learning_rate(main_opt: torch.optim.Optimizer) -> float:
    return float(main_opt.param_groups[0]["lr"])


class MovingAverage:
    """Windowed running mean (root utils.py:77-94)."""

    def __init__(self, size: int):
        self.queue = deque()
        self.max_size = size

    def next(self, val: float) -> float:
        self.queue.append(val)
        if len(self.queue) > self.max_size:
            self.queue.popleft()
        return float(sum(self.queue)) / len(self.queue)


class ReduceLROnPlateau:
    """Host-side LR schedule of trainSTEM.py:123 (mode 'min', torch's
    default patience and factor), the JAX package's copy with its
    ``state_dict``: ``step`` returns the scale the loop multiplies the base
    learning rate by."""

    def __init__(self, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = math.inf
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
        return self.scale

    def state_dict(self):
        return {"best": self.best, "num_bad": self.num_bad,
                "scale": self.scale}

    def load_state_dict(self, state):
        self.best = state["best"]
        self.num_bad = state["num_bad"]
        self.scale = state["scale"]
