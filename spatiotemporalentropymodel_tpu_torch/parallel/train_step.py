"""Train steps on one device: image codecs and STEM sequence training.

Counterpart of spatiotemporalentropymodel_tpu/parallel/train_step.py
(the reference's loops, stem/trainSTEM.py:164-262 and
compressai_examples/train.py:119-175). Each step computes the main loss's
gradient and the aux loss's gradient from the same parameters, then
applies the main update (its gradients clipped to a global norm) and then
the aux update (``_apply_both``). The STEM steps feed each P-frame the
previous frame's ŷ detached (``stem(y_cur, y_condition.detach())``,
trainSTEM.py:199-209).

A step made by ``make_*_step(module, optimizers)`` takes the
``TrainState`` of that module and optimizer pair, updates its parameters
and optimizer states in place and returns it with the step's metrics
(0-dim tensors on the device). Noise comes from the ``torch.Generator``
passed to each call.

The JAX package's ``data_parallel_step`` (its batch sharded over a device
mesh) waits for the port's DistributedDataParallel work (ROADMAP.md, Queue
1, ``parallel/``).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..convert import jax_tree, load_jax_params
from ..models.base import aux_loss
from ..training.losses import em_loss, rate_distortion_loss
from ..training.optimizers import (
    OptimizerPair, clip_by_global_norm, main_parameters,
    quantiles_parameters,
)


@dataclass
class TrainState:
    module: torch.nn.Module
    optimizers: OptimizerPair
    step: int = 0

    def tree(self):
        """The state as a checkpoint saves it, in the JAX package's order
        (params, main optimizer state, aux optimizer state, step): the
        parameters as the JAX tree (``convert.jax_tree``), so a
        checkpoint's first leaves load through
        ``convert.load_jax_leaves``; then torch's optimizer state dicts."""
        return (jax_tree(self.module), self.optimizers.main.state_dict(),
                self.optimizers.aux.state_dict(),
                np.asarray(self.step, np.int32))

    def load_tree(self, tree) -> None:
        """Restore from ``tree()`` as a checkpoint gives it back."""
        params, main, aux, step = tree
        load_jax_params(self.module, params)
        self.optimizers.main.load_state_dict(_tensors(main))
        self.optimizers.aux.load_state_dict(_tensors(aux))
        self.step = int(step)


def _tensors(tree):
    """A saved optimizer state dict with its arrays as tensors again."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def init_train_state(module, optimizers: OptimizerPair) -> TrainState:
    return TrainState(module, optimizers, 0)


def _grads(loss, params):
    """d loss / d params, zeros where a parameter does not reach loss."""
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, got)]


class _Stepper:
    """The gradients and updates every step shares."""

    def __init__(self, module, optimizers: OptimizerPair):
        self.module = module
        self.optimizers = optimizers
        self.main_params = main_parameters(module)
        self.aux_params = quantiles_parameters(module)

    def check(self, state: TrainState):
        if state.module is not self.module or \
                state.optimizers is not self.optimizers:
            raise ValueError("the train state is not this step's module and "
                             "optimizers")

    def aux_grads(self):
        """The aux loss (the bottlenecks' quantile fit) and its gradient,
        which reaches ``quantiles`` only."""
        aux = aux_loss(self.module)
        return aux.detach(), _grads(aux, self.aux_params)

    def apply_both(self, state: TrainState, g_main, g_aux) -> TrainState:
        """The main update (clipped), then the aux update
        (train_step.py:39-45 of the JAX package)."""
        clip_by_global_norm(g_main, self.optimizers.max_grad_norm)
        for opt, params, grads in (
                (self.optimizers.main, self.main_params, g_main),
                (self.optimizers.aux, self.aux_params, g_aux)):
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
        state.step += 1
        return state


def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


def make_image_train_step(module, optimizers: OptimizerPair,
                          lmbda: float = 1e-2):
    """Train step of an image codec: λ·255²·MSE + bpp, plus the aux loss
    (compressai_examples/train.py:119-156). step(state, x, generator) with
    x (B, 3, H, W) in [0, 1]."""
    s = _Stepper(module, optimizers)

    def step(state: TrainState, x, generator):
        s.check(state)
        out = module(x, train=True, generator=generator)
        losses = rate_distortion_loss(out, x, lmbda)
        g_main = _grads(losses["loss"], s.main_params)
        aux, g_aux = s.aux_grads()
        metrics = dict(_detached(losses), aux_loss=aux)
        return s.apply_both(state, g_main, g_aux), metrics

    return step


def frame_loss(module, y_cur, y_cond, generator):
    """(EM losses, ŷ) of one P-frame in train mode, conditioned on the
    carry detached (``stem(y_cur, y_condition.detach())``)."""
    out = module(y_cur, y_cond.detach(), train=True, generator=generator)
    return em_loss(out, y_cur), out["y_hat"]


def sequence_loss(module, batch, generator):
    """The mean EM losses over the P-frames 1..T-1 of a latent sequence
    (B, T, M, h, w), frame 0 the first carry, each frame conditioned on the
    previous ŷ detached (the JAX package's ``seq_loss``)."""
    y_cond = batch[:, 0]
    per_frame = []
    for t in range(1, batch.shape[1]):
        losses, y_cond = frame_loss(module, batch[:, t], y_cond, generator)
        per_frame.append(losses)
    return {k: torch.stack([f[k] for f in per_frame]).mean()
            for k in ("loss", "y_bpp_loss", "z_bpp_loss")}


def make_stem_train_step(module, optimizers: OptimizerPair):
    """Train step of a STEM P-frame model over a latent sequence, one update
    per sequence (``step_mode="per_sequence"``).

    batch: (B, T, M, h, w) latents (T ≥ 2); frame 0 is the *quantized*
    conditioning latent (the initial carry, the reference's ``_,
    y_condition = getY(images[0])``) and frames 1..T-1 are *raw* latents,
    the coding targets (trainSTEM.py:199-207). Each frame is conditioned on
    the previous ŷ detached; the loss is the mean of the per-frame EM
    losses and one update is taken on it (the deferred recipe of
    train_stem_roi.py:628-631)."""
    s = _Stepper(module, optimizers)

    def step(state: TrainState, batch, generator):
        s.check(state)
        metrics = sequence_loss(module, batch, generator)
        g_main = _grads(metrics["loss"], s.main_params)
        aux, g_aux = s.aux_grads()
        metrics = dict(_detached(metrics), aux_loss=aux)
        return s.apply_both(state, g_main, g_aux), metrics

    return step


def make_stem_frame_step(module, optimizers: OptimizerPair):
    """Single-P-frame train step, one update per frame
    (``step_mode="per_frame"``, the faithful trainSTEM recipe,
    trainSTEM.py:199-218). step(state, y_cur, y_cond, generator) →
    (state, metrics, ŷ detached), so the caller loops the frames carrying
    ŷ."""
    s = _Stepper(module, optimizers)

    def step(state: TrainState, y_cur, y_cond, generator):
        s.check(state)
        losses, y_hat = frame_loss(module, y_cur, y_cond, generator)
        g_main = _grads(losses["loss"], s.main_params)
        aux, g_aux = s.aux_grads()
        metrics = dict(_detached(losses), aux_loss=aux)
        return s.apply_both(state, g_main, g_aux), metrics, y_hat.detach()

    return step


def make_stem_eval_step(module):
    """Deterministic eval loss over a latent sequence (validation of
    trainSTEM.py:265-295): the mean per-frame EM loss, quantization by
    rounding, no update. step(frames) → 0-dim tensor."""

    @torch.no_grad()
    def step(frames):
        y_cond = frames[:, 0]
        losses = []
        for t in range(1, frames.shape[1]):
            out = module(frames[:, t], y_cond)
            losses.append(em_loss(out, frames[:, t])["loss"])
            y_cond = out["y_hat"]
        return torch.stack(losses).mean()

    return step
