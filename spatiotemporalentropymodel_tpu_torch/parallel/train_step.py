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

``data_parallel_step`` shards the image and sequence steps' batch over a
``parallel/mesh.py::Mesh`` from one process: each shard's losses and
gradients on its device, the gradients averaged onto the first, one update
there.
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
from .mesh import Mesh, on_device, replica_on, shard_batch


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


def _batch_step(module, optimizers: OptimizerPair, losses):
    """step(state, batch, generator) → (state, metrics) of the losses
    ``losses(module, batch, generator)`` (a dict with "loss"): their main
    gradient, the aux gradient, then both updates. ``data_parallel_step``
    reads ``losses`` and the stepper off the step."""
    s = _Stepper(module, optimizers)

    def step(state: TrainState, batch, generator):
        s.check(state)
        metrics = losses(module, batch, generator)
        g_main = _grads(metrics["loss"], s.main_params)
        aux, g_aux = s.aux_grads()
        metrics = dict(_detached(metrics), aux_loss=aux)
        return s.apply_both(state, g_main, g_aux), metrics

    step.losses, step.stepper = losses, s
    return step


def make_image_train_step(module, optimizers: OptimizerPair,
                          lmbda: float = 1e-2):
    """Train step of an image codec: λ·255²·MSE + bpp, plus the aux loss
    (compressai_examples/train.py:119-156). step(state, x, generator) with
    x (B, 3, H, W) in [0, 1]."""
    def losses(net, x, generator):
        out = net(x, train=True, generator=generator)
        return rate_distortion_loss(out, x, lmbda)

    return _batch_step(module, optimizers, losses)


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
    return _batch_step(module, optimizers, sequence_loss)


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


def _shard_generators(generator, mesh: Mesh):
    """One generator per shard on its device, seeded from ``generator`` in
    shard order."""
    seeds = torch.randint(0, 2**62, (mesh.size,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=d).manual_seed(seed)
            for d, seed in zip(mesh.devices, seeds)]


def data_parallel_step(step_fn, mesh: Mesh):
    """Shard a (state, batch, generator) → (state, metrics) step
    (``make_image_train_step``, ``make_stem_train_step``) over ``mesh``:
    dim 0 of the batch split into equal shards, one per entry.

    Each shard runs the step's losses and their main gradient on its device,
    with its card current (``mesh.on_device``), through a replica of the
    module there (``mesh.replica_on``: made once, its values copied from the
    module's before each step) or the module itself where the entry is the
    module's device; each shard's gradients come from an ``autograd.grad``
    call of their own. The gradients and metrics are
    averaged onto the first device (the JAX package's psum), and there the
    aux gradient, the clip and both updates run once. Every loss of these
    steps is a mean over equal shards, so the step is the one-device step
    on the whole batch.

    Each shard draws its noise from its own generator, seeded from the
    caller's in shard order, so the draws differ from the one-device
    step's; only noise that is a function of its input (the tests' fed
    noise) makes the two steps equal. On a mesh of one entry the shard
    draws from the caller's generator and the step is ``step_fn``'s
    exactly.
    """
    losses, s = step_fn.losses, step_fn.stepper
    primary = mesh.devices[0]
    on = next(s.module.parameters()).device
    if on != primary:
        raise ValueError(f"the module is on {on}, the mesh's first device "
                         f"is {primary}")

    def step(state: TrainState, batch, generator):
        s.check(state)
        shards = shard_batch(batch, mesh)
        gens = ([generator] if mesh.size == 1
                else _shard_generators(generator, mesh))
        g_main = totals = None
        for device, shard, gen in zip(mesh.devices, shards, gens):
            net = replica_on(s.module, device)
            with on_device(device):
                metrics = losses(net, shard, gen)
                grads = _grads(metrics["loss"], main_parameters(net))
            grads = [g.to(primary) for g in grads]
            metrics = {k: v.detach().to(primary) for k, v in metrics.items()}
            if g_main is None:
                g_main, totals = grads, metrics
            else:
                g_main = [a + b for a, b in zip(g_main, grads)]
                totals = {k: totals[k] + v for k, v in metrics.items()}
        if mesh.size > 1:
            g_main = [g / mesh.size for g in g_main]
            totals = {k: v / mesh.size for k, v in totals.items()}
        aux, g_aux = s.aux_grads()
        metrics = dict(totals, aux_loss=aux)
        return s.apply_both(state, g_main, g_aux), metrics

    return step
