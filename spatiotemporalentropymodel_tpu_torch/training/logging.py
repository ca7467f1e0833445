"""Training observability: scalar metrics, stage clocks, profiler traces.

Counterpart of spatiotemporalentropymodel_tpu/training/logging.py (the
reference logs TensorBoard scalars, trainSTEM.py:155,220-234): a JSONL
file of scalars, mirrored to TensorBoard where ``torch.utils.tensorboard``
imports; ``StageTimer``, whose stages synchronise the card at both ends so
a stage's time is its device work; and ``profile_trace`` on
``torch.profiler`` in place of ``jax.profiler``.
"""

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


class MetricsLogger:
    def __init__(self, logdir: str, name: str = "train"):
        os.makedirs(logdir, exist_ok=True)
        self.jsonl_path = os.path.join(logdir, f"{name}_metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            self._tb = None
        else:
            self._tb = SummaryWriter(os.path.join(logdir, name))

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextmanager
def profile_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present), written as ``logdir/trace.json`` (Chrome trace format);
    a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Per-stage wall-clock timers (the reference's ad-hoc time.time()
    prints, spatiotemporalpriors.py:360-390). On a CUDA ``device`` each
    stage synchronises it before and after, so the clock holds the
    stage's device work."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals = {}
        self.counts = {}

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name],
                   "mean_ms": 1e3 * self.totals[name] / self.counts[name]}
            for name in self.totals
        }
