"""Training observability: scalar metrics.

Counterpart of spatiotemporalentropymodel_tpu/training/logging.py (the
reference logs TensorBoard scalars, trainSTEM.py:155,220-234): a JSONL
file of scalars, mirrored to TensorBoard where ``torch.utils.tensorboard``
imports. Spans and counters are ``utils/trace.py``'s.
"""

import json
import os
import time


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
