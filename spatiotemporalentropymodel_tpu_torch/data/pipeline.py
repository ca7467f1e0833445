"""Host batching + device prefetch.

Counterpart of spatiotemporalentropymodel_tpu/data/pipeline.py: a NumPy
batcher (serial or on a thread pool) whose batch order and contents follow
the JAX package's for the same seed, and a prefetch that stages batches on
the card ahead of use through pinned memory and non-blocking copies.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def _batch_indices(n, batch_size, shuffle, seed, drop_last, epochs):
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(
            0, n - (batch_size - 1 if drop_last else 0), batch_size
        ):
            idx = order[start : start + batch_size]
            if len(idx):
                yield idx
        epoch += 1


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epochs: Optional[int] = None,
    collate: Optional[Callable] = None,
    workers: int = 0,
    prefetch_batches: int = 2,
    start: int = 0,
) -> Iterator[np.ndarray]:
    """Yield stacked batches from an indexable dataset.

    ``workers > 0`` reads samples on a thread pool with
    ``prefetch_batches`` batches in flight; batch order and contents are
    those of the serial path. ``start`` skips that many batches without
    reading them (a resumed run's position).
    """
    batches = _batch_indices(len(dataset), batch_size, shuffle, seed,
                             drop_last, epochs)
    for _ in range(start):
        if next(batches, None) is None:
            return
    pack = collate if collate else np.stack

    if workers <= 0:
        for idx in batches:
            yield pack([dataset[int(i)] for i in idx])
        return

    with ThreadPoolExecutor(max_workers=workers) as pool:
        inflight = []

        def submit(idx):
            inflight.append([pool.submit(dataset.__getitem__, int(i))
                             for i in idx])

        for idx in batches:
            submit(idx)
            while len(inflight) > max(1, prefetch_batches):
                yield pack([f.result() for f in inflight.pop(0)])
        while inflight:
            yield pack([f.result() for f in inflight.pop(0)])


def to_device(batch: np.ndarray, device) -> torch.Tensor:
    """One host batch on ``device``: through pinned memory with a
    non-blocking copy on a card, as it is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(batch))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device="cuda") -> Iterator[torch.Tensor]:
    """Stage host batches onto ``device`` ahead of consumption, from a
    producer thread (``to_device``)."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    failure = []

    def producer():
        try:
            for item in iterator:
                q.put(to_device(item, device))
        except BaseException as e:  # handed to the consumer, re-raised there
            failure.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item
