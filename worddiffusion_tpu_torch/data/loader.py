"""Batching iterator with background prefetch (PIL-free copy of the
training path of ``worddiffusion_tpu/data/loader.py``: ``batches``,
``prefetch`` and ``epoch_batches``; that module imports the PIL-backed
dataset).

Batches are assembled on a worker thread while the previous step runs;
``map_fn`` (the Trainer's device staging: pinned memory, non-blocking
copies) runs there too.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def _stack(records: list[dict]) -> dict:
    out = {}
    for key in records[0]:
        vals = [r[key] for r in records]
        if isinstance(vals[0], str):
            out[key] = vals  # strings (word, image_name)
        else:
            out[key] = np.stack(vals)
    return out


def batches(dataset, batch_size: int, rng: np.random.Generator) -> Iterator[dict]:
    """Full batches in the order ``rng`` shuffles; the remainder is dropped."""
    order = np.arange(len(dataset))
    rng.shuffle(order)
    end = len(order) - (len(order) % batch_size)
    for start in range(0, end, batch_size):
        yield _stack([dataset[int(i)] for i in order[start : start + batch_size]])


def prefetch(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run the upstream iterator on a worker thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            return
        yield item


def epoch_batches(
    dataset,
    batch_size: int,
    epoch: int,
    seed: int = 0,
    prefetch_depth: int = 2,
    map_fn=None,
) -> Iterator[dict]:
    """The epoch's batches in the ``np.random.default_rng((seed, epoch))``
    permutation; ``map_fn`` runs on the prefetch worker thread."""
    rng = np.random.default_rng((seed, epoch))
    it = batches(dataset, batch_size, rng)
    if map_fn is not None:
        it = (map_fn(b) for b in it)
    return prefetch(it, prefetch_depth)
