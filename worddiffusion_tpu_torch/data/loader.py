"""Batching iterator with background prefetch (copy of
``worddiffusion_tpu/data/loader.py``'s ``host_shard``, ``batches``,
``prefetch`` and ``epoch_batches``).

Batches are assembled on a worker thread while the previous step runs;
``map_fn`` (the Trainer's device staging: pinned memory, non-blocking
copies) runs there too.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np


def host_shard(samples: Sequence, host_id: int, host_count: int) -> list:
    """Round-robin share of ``samples`` for process ``host_id`` of
    ``host_count``."""
    return list(samples[host_id::host_count])


def _stack(records: list[dict]) -> dict:
    out = {}
    for key in records[0]:
        vals = [r[key] for r in records]
        if isinstance(vals[0], str):
            out[key] = vals  # strings (word, image_name)
        else:
            out[key] = np.stack(vals)
    return out


def batches(dataset, batch_size: int, rng: Optional[np.random.Generator] = None,
            shuffle: bool = True, drop_remainder: bool = True,
            rows: Optional[slice] = None) -> Iterator[dict]:
    """Batches in the order ``rng`` shuffles (or in dataset order without
    ``shuffle``). ``drop_remainder`` drops a short last batch; without it
    the last batch is filled by wrapping to the front of its own indices
    (``data.latent_cache``'s pass, which then drops the repeats by
    name). ``rows`` keeps only those rows of each batch (a process's
    slice of the global batch): only their records are loaded."""
    order = np.arange(len(dataset))
    if shuffle:
        (rng or np.random.default_rng(0)).shuffle(order)
    end = len(order) - (len(order) % batch_size) if drop_remainder else len(order)
    for start in range(0, end, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate([idx, idx[: batch_size - len(idx)]])
        if rows is not None:
            idx = idx[rows]
        yield _stack([dataset[int(i)] for i in idx])


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
    rows: Optional[slice] = None,
) -> Iterator[dict]:
    """The epoch's batches in the ``np.random.default_rng((seed, epoch))``
    permutation; ``map_fn`` runs on the prefetch worker thread; ``rows``:
    ``batches``'. A dataset with ``set_epoch`` (per-epoch augmentation
    draws) is told the epoch first."""
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    rng = np.random.default_rng((seed, epoch))
    it = batches(dataset, batch_size, rng, rows=rows)
    if map_fn is not None:
        it = (map_fn(b) for b in it)
    return prefetch(it, prefetch_depth)
