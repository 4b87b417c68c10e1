# Copy of worddiffusion_tpu/data/manipulate.py: the port imports nothing of the JAX package.
"""Offline dataset preparation ops.

Rebuilds ``ResPhoSCNetZSL/dataset_manipulation/``:
- ``balance_by_word``: augment-or-trim every word class to N samples
  (``augment_dataset.py:56-167``),
- ``balance_by_length``: same keyed by word length
  (``augment_dataset_for_charactercounter.py:83-128``),
- ``trim_dataset`` / word filtering.

``resize_dataset`` (OpenCV's resize) is not copied: it waits for the
port's image augmentation.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Sequence

import numpy as np

from .gt import Sample


def group_by(samples: Sequence[Sample], key: Callable[[Sample], object]) -> dict:
    groups = defaultdict(list)
    for s in samples:
        groups[key(s)].append(s)
    return dict(groups)


def balance_by_word(
    samples: Sequence[Sample], target: int, seed: int = 0
) -> list[Sample]:
    """Over-sample (duplicate, to be augmented downstream) or trim each
    word class to exactly ``target`` samples."""
    rng = np.random.default_rng(seed)
    out: list[Sample] = []
    for word, group in group_by(samples, lambda s: s.word).items():
        if len(group) >= target:
            idx = rng.permutation(len(group))[:target]
        else:
            idx = rng.integers(0, len(group), target)
            idx[: len(group)] = np.arange(len(group))
        out.extend(group[i] for i in idx)
    return out


def balance_by_length(
    samples: Sequence[Sample], target: int, seed: int = 0
) -> list[Sample]:
    rng = np.random.default_rng(seed)
    out: list[Sample] = []
    for _, group in group_by(samples, lambda s: len(s.word)).items():
        if len(group) >= target:
            idx = rng.permutation(len(group))[:target]
        else:
            idx = rng.integers(0, len(group), target)
            idx[: len(group)] = np.arange(len(group))
        out.extend(group[i] for i in idx)
    return out


def trim_dataset(
    samples: Sequence[Sample],
    min_len: int = 1,
    max_len: int = 100,
    alphabet: str | None = None,
) -> list[Sample]:
    """Drop words outside [min_len, max_len] or containing
    out-of-alphabet characters."""
    out = []
    for s in samples:
        if not (min_len <= len(s.word) <= max_len):
            continue
        if alphabet is not None and any(
            c not in alphabet for c in s.word.replace(" ", "_")
        ):
            continue
        out.append(s)
    return out


def isolate_original(
    samples: Sequence[Sample],
    is_augmented: Callable[[str], bool] = lambda name: "_aug" in name,
) -> list[Sample]:
    """Keep only non-augmented crops (``isolate_original.py``: filters
    by the augmentation filename marker)."""
    return [s for s in samples if not is_augmented(s.image)]

