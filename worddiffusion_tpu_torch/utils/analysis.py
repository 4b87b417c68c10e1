# Copy of worddiffusion_tpu/utils/analysis.py: the port imports nothing of the JAX package.
"""Offline analysis utilities.

- ``embedding_correlation``: correlation matrix between cached
  per-writer word embeddings (``wordEmbWriter.py:14-39``).
- ``word_length_histogram``: dataset word-length stats
  (``ResPhoSCNetZSL/dataset_analysis/count.py``).
"""

from __future__ import annotations

from collections import Counter
from typing import Mapping, Sequence

import numpy as np


def embedding_correlation(embeddings: Mapping[str, np.ndarray]) -> tuple[list[str], np.ndarray]:
    """{writer: [N, D] or [D]} -> (writers, Pearson correlation matrix
    of the per-writer mean embeddings)."""
    keys = sorted(embeddings)
    mat = np.stack([
        np.asarray(embeddings[k]).reshape(-1, np.asarray(embeddings[k]).shape[-1]).mean(0)
        for k in keys
    ])
    mat = mat - mat.mean(axis=1, keepdims=True)
    norm = np.linalg.norm(mat, axis=1, keepdims=True) + 1e-8
    corr = (mat / norm) @ (mat / norm).T
    return keys, corr


def word_length_histogram(words: Sequence[str]) -> dict[int, int]:
    return dict(sorted(Counter(len(w) for w in words).items()))
