# Copy of worddiffusion_tpu/data/manipulate.py: the port imports nothing of the JAX package.
"""Offline dataset preparation ops.

Rebuilds ``ResPhoSCNetZSL/dataset_manipulation/``:
- ``balance_by_word``: augment-or-trim every word class to N samples
  (``augment_dataset.py:56-167``),
- ``balance_by_length``: same keyed by word length
  (``augment_dataset_for_charactercounter.py:83-128``),
- ``trim_dataset`` / word filtering,
- ``resize_dataset``: the crops at the recognizer's 250x50, OpenCV's
  ``resize`` with INTER_LINEAR written out in numpy (``resize_linear``).
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



RESIZE_BITS = 11  # INTER_RESIZE_COEF_BITS


def _resize_taps(n_in: int, n_out: int, clamp_edges: bool):
    """OpenCV's INTER_LINEAR taps of one axis: source index ``floor(f)`` and
    11-bit weights of ``f = (d + 0.5) * scale - 0.5`` in float32. Along x a
    tap left of or right of the image is pinned to the edge with weight 0
    (``clamp_edges``); along y the fraction stays and the rows are clamped."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float32)
    if clamp_edges:
        frac[(s < 0) | (s >= n_in - 1)] = 0
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((np.float32(1) - frac) * (1 << RESIZE_BITS)).astype(np.int64)
    w1 = np.rint(frac * (1 << RESIZE_BITS)).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) of a uint8 HW or
    HWC image: the horizontal pass in 11-bit fixed point, then the vertical
    one as OpenCV's vector kernel rounds it, ``(((a >> 4) * b0 >> 16) + ((c >>
    4) * b1 >> 16) + 2) >> 2`` (bitwise OpenCV 5.0 on the shapes
    ``tests/test_torch_augment.py`` checks)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _resize_taps(w, width, True)
    y0, y1, b0, b1 = _resize_taps(h, height, False)
    im = img.astype(np.int64)
    extra = (None,) * (img.ndim - 2)
    rows = im[:, x0] * a0[(slice(None),) + extra] + im[:, x1] * a1[(slice(None),) + extra]
    b0 = b0[(slice(None), None) + extra]
    b1 = b1[(slice(None), None) + extra]
    v = (((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def resize_dataset(
    images: Sequence[np.ndarray], height: int = 50, width: int = 250
) -> list[np.ndarray]:
    """Re-render crops at the recognizer input size (250x50)."""
    return [resize_linear(img, width, height) for img in images]
