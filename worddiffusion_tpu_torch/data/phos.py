# Copy of worddiffusion_tpu/data/phos.py: the port imports nothing of the JAX package.
"""PHOS (Pyramidal Histogram Of Shapes) descriptor.

Semantics match the reference generator (``ResPhoSCNetZSL/modules/utils/
phos_generator.py:59-78``): the base shape-count vector of the whole
word, followed by pyramid levels 2..5; each level splits the word into
``split`` segments of ``len(word) // split`` characters, with the last
segment absorbing the remainder.

eng/gw: 15 segments x 11 shapes = 165 dims; nor: 15 x 12 = 180 dims.
"""

from __future__ import annotations

import numpy as np

from .alphabets import PHOS_NUM_SHAPES, PHOS_SHAPE_TABLES


def word_shape_counts(word: str, version: str = "eng") -> np.ndarray:
    table = PHOS_SHAPE_TABLES[version]
    vec = np.zeros(PHOS_NUM_SHAPES[version], dtype=np.float64)
    for ch in word:
        vec += np.asarray(table[ch], dtype=np.float64)
    return vec


def phos_vector(word: str, version: str = "eng") -> np.ndarray:
    segments = [word]
    length = len(word)
    for split in range(2, 6):
        parts = length // split
        for mul in range(split - 1):
            segments.append(word[mul * parts : mul * parts + parts])
        segments.append(word[(split - 1) * parts : length])
    return np.concatenate(
        [word_shape_counts(seg, version) for seg in segments]
    )


def phos_labels(words: list[str], version: str = "eng") -> dict[str, np.ndarray]:
    return {w: phos_vector(w, version) for w in words}
