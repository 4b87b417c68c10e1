# Copy of worddiffusion_tpu/data/phosc.py: the port imports nothing of the JAX package.
"""PHOSC = PHOS ++ PHOC joint descriptor and the ZSL lexicon map.

Mirrors ``ResPhoSCNetZSL/modules/datasets.py:44-70`` (phos followed by
phoc, with the diffusion-conditioning variant cast to int64) and
``modules/utils/map.py:8-14`` (word -> phosc dict used for cosine
zero-shot decoding).
"""

from __future__ import annotations

import numpy as np

from .alphabets import phoc_dim, phos_dim
from .phoc import phoc_vector
from .phos import phos_vector


def phosc_vector(word: str, version: str = "eng", as_int: bool = False) -> np.ndarray:
    """PHOS ++ PHOC for one word.

    ``as_int=True`` reproduces the diffusion-trainer path that casts the
    descriptor to integer token ids before embedding it through the
    character encoder (``modules/datasets.py:67``,
    ``unetPhosc.py:1120-1134``). The word is stripped of spaces and
    underscores first, as in ``datasets.py:44-49``.
    """
    clean = word.replace(" ", "").replace("_", "")
    vec = np.concatenate([phos_vector(clean, version), phoc_vector(clean, version)])
    if as_int:
        return vec.astype(np.int64)
    return vec.astype(np.float32)


def phosc_dim(version: str = "eng") -> int:
    return phos_dim(version) + phoc_dim(version)


def lexicon_map(words: list[str], version: str = "eng") -> dict[str, np.ndarray]:
    """word -> float phosc vector for every unique word (ZSL decode map)."""
    return {w: phosc_vector(w, version) for w in dict.fromkeys(words)}


def lexicon_matrix(words: list[str], version: str = "eng") -> tuple[list[str], np.ndarray]:
    """Unique words and their stacked phosc matrix, for vectorized
    cosine decoding (replaces the reference's per-word Python loop,
    ``modules/engine.py:140-144``)."""
    uniq = list(dict.fromkeys(words))
    mat = np.stack([phosc_vector(w, version) for w in uniq]).astype(np.float32)
    return uniq, mat
