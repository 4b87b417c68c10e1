# Copy of worddiffusion_tpu/data/phoc.py: the port imports nothing of the JAX package.
"""PHOC (Pyramidal Histogram Of Characters) descriptor.

Semantics match the reference (``ResPhoSCNetZSL/modules/utils/
phoc_generator.py:17-90``): the word is lower-cased, split into pyramid
levels 2..5 of binary char-presence histograms over
``[0-9a-z]`` (+ ``æøå`` for Norwegian), then two histograms over the 50
most frequent bigrams computed on the two halves of the word.

Reference quirks preserved: the bigram histogram iterates over single
*characters* of the half-word and matches them against the bigram list
(so it only fires for 1-char "bigrams", i.e. effectively never) — kept
verbatim because the published PHOSC checkpoints were trained with it.

eng/gw: 14*36 + 100 = 604 dims; nor: 14*39 + 100 = 646 dims.
"""

from __future__ import annotations

import numpy as np

from .alphabets import PHOC_BIGRAMS, PHOC_NUM_CHARS


def _char_histogram(segment: str, version: str) -> np.ndarray:
    size = PHOC_NUM_CHARS[version]
    vec = np.zeros(size, dtype=np.float64)
    for ch in segment:
        if ch.isdigit():
            vec[ord(ch) - ord("0")] = 1.0
        elif ch.isalpha():
            if version == "nor" and ch == "æ":
                vec[36] = 1.0
            elif version == "nor" and ch == "ø":
                vec[37] = 1.0
            elif version == "nor" and ch == "å":
                vec[38] = 1.0
            elif "a" <= ch <= "z":
                vec[10 + ord(ch) - ord("a")] = 1.0
    return vec


def _bigram_histogram(segment: str, version: str) -> np.ndarray:
    bigrams = PHOC_BIGRAMS[version]
    vec = np.zeros(50, dtype=np.float64)
    for ch in segment:  # reference iterates chars, not char pairs
        if ch in bigrams:
            vec[bigrams.index(ch)] = 1.0
    return vec


def phoc_vector(word: str, version: str = "eng") -> np.ndarray:
    word = word.lower()
    length = len(word)
    chunks = []
    for split in range(2, 6):
        parts = length // split
        for mul in range(split - 1):
            chunks.append(_char_histogram(word[mul * parts : mul * parts + parts], version))
        chunks.append(_char_histogram(word[(split - 1) * parts : length], version))
    chunks.append(_bigram_histogram(word[: length // 2], version))
    chunks.append(_bigram_histogram(word[length // 2 : length], version))
    return np.concatenate(chunks)


def phoc_labels(words: list[str], version: str = "eng") -> dict[str, np.ndarray]:
    return {w: phoc_vector(w, version) for w in words}
