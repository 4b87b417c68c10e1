"""Word dataset in latent-cache mode (PIL-free copy of the latent path of
``worddiffusion_tpu/data/dataset.py``: ``WordImageDataset`` and
``LatentLookup``; that module imports PIL through ``utils/images.py``).

A record is ``{image_name, word, context, writer, latent}``, plus
``phosc`` [P] int32 (the word's PHOSC ids) with ``use_phosc``. Every
sample must be in the cache: encoding images needs the VAE encoder,
which is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from worddiffusion_tpu.configs.config import DataConfig
from worddiffusion_tpu.data.gt import Sample, WriterRegistry
from worddiffusion_tpu.data.phosc import phosc_vector
from worddiffusion_tpu.data.tokenizer import Tokenizer


class LatentLookup:
    """image name -> precomputed VAE latent (copy of
    ``worddiffusion_tpu/data/dataset.py::LatentLookup``)."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        self._arrays = arrays

    def __contains__(self, name: str) -> bool:
        return name in self._arrays

    def __getitem__(self, name: str) -> np.ndarray:
        return self._arrays[name]

    def __len__(self) -> int:
        return len(self._arrays)

    @classmethod
    def load(cls, path: str) -> "LatentLookup":
        with np.load(path, allow_pickle=False) as z:
            return cls({k: z[k] for k in z.files})


class WordImageDataset:
    def __init__(
        self,
        samples: Sequence[Sample],
        registry: WriterRegistry,
        tokenizer: Tokenizer,
        cfg: DataConfig,
        latent_cache: LatentLookup,
        use_phosc: bool = False,
    ):
        self.samples = list(samples)
        self.registry = registry
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.latent_cache = latent_cache
        self.use_phosc = use_phosc
        self._phosc_cache: dict[str, np.ndarray] = {}
        missing = [s.image for s in self.samples if s.image not in latent_cache]
        if missing:
            raise NotImplementedError(
                f"{len(missing)} sample(s) are not in the latent cache (first: "
                f"{missing[0]!r}); encoding images needs the VAE encoder, which "
                "is not ported yet"
            )

    def __len__(self) -> int:
        return len(self.samples)

    def _phosc(self, word: str) -> np.ndarray:
        if word not in self._phosc_cache:
            self._phosc_cache[word] = phosc_vector(
                word, self.cfg.phos_version, as_int=True).astype(np.int32)
        return self._phosc_cache[word]

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx]
        rec = {
            "image_name": s.image,
            "word": s.word,
            "context": self.tokenizer.encode(s.word),
            "writer": np.int32(self.registry[s.writer] if s.writer in self.registry else 0),
            "latent": self.latent_cache[s.image],
        }
        if self.use_phosc:
            rec["phosc"] = self._phosc(s.word)
        return rec
