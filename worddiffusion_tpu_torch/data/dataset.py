"""Word dataset: samples -> model-ready records (copy of
``worddiffusion_tpu/data/dataset.py``'s ``WordImageDataset`` and
``LatentLookup``, reading images with the port's own PNG reader and
numpy resize instead of PIL).

A record is ``{image_name, word, context, writer}`` plus either
``latent`` [8, 32, 4] (the sample's entry in the latent cache) or
``image`` [H, W, 3] float32 in [-1, 1] (the word crop from
``cfg.image_dir``, resize-padded to H x W), and ``phosc`` [P] int32 (the
word's PHOSC ids) with ``use_phosc``. The options add ``style_vec`` [D]
float32 (the writer's entry in ``style_lookup``) and ``ocr_ids``
[max_chars] / ``ocr_len`` int32 (the word's CTC targets in
``ocr_alphabet``). A sample with neither a cache entry nor an image file
raises ``FileNotFoundError``: the JAX dataset's fallback, the synthetic
renderer, is not ported (ROADMAP A.2), nor are glyph images (A.6).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..configs.config import DataConfig
from ..ops.ctc import encode_ocr_labels
from ..utils.images import normalize_to_unit, resize_and_pad
from .gt import Sample, WriterRegistry
from .phosc import phosc_vector
from .png import read_png
from .tokenizer import Tokenizer


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
        latent_cache: Optional[LatentLookup] = None,
        use_phosc: bool = False,
        ocr_alphabet: Optional[str] = None,
        style_lookup: Optional[dict] = None,
    ):
        """Every sample comes from ``latent_cache`` or, without one, from
        its image file; a cache that holds some of the samples but not all
        raises (the batches would mix latents and images)."""
        self.samples = list(samples)
        self.registry = registry
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.latent_cache = latent_cache
        self.use_phosc = use_phosc
        self.ocr_alphabet = ocr_alphabet
        self.style_lookup = style_lookup
        self._phosc_cache: dict[str, np.ndarray] = {}
        if latent_cache is not None:
            missing = [s.image for s in self.samples if s.image not in latent_cache]
            if missing:
                raise ValueError(
                    f"{len(missing)} of {len(self.samples)} sample(s) are not in the latent "
                    f"cache (first: {missing[0]!r}); build the cache over the whole corpus "
                    "(cli.build_latent_cache) or train from the images without one")
        else:
            for s in self.samples:
                self._image_path(s)

    def __len__(self) -> int:
        return len(self.samples)

    def _image_path(self, sample: Sample) -> str:
        path = os.path.join(self.cfg.image_dir, sample.image) if self.cfg.image_dir else ""
        if not path or not os.path.isfile(path):
            raise FileNotFoundError(
                f"no image file for sample {sample.image!r} (looked for {path or 'it'}: "
                f"image_dir is {self.cfg.image_dir!r}); the JAX dataset renders a missing "
                "image with the synthetic renderer, which is not ported (ROADMAP A.2)")
        return path

    def _load_image(self, sample: Sample) -> np.ndarray:
        img = read_png(self._image_path(sample))
        if img.shape[:2] != (self.cfg.img_height, self.cfg.img_width):
            img = resize_and_pad(img, self.cfg.img_height, self.cfg.img_width)
        return img

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
        }
        if self.latent_cache is not None:
            rec["latent"] = self.latent_cache[s.image]
        else:
            rec["image"] = normalize_to_unit(self._load_image(s))
        if self.use_phosc:
            rec["phosc"] = self._phosc(s.word)
        if self.style_lookup is not None:
            if s.writer not in self.style_lookup:
                raise KeyError(f"style_lookup has no vector for writer {s.writer!r} (the "
                               "--style_dict must cover every writer of the corpus)")
            rec["style_vec"] = np.asarray(self.style_lookup[s.writer], np.float32)
        if self.ocr_alphabet is not None:
            ids, lens = encode_ocr_labels([s.word], self.ocr_alphabet, self.cfg.max_chars)
            rec["ocr_ids"], rec["ocr_len"] = ids[0], lens[0]
        return rec
