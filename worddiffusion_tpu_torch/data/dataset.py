"""Word dataset: samples -> model-ready records (copy of
``worddiffusion_tpu/data/dataset.py``'s ``WordImageDataset`` and
``LatentLookup``, reading images with the port's own PNG and JPEG
reader, ``data.png.read_image``, and numpy resize instead of PIL).

A record is ``{image_name, word, context, writer}`` plus either
``latent`` [8, 32, 4] (the sample's entry in the latent cache) or
``image`` [H, W, 3] float32 in [-1, 1] (the word crop from
``cfg.image_dir``, resize-padded to H x W), and ``phosc`` [P] int32 (the
word's PHOSC ids) with ``use_phosc``. The options add ``style_vec`` [D]
float32 (the writer's entry in ``style_lookup``) and ``ocr_ids``
[max_chars] / ``ocr_len`` int32 (the word's CTC targets in
``ocr_alphabet``), and ``char_images`` [max_chars, gh, gw, 1] float32
(``char_glyphs``). A sample with no image file is drawn by the synthetic
renderer (``data.synthetic.render_word``, seeded by its image name; in its
writer's style with ``writer_styled``), as the JAX dataset does.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

from ..configs.config import DataConfig
from ..ops.ctc import encode_ocr_labels
from ..utils.images import normalize_to_unit, resize_and_pad
from .gt import Sample, WriterRegistry
from .phosc import phosc_vector
from .png import read_image
from .synthetic import render_word, stable_seed, writer_style
from .tokenizer import Tokenizer


def char_glyphs(word: str, max_chars: int, size: tuple,
                cache: Optional[dict] = None) -> np.ndarray:
    """[max_chars, gh, gw, 1] glyph crops in [-1, 1] (the charImages
    conditioning); unused slots stay white (+1). Copy of
    ``worddiffusion_tpu/data/dataset.py::char_glyphs``: the training dataset
    and the sampling CLI share it, so inference glyphs match the training
    renders exactly."""
    gh, gw = size
    cache = cache if cache is not None else {}
    slots = np.ones((max_chars, gh, gw, 1), np.float32)
    for i, c in enumerate(word[:max_chars]):
        if c not in cache:
            g = render_word(c, gh, gw, seed=0, jitter=False)
            g = normalize_to_unit(g).mean(axis=-1, keepdims=True)
            cache[c] = g.astype(np.float32)
        slots[i] = cache[c]
    return slots


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
        char_images: bool = False,
        char_image_size: tuple = (16, 16),
        writer_styled: bool = False,
        augment_fn: Optional[Callable] = None,
        seed: int = 0,
    ):
        """Every sample comes from ``latent_cache`` or, without one, from
        its image file or the renderer; a cache that holds some of the
        samples but not all raises (the batches would mix latents and
        images). ``writer_styled``: the renders use the writer's style
        (``synthetic.writer_style``), the signal style-vector training
        needs. ``augment_fn(uint8 image, rng)`` (``data.augment.random_augment``,
        ``--augMaps``) transforms each loaded image with draws from
        ``np.random.default_rng((seed, epoch, index))`` (``set_epoch``), so
        that an image's draws do not depend on which process loads it or in
        what order: n processes augment as one does, and a resumed run as
        the uninterrupted one. The JAX dataset draws from one
        ``default_rng(seed)`` stream in load order instead (ROADMAP C)."""
        self.samples = list(samples)
        self.registry = registry
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.latent_cache = latent_cache
        self.use_phosc = use_phosc
        self.ocr_alphabet = ocr_alphabet
        self.style_lookup = style_lookup
        self.char_images = char_images
        self.char_image_size = tuple(char_image_size)
        self.writer_styled = writer_styled
        self.augment_fn = augment_fn
        self.seed, self.epoch = seed, 0
        self._phosc_cache: dict[str, np.ndarray] = {}
        self._glyph_cache: dict[str, np.ndarray] = {}
        if latent_cache is not None:
            missing = [s.image for s in self.samples if s.image not in latent_cache]
            if missing:
                raise ValueError(
                    f"{len(missing)} of {len(self.samples)} sample(s) are not in the latent "
                    f"cache (first: {missing[0]!r}); build the cache over the whole corpus "
                    "(cli.build_latent_cache) or train from the images without one")

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch(self, epoch: int) -> None:
        """The epoch the augmentation draws of the next loads are keyed by."""
        self.epoch = epoch

    def _load_image(self, sample: Sample, idx: int) -> np.ndarray:
        path = os.path.join(self.cfg.image_dir, sample.image) if self.cfg.image_dir else ""
        if path and os.path.exists(path):
            img = read_image(path)
        else:
            img = render_word(sample.word, self.cfg.img_height, self.cfg.img_width,
                              seed=stable_seed(sample.image),
                              style=writer_style(sample.writer) if self.writer_styled else None)
        if img.shape[:2] != (self.cfg.img_height, self.cfg.img_width):
            img = resize_and_pad(img, self.cfg.img_height, self.cfg.img_width)
        if self.augment_fn is not None:
            img = self.augment_fn(img, np.random.default_rng((self.seed, self.epoch, idx)))
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
            rec["image"] = normalize_to_unit(self._load_image(s, idx))
        if self.use_phosc:
            rec["phosc"] = self._phosc(s.word)
        if self.style_lookup is not None:
            if s.writer not in self.style_lookup:
                raise KeyError(f"style_lookup has no vector for writer {s.writer!r} (the "
                               "--style_dict must cover every writer of the corpus)")
            rec["style_vec"] = np.asarray(self.style_lookup[s.writer], np.float32)
        if self.char_images:
            rec["char_images"] = char_glyphs(s.word, self.cfg.max_chars, self.char_image_size,
                                             self._glyph_cache)
        if self.ocr_alphabet is not None:
            ids, lens = encode_ocr_labels([s.word], self.ocr_alphabet, self.cfg.max_chars)
            rec["ocr_ids"], rec["ocr_len"] = ids[0], lens[0]
        return rec
