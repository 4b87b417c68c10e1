# Copy of the numpy bodies of worddiffusion_tpu/data/native.py: the port imports nothing of the JAX package.
"""Batch image preprocessing in numpy: resize + pad + normalise, normalise,
denormalise, vertical eraser lines.

These are the numpy fallbacks of the JAX package's ``data/native.py``. Its
ctypes binding to ``native/libwdimage.so`` (one C pass per batch) is left
out: whether the port wants it is for a benchmark of host-bound training
to decide (ROADMAP A.2), so every function here runs numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.images import normalize_to_unit, resize_and_pad


def batch_resize_pad_normalize(
    images: Sequence[np.ndarray], height: int, width: int
) -> np.ndarray:
    """list of uint8 HWC (variable size) -> float32 [N, height, width, C]
    in [-1, 1], white-padded."""
    return np.stack([
        normalize_to_unit(resize_and_pad(img, height, width)) for img in images
    ])


def batch_normalize(images: np.ndarray) -> np.ndarray:
    """uint8 [...] -> float32 [-1,1], same shape."""
    return (images.astype(np.float32) / 255.0 - 0.5) / 0.5


def batch_denormalize(images: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 (round-to-nearest)."""
    return (np.clip(images, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def vertical_lines(img: np.ndarray, xs: np.ndarray, value: int = 255) -> np.ndarray:
    """in-place vertical eraser lines; returns img."""
    img[:, xs[(xs >= 0) & (xs < img.shape[1])]] = value
    return img
