"""Regeneration output naming, preview grids and a stdlib PNG writer.

``regen_filename``, ``save_single_images`` and ``save_image_grid`` are
copied from ``worddiffusion_tpu/utils/images.py`` (that module imports
PIL); the PNG encoder here uses only ``zlib`` and ``struct``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

# PNG color type by channel count: gray, gray+alpha, RGB, RGBA
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG bytes, 8 bits per
    sample, no filtering, zlib level 1 (fast: PNG writes overlap the
    device work in the regeneration pipeline)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1-4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def denormalize_to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8 rounded to nearest; uint8 passes through
    unchanged."""
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def regen_filename(image_id: str, writer: str | int, word: str) -> str:
    """``{img}_{writer}_{word}.png`` naming of the regeneration output."""
    stem = os.path.splitext(image_id)[0]
    return f"{stem}_{writer}_{word}.png"


def save_single_images(
    images: np.ndarray, names: Sequence[str], out_dir: str
) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for img, name in zip(images, names):
        p = os.path.join(out_dir, name)
        with open(p, "wb") as f:
            f.write(encode_png(denormalize_to_uint8(img)))
        paths.append(p)
    return paths


def save_image_grid(images: np.ndarray, path: str, ncol: int = 8) -> None:
    """[B, H, W, C] float [0, 1] or uint8 -> one PNG grid, row-major,
    white where a row is short (the training's epoch preview)."""
    b, h, w, c = images.shape
    ncol = min(ncol, b)
    nrow = (b + ncol - 1) // ncol
    grid = np.full((nrow * h, ncol * w, c), 255, np.uint8)
    for i in range(b):
        r, cl = divmod(i, ncol)
        grid[r * h : (r + 1) * h, cl * w : (cl + 1) * w] = denormalize_to_uint8(images[i])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
