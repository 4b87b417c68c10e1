"""Word-crop resizing, normalisation, regeneration output naming, preview
grids and a stdlib PNG writer.

``resize_and_pad``, ``normalize_to_unit``, ``crop_whitespace``,
``regen_filename``, ``save_single_images`` and ``save_image_grid`` are
copied from ``worddiffusion_tpu/utils/images.py``, which uses PIL and
OpenCV (and a native library for the normalisation, here
``data.native``'s copy of it): here the resize is
PIL's ``BILINEAR`` resampling and the whitespace crop OpenCV's
grey conversion, Otsu threshold and bounding box, written out in numpy,
and the PNG encoder uses only ``zlib`` and ``struct``. (Reading PNGs:
``data.png``.)
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

# PNG color type by channel count: gray, gray+alpha, RGB, RGBA
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


_PRECISION_BITS = 22  # PIL's fixed-point coefficients for 8-bit images (32 - 8 - 2)


def _bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's resampling coefficients (``Resample.c::precompute_coeffs`` with
    the triangle filter, support 1 widened by the downscale factor, then
    ``normalize_coeffs_8bpc``): for each output index its input indices and
    fixed-point integer weights, [out_size, taps] each (unused taps weigh 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    taps = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, taps), np.int64)
    wts = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws, total = [], 0.0
        for x in range(xmax):
            arg = abs((x + xmin - center + 0.5) * ss)
            wgt = 1.0 - arg if arg < 1.0 else 0.0
            ws.append(wgt)
            total += wgt
        for x, wgt in enumerate(ws):
            k = wgt / total if total != 0.0 else wgt
            idx[xx, x] = xmin + x
            wts[xx, x] = int(0.5 + k * (1 << _PRECISION_BITS))
    return idx, wts


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's separable resize along ``axis`` (0 rows, 1 columns)
    of uint8 [H, W, C]: integer sums rounded at half and clipped to uint8."""
    idx, wts = _bilinear_taps(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.zeros((out_size,) + src.shape[1:], np.int64)
    for k in range(idx.shape[1]):
        acc += wts[:, k].reshape((-1,) + (1,) * (src.ndim - 1)) * src[idx[:, k]]
    out = np.clip((acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def resize_and_pad(img: np.ndarray, height: int = 64, width: int = 256,
                   pad_value: int = 255) -> np.ndarray:
    """uint8 HWC (or HW / HW1) -> [height, width, ...]: scale to the target
    height (and down to the target width if needed) with PIL's BILINEAR
    resampling (horizontal pass, then vertical, as PIL runs them),
    right-pad with white."""
    squeeze2d = img.ndim == 2
    a = img[:, :, None] if squeeze2d else img
    h, w = a.shape[:2]
    new_w = max(1, min(width, int(round(w * height / h))))
    if new_w != w:
        a = _resample_axis(a, new_w, axis=1)
    if height != h:
        a = _resample_axis(a, height, axis=0)
    canvas = np.full((height, width) + img.shape[2:], pad_value, np.uint8)
    canvas[:, :new_w] = a[:, :, 0] if squeeze2d else a
    return canvas


def normalize_to_unit(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (ToTensor + Normalize(0.5, 0.5),
    ``trainModifyCondition.py:933-935``). uint8 input takes the host C pass
    (``data.native.batch_normalize``), as in the JAX package."""
    if img.dtype == np.uint8:
        from ..data import native

        return native.batch_normalize(img)
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


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
    unchanged. float32 takes the host C pass
    (``data.native.batch_denormalize``: half rounds up, as the JAX package's
    PNGs do); other floats round half to even."""
    if img.dtype == np.uint8:
        return img
    if img.dtype == np.float32:
        from ..data import native

        return native.batch_denormalize(img)
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _otsu_threshold(gray: np.ndarray) -> int:
    """OpenCV's Otsu threshold of a uint8 image (``getThreshVal_Otsu_8u``):
    the first level that maximises the between-class variance, in float64,
    levels where either class holds under FLT_EPSILON of the mass skipped."""
    hist = np.bincount(gray.ravel(), minlength=256).astype(np.float64)
    scale = 1.0 / gray.size
    mu = float((np.arange(256) * hist).sum()) * scale
    flt_eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = max_sigma = 0.0
    best = 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < flt_eps or max(q1, q2) > 1.0 - flt_eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, best = sigma, i
    return best


def crop_whitespace(img: np.ndarray) -> np.ndarray:
    """Otsu-threshold bounding-box crop of a uint8 word image, grey [H, W]
    or RGB [H, W, 3] (``sampling.py:16-23``): the box of the pixels at or
    below the threshold (the ink); the image unchanged when there are none.
    The grey level is OpenCV's ``COLOR_RGB2GRAY`` fixed-point rounding."""
    if img.ndim == 2:
        gray = img
    else:
        r, g, b = (img[..., i].astype(np.int32) for i in range(3))
        gray = ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)
    ys, xs = np.nonzero(gray <= _otsu_threshold(gray))
    if ys.size == 0:
        return img
    return img[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


def center_on_canvas(
    imgs: np.ndarray, height: int, width: int, border_value: float = 0.0
) -> np.ndarray:
    """[B, h, w, C] float -> centered on [B, height, width, C] canvas
    (crop if larger), like the reference tensor_centered call."""
    b, h, w, c = imgs.shape
    out = np.full((b, height, width, c), border_value, imgs.dtype)
    sh = max(0, (h - height) // 2)
    sw = max(0, (w - width) // 2)
    ch = min(h, height)
    cw = min(w, width)
    dh = (height - ch) // 2
    dw = (width - cw) // 2
    out[:, dh : dh + ch, dw : dw + cw] = imgs[:, sh : sh + ch, sw : sw + cw]
    return out


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
