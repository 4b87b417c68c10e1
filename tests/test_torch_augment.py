"""The port's host-side image code against the JAX package's PIL and OpenCV
calls: every augmentation op (``data/augment.py``), ``random_augment`` on
the same generator draws, ``data/manipulate.resize_dataset`` (OpenCV's
INTER_LINEAR resize) and the PNG reader on every PNG variant PIL opens.

Bitwise everywhere but ``random_perspective``: OpenCV 5's float warp
kernel rounds some remainder lanes another way, so the port's warp is held
to a max abs difference of 1 on at most 0.05% of the values (measured:
at most 1e-4 of them, ROADMAP C)."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from worddiffusion_tpu.data import augment as jaug
from worddiffusion_tpu.data.manipulate import resize_dataset as jax_resize_dataset
from worddiffusion_tpu_torch.data import augment as aug
from worddiffusion_tpu_torch.data.manipulate import resize_dataset
from worddiffusion_tpu_torch.cli.train_ocr import grey
from worddiffusion_tpu_torch.data.png import decode_png
from worddiffusion_tpu_torch.data.synthetic import render_word

PERSPECTIVE_MAX, PERSPECTIVE_SHARE = 1, 5e-4


def _images():
    rng = np.random.default_rng(0)
    return [render_word("Mississippi", 64, 256, seed=1), render_word("qz", 50, 250, seed=2),
            rng.integers(0, 256, (64, 256, 3), dtype=np.uint8),
            rng.integers(0, 256, (37, 101, 3), dtype=np.uint8)]


def _same(got, want, op):
    assert got.dtype == np.uint8 and got.shape == want.shape, op
    if op == "random_perspective":
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= PERSPECTIVE_MAX and np.mean(d > 0) <= PERSPECTIVE_SHARE, (d.max(),
                                                                                   np.mean(d > 0))
    else:
        np.testing.assert_array_equal(got, want, err_msg=op)


OPS = {
    "shear_x": lambda m, im, r: m.shear_x(im, float(r.uniform(-0.3, 0.3))),
    "shear_y": lambda m, im, r: m.shear_y(im, float(r.uniform(-0.05, 0.05))),
    "erode": lambda m, im, r: m.erode(im, 2),
    "dilate": lambda m, im, r: m.dilate(im, 1),
    "sharpness": lambda m, im, r: m.sharpness(im, float(r.uniform(0.0, 3.0))),
    "blur": lambda m, im, r: m.blur(im, float(r.uniform(0.5, 1.5))),
    "rotate": lambda m, im, r: m.rotate(im, r),
    "random_perspective": lambda m, im, r: m.random_perspective(im, r, 0.3),
    "noise": lambda m, im, r: m.noise(im, r),
    "random_erase": lambda m, im, r: m.random_erase(im, r),
    "vertical_line_eraser": lambda m, im, r: m.vertical_line_eraser(im, r),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_augment_op_matches_jax(op):
    """Each op on rendered words and random images, three parameter draws
    each, from generators in the same state on both sides."""
    for i, im in enumerate(_images()):
        for seed in range(3):
            want = OPS[op](jaug, im, np.random.default_rng(seed))
            got = OPS[op](aug, im, np.random.default_rng(seed))
            _same(got, want, op)


def test_random_augment_matches_jax():
    """Same generator, same op and parameters: 60 draws over the images,
    every one of the nine default ops picked."""
    picked = set()
    for seed in range(60):
        im = _images()[seed % 4]
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        op = jaug.DEFAULT_OPS[int(np.random.default_rng(seed).integers(0, 9))]
        picked.add(op)
        _same(aug.random_augment(im, r2), jaug.random_augment(im, r1), op)
        assert r1.random() == r2.random()  # the draws stay in step
    assert picked == set(jaug.DEFAULT_OPS)


def test_rgb_fill_is_pil_packed_red():
    """PIL reads fillcolor=255 on an RGB image as the packed pixel (255, 0,
    0): the JAX ops' borders are red, and so are the port's."""
    white = np.full((20, 40, 3), 255, np.uint8)
    out = aug.shear_x(white, 0.3)
    assert (out == [255, 0, 0]).all(-1).any()
    np.testing.assert_array_equal(out, jaug.shear_x(white, 0.3))
    assert aug.shear_x(white[..., 0], 0.3).min() == 255  # "L": 255 is white


def test_resize_dataset_matches_opencv():
    """cv2.resize INTER_LINEAR to 250x50, down and up, grey and RGB: bitwise."""
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8) for s in
            [(64, 256, 3), (37, 120, 3), (120, 500, 3), (64, 256), (50, 250, 3), (51, 249),
             (200, 900, 3), (10, 20, 3)]] + [render_word("hello", 64, 256, seed=3)]
    for got, want in zip(resize_dataset(imgs), jax_resize_dataset(imgs)):
        np.testing.assert_array_equal(got, want)
    assert resize_dataset(imgs[:1], 32, 128)[0].shape == (32, 128, 3)


# --- PNG: an encoder for every colour type, bit depth, filter and Adam7 ---

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _filtered(px, depth):
    """Rows of samples -> filtered scanlines, the filter types cycling
    None, Sub, Up, Average, Paeth."""
    h, w, c = px.shape
    if depth == 16:
        rows = px.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, -1)
    else:
        v = px.reshape(h, -1).astype(np.uint8)
        bits = np.stack([(v >> (depth - 1 - i)) & 1 for i in range(depth)], -1).reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    bpp = max(1, c * depth // 8)
    out, prior = b"", np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        r, ft = rows[y].astype(np.int64), y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:len(r)]
        if ft == 0:
            f = r
        elif ft == 1:
            f = r - left
        elif ft == 2:
            f = r - prior
        elif ft == 3:
            f = r - ((left + prior) >> 1)
        else:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            f = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        out += bytes([ft]) + (f & 255).astype(np.uint8).tobytes()
        prior = r
    return out


def _encode(px, ctype, depth, interlace, palette=None, trns=None):
    h, w, _ = px.shape
    if interlace:
        raw = b"".join(_filtered(px[y0::dy, x0::dx], depth) for x0, y0, dx, dy in _ADAM7
                       if px[y0::dy, x0::dx].size)
    else:
        raw = _filtered(px, depth)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
                                         (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
                                         (6, 16)])
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
def test_png_variant_matches_pil(ctype, depth, interlace):
    """Every colour type at every bit depth PNG allows, plain and Adam7,
    every scanline filter, a palette with tRNS and shorter than the indices
    reach, 16-bit grey above 255: bitwise PIL's convert("RGB") and, through
    ``cli.train_ocr.grey``, convert("L"), at sizes that leave Adam7 passes
    empty."""
    rng = np.random.default_rng(depth * 10 + ctype)
    for h, w in ((13, 37), (1, 1), (3, 250)):
        px = rng.integers(0, 1 << depth, (h, w, _CHANNELS[ctype]))
        palette = trns = None
        if ctype == 3:
            palette = rng.integers(0, 256, (max(1, (1 << depth) - 1) if depth < 8 else 200, 3))
            trns = bytes(rng.integers(0, 256, 3).astype(np.uint8))
        data = _encode(px, ctype, depth, interlace, palette, trns)
        got = decode_png(data)
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        np.testing.assert_array_equal(grey(got)[..., 0],
                                      np.asarray(Image.open(io.BytesIO(data)).convert("L")))
