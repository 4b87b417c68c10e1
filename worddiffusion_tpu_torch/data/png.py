"""A PNG reader with the stdlib (``zlib``) and numpy: the port's counterpart
of ``np.asarray(Image.open(path).convert("RGB"))``
(``worddiffusion_tpu/data/dataset.py:118-120``), for word crops.

Reads 8-bit greyscale, greyscale + alpha, RGB, RGBA and palette images,
non-interlaced, with any of the five scanline filters; returns uint8
[H, W, 3] RGB. Grey is replicated to the three channels and alpha is
dropped, as PIL's ``convert("RGB")`` does; palette indices past the
palette read black. Interlaced, 16-bit and sub-byte images raise
``ValueError`` naming the file. (Writing: ``utils.images.encode_png``.)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per colour type: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(data: bytes, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-scanline filters -> uint8 [h, w * bpp]."""
    stride = w * bpp
    if len(data) < h * (stride + 1):
        raise ValueError(f"{path}: image data is {len(data)} bytes, want {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp).astype(np.uint32), axis=0).astype(np.uint8)
            cur = cur.reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte depends on its left neighbour
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
                else:
                    ul = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: scanline {y} has unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(raw: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB."""
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(raw):
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        tag, body = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit samples; the reader takes 8-bit PNGs only")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG; the reader takes non-interlaced PNGs only")
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp, path).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)
