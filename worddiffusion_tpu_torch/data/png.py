"""A PNG reader with the stdlib (``zlib``) and numpy: the port's counterpart
of ``np.asarray(Image.open(path).convert("RGB"))``
(``worddiffusion_tpu/data/dataset.py:118-120``), for word crops.

Reads every PNG that PIL reads: greyscale (1, 2, 4, 8 and 16 bits),
greyscale + alpha, RGB and RGBA (8 and 16 bits), palette images (1, 2, 4
and 8 bits, with or without ``tRNS``), plain or Adam7-interlaced, with any
of the five scanline filters; returns uint8 [H, W, 3] RGB as PIL's
``convert("RGB")`` does: grey replicated to the three channels (1-bit as 0
or 255, 2- and 4-bit scaled by 85 and 17, 16-bit clipped at 255 as PIL's
``I;16`` to ``L``), 16-bit colour samples by their high byte, alpha and
``tRNS`` dropped, palette indices past the palette black (``convert("L")``
is ``cli.train_ocr.grey`` of that). (Writing: ``utils.images.encode_png``.)

``read_image`` is the port's one image reader: it dispatches on the file's
signature to this decoder or to ``data.jpeg``, as PIL's ``Image.open`` does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per colour type: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter(data: memoryview, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-scanline filters of ``h`` rows of ``stride`` bytes (``bpp``
    bytes a pixel, at least 1) -> uint8 [h, stride]."""
    if len(data) < h * (stride + 1):
        raise ValueError(f"{path}: image data is {len(data)} bytes, want {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per byte of the pixel, mod 256
            pad = (-stride) % bpp
            cur = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(cur.astype(np.uint32), axis=0).astype(np.uint8).reshape(-1)[:stride]
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


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> samples [h, w, channels] (uint8, or uint16 at 16
    bits; sub-byte samples unpacked most significant first)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows.reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = np.zeros(bits.shape[:2], np.uint8)
    for i in range(depth):
        vals = (vals << 1) | bits[..., i]
    return vals[:, : w * channels].reshape(h, w, channels)


def _decode_pass(data: memoryview, h: int, w: int, channels: int, depth: int,
                 path: str) -> tuple[np.ndarray, int]:
    """One (sub-)image -> (samples, bytes consumed)."""
    if h == 0 or w == 0:
        return np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8), 0
    stride = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    rows = _unfilter(data, h, stride, bpp, path)
    return _samples(rows, w, channels, depth), h * (stride + 1)


def _to_rgb(px: np.ndarray, ctype: int, depth: int, palette) -> np.ndarray:
    """Samples -> uint8 RGB as PIL's ``convert("RGB")``."""
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if ctype in (0, 4):
        g = px[..., 0]
        if depth == 16:
            g = np.minimum(g, 255) if ctype == 0 else g >> 8  # "I;16" -> "L" clips; LA;16B
        elif depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    rgb = px[..., :3]
    if depth == 16:
        rgb = rgb >> 8
    return np.ascontiguousarray(rgb.astype(np.uint8))


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
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: {depth}-bit samples are not valid for colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = _CHANNELS[ctype]
    data = memoryview(zlib.decompress(b"".join(idat)))
    if not interlace:
        px, _ = _decode_pass(data, h, w, channels, depth, path)
    else:
        px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
            px[y0::dy, x0::dx], used = _decode_pass(data[off:], ph, pw, channels, depth, path)
            off += used
    return _to_rgb(px, ctype, depth, palette)


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` -> uint8 [H, W, 3] RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)



# the signatures of the formats PIL also opens, for the refusal's message
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"RIFF", "RIFF (WebP)"), (b"\x00\x00\x00\x0cjP", "JPEG 2000"))


def read_image(path: str) -> np.ndarray:
    """The PNG or JPEG at ``path`` (by its signature, not its name) -> uint8
    [H, W, 3] RGB; any other format raises, naming it."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] == _SIGNATURE:
        return decode_png(raw, path)
    if raw[:2] == b"\xff\xd8":
        from .jpeg import decode_jpeg

        return decode_jpeg(raw, path)
    name = next((n for sig, n in _OTHER_FORMATS if raw.startswith(sig)),
                f"an unknown format (first bytes {raw[:8].hex()})")
    raise ValueError(f"{path}: {name} is not read here; the port reads PNG and JPEG")
