"""Build ``data/jpeg_check.npz``: small JPEG files of every mode
``data/jpeg.py`` decodes, each beside Pillow's decode of it, so that the
decoder can be held against Pillow where there is none (the GPU machine).

    python -m worddiffusion_tpu_torch.data.make_jpeg_check

Needs Pillow. The files are seeded word renders (``synthetic.render_word``
with noise added): Pillow writes the baseline and progressive ones (4:4:4,
4:2:2, 4:2:0 and grey, with and without restart markers, odd sizes, the
RGB colour space under an Adobe marker); ``encode_baseline`` below writes
what Pillow cannot: 4:4:0, 4:1:1, mixed factors, scans of one component
each, Adobe transform 1 and the component-id rules. It prints how many
decode bitwise as Pillow's.
"""

from __future__ import annotations

import io
import os

import numpy as np

from . import synthetic

CHECK_FILE = os.path.join(os.path.dirname(__file__), "jpeg_check.npz")
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# IJG's luminance table (JPEG Annex K.1), scaled by quality as libjpeg does
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])
# every (run, size) symbol of an AC code, and the DC sizes
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
_DC_SYMBOLS = list(range(12))


def sample_image(h: int, w: int, seed: int, noise: float = 0.25) -> np.ndarray:
    """A seeded word render at h x w with uniform noise mixed in: uint8 RGB."""
    rng = np.random.default_rng(seed)
    word = synthetic.render_word(synthetic.WORDS_200[seed % len(synthetic.WORDS_200)],
                                 64, 256, seed=seed).astype(np.float64)
    ys = np.arange(h) * 64 // h
    xs = np.arange(w) * 256 // w
    tint = rng.uniform(0.6, 1.0, 3)
    img = word[ys][:, xs] * tint + noise * rng.uniform(-128, 128, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _quant(quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_LUMA_Q * scale + 50) // 100, 1, 255)


class _Bits:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def _size(v: int) -> int:
    return int(abs(v)).bit_length()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_baseline(img: np.ndarray, factors=((1, 1), (1, 1), (1, 1)), quality: int = 75,
                    restart: int = 0, markers: str = "jfif", ids=(1, 2, 3),
                    interleaved: bool = True, ycc: bool = True) -> bytes:
    """A baseline JPEG of ``img`` (uint8 [H, W, 3], or [H, W] for one
    component) with the given (h, v) sampling factors per component, one
    quantisation table, fixed-length Huffman codes (4 bits for DC sizes, 8
    for AC symbols: valid tables every decoder must take), ``restart``
    MCUs between RST markers, ``markers`` "jfif", "adobe0", "adobe1" or
    "none", the component ``ids``, one interleaved scan or one scan per
    component, and the colour transform to YCbCr (``ycc``) or none."""
    planes = [img.astype(np.float64)] if img.ndim == 2 else [
        img[..., i].astype(np.float64) for i in range(3)]
    if ycc and len(planes) == 3:
        r, g, b = planes
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    factors = factors[:len(planes)]
    h, w = img.shape[:2]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    q = _quant(quality)
    blocks = []
    for plane, (fh, fv) in zip(planes, factors):
        sx, sy = hmax // fh, vmax // fv
        cw, chh = -(-w * fh // hmax), -(-h * fv // vmax)
        padded = np.pad(plane, ((0, chh * sy - h), (0, cw * sx - w)), mode="edge")
        small = padded.reshape(chh, sy, cw, sx).mean(axis=(1, 3))
        bw, bh = mcux * fh * 8, mcuy * fv * 8
        small = np.pad(small, ((0, bh - chh), (0, bw - cw)), mode="edge") - 128
        tiles = small.reshape(bh // 8, 8, bw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, tiles, _DCT).reshape(bh // 8, bw // 8, 64)
        blocks.append(np.round(coef[..., ZIGZAG] / q).astype(np.int64))

    def units(comps):
        if len(comps) == 1:  # a lone component's own grid
            c = comps[0]
            fh, fv = factors[c]
            cw, chh = -(-w * fh // hmax), -(-h * fv // vmax)
            return [[(c, y, x)] for y in range(-(-chh // 8)) for x in range(-(-cw // 8))]
        return [[(c, my * factors[c][1] + v, mx * factors[c][0] + u)
                 for c in comps for v in range(factors[c][1]) for u in range(factors[c][0])]
                for my in range(mcuy) for mx in range(mcux)]

    def scan(comps) -> bytes:
        bits, out, pred = _Bits(), bytearray(), {c: 0 for c in comps}
        for m, unit in enumerate(units(comps)):
            if restart and m and m % restart == 0:
                out += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                pred = {c: 0 for c in comps}
            for c, y, x in unit:
                blk = blocks[c][y, x]
                diff, pred[c] = int(blk[0]) - pred[c], int(blk[0])
                s = _size(diff)
                bits.put(_DC_SYMBOLS.index(s), 4)
                bits.put(diff if diff >= 0 else diff - 1, s)
                run = 0
                last = max((i for i in range(1, 64) if blk[i]), default=0)
                for i in range(1, last + 1):
                    v = int(blk[i])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(_AC_SYMBOLS.index(0xF0), 8)
                        run -= 16
                    s = _size(v)
                    bits.put(_AC_SYMBOLS.index((run << 4) | s), 8)
                    bits.put(v if v >= 0 else v - 1, s)
                    run = 0
                if last < 63:
                    bits.put(_AC_SYMBOLS.index(0x00), 8)
        out += bits.flush()
        head = bytes([len(comps)]) + b"".join(bytes([ids[c], 0x00]) for c in comps)
        return _segment(0xDA, head + bytes([0, 63, 0])) + bytes(out)

    out = bytearray(b"\xff\xd8")
    if markers == "jfif":
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif markers.startswith("adobe"):
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([int(markers[5:])]))
    out += _segment(0xDB, bytes([0]) + bytes(q.astype(np.uint8)))
    out += _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes([len(planes)]) + b"".join(
                        bytes([ids[i], (fh << 4) | fv, 0]) for i, (fh, fv) in enumerate(factors)))
    dc = bytes([0, 0, 0, len(_DC_SYMBOLS)] + [0] * 12) + bytes(_DC_SYMBOLS)
    ac = bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8) + bytes(_AC_SYMBOLS)
    out += _segment(0xC4, b"\x00" + dc + b"\x10" + ac)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    comps = list(range(len(planes)))
    for group in ([comps] if interleaved else [[c] for c in comps]):
        out += scan(group)
    return bytes(out + b"\xff\xd9")


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_decode(raw: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def check_cases() -> dict[str, bytes]:
    """name -> JPEG bytes, one or more per mode."""
    cases: dict[str, bytes] = {}
    for i, (h, w, kw) in enumerate([
            (64, 256, dict(quality=75)),
            (37, 61, dict(quality=50, subsampling=0)),
            (37, 61, dict(quality=95, subsampling=1)),
            (9, 250, dict(quality=85, subsampling=2, restart_marker_blocks=3)),
            (64, 256, dict(quality=75, progressive=True)),
            (21, 7, dict(quality=60, progressive=True, subsampling=0)),
            (33, 49, dict(quality=90, progressive=True, subsampling=1,
                          restart_marker_rows=1)),
            (7, 1, dict(quality=75, subsampling=2)),
            (1, 9, dict(quality=75, progressive=True, subsampling=2)),
            (40, 40, dict(quality=80, keep_rgb=True)),
    ]):
        name = "pil_" + "_".join(f"{k}{v}" for k, v in kw.items()) + f"_{h}x{w}"
        cases[name] = pil_jpeg(sample_image(h, w, seed=i), **kw)
    grey = sample_image(29, 45, seed=20)[..., 0]
    cases["pil_grey_29x45"] = pil_jpeg(grey, quality=70)
    cases["pil_grey_progressive_29x45"] = pil_jpeg(grey, quality=70, progressive=True)
    for i, (name, h, w, kw) in enumerate([
            ("enc_440", 31, 45, dict(factors=((1, 2), (1, 1), (1, 1)))),
            ("enc_411", 19, 70, dict(factors=((4, 1), (1, 1), (1, 1)), quality=60)),
            ("enc_mixed", 27, 43, dict(factors=((2, 2), (1, 2), (2, 1)), restart=2)),
            ("enc_noninterleaved_420", 25, 39, dict(factors=((2, 2), (1, 1), (1, 1)),
                                                    interleaved=False, restart=5)),
            ("enc_adobe1", 16, 24, dict(markers="adobe1")),
            ("enc_adobe0_rgb", 16, 24, dict(markers="adobe0", ycc=False)),
            ("enc_ids_rgb", 16, 24, dict(markers="none", ids=(82, 71, 66), ycc=False)),
            ("enc_ids_other", 16, 24, dict(markers="none", ids=(5, 6, 7))),
            ("enc_422_width2", 6, 2, dict(factors=((2, 1), (1, 1), (1, 1)))),
    ]):
        cases[name] = encode_baseline(sample_image(h, w, seed=40 + i), **kw)
    return cases


def main() -> None:
    from .jpeg import decode_jpeg

    cases = check_cases()
    arrays, same = {}, 0
    for i, (name, raw) in enumerate(cases.items()):
        want = pil_decode(raw)
        same += int(np.array_equal(decode_jpeg(raw, name), want))
        arrays[f"name_{i}"] = np.array(name)
        arrays[f"jpeg_{i}"] = np.frombuffer(raw, np.uint8)
        arrays[f"rgb_{i}"] = want
    from PIL import Image, features

    arrays["pillow"] = np.array(f"Pillow {Image.__version__}, libjpeg-turbo "
                                f"{features.version('libjpeg_turbo')}")
    np.savez_compressed(CHECK_FILE, **arrays)
    print(f"{CHECK_FILE}: {len(cases)} files, {same} decoded bitwise as {arrays['pillow']}")


if __name__ == "__main__":
    main()
