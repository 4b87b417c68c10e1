"""The port's image input path against PIL and the JAX package: the PNG
reader (``data.png``) bitwise against ``Image.open(p).convert("RGB")``,
``resize_and_pad`` (PIL's BILINEAR in numpy) and ``normalize_to_unit``
against JAX's ``utils/images.py``, the dataset's image record and the
cache CLI's ordered pass against JAX's, and the safetensors reader
and writer against the ``safetensors`` package."""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from worddiffusion_tpu.configs.config import DataConfig
from worddiffusion_tpu.data import dataset as jdataset
from worddiffusion_tpu.data import loader as jloader
from worddiffusion_tpu.data.gt import Sample as JSample
from worddiffusion_tpu.data.gt import WriterRegistry as JRegistry
from worddiffusion_tpu.data.tokenizer import Tokenizer as JTokenizer
from worddiffusion_tpu.utils import images as jimages
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.data import loader, png
from worddiffusion_tpu_torch.data.dataset import WordImageDataset
from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
from worddiffusion_tpu_torch.utils import images, safetensors


def _word_image(h, w, seed):
    """White canvas with dark strokes and a smooth background ramp, so
    that an encoder picks several scanline filters."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    img[:] = np.linspace(200, 255, w).astype(np.uint8)[None, :, None]
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(2, 9), x:x + rng.integers(2, 30)] = rng.integers(0, 90, 3)
    return img


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reader_matches_pil(mode):
    im = Image.fromarray(_word_image(37, 91, seed=0))
    im = im.convert("P", palette=Image.ADAPTIVE, colors=40) if mode == "P" else im.convert(mode)
    if mode in ("LA", "RGBA"):
        alpha = np.random.default_rng(1).integers(0, 256, (37, 91)).astype(np.uint8)
        im.putalpha(Image.fromarray(alpha))
    buf = io.BytesIO()
    im.save(buf, "PNG")
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    got = png.decode_png(buf.getvalue())
    assert got.dtype == np.uint8 and got.shape == want.shape == (37, 91, 3)
    np.testing.assert_array_equal(got, want)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """An RGB PNG whose every scanline uses filter ``ftype`` (PIL's encoder
    never writes Average), encoded here from the filter's definition."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        cur, up = raw[y], raw[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_undoes_every_filter(ftype):
    img = _word_image(23, 40, seed=2)
    raw = _filtered_png(img, ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")), img)
    np.testing.assert_array_equal(png.decode_png(raw), img)


@pytest.mark.parametrize("kind", ["16-bit", "interlaced", "1-bit"])
def test_png_reader_refuses_what_it_does_not_read(tmp_path, kind):
    path = tmp_path / f"{kind}.png"
    if kind == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    elif kind == "1-bit":
        Image.fromarray(np.eye(8, dtype=bool)).save(path)
    else:
        raw = bytearray(_filtered_png(_word_image(8, 8, 3), 0))
        raw[28] = 1  # IHDR's interlace byte
        raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
        path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=str(path)):
        png.read_png(str(path))


@pytest.mark.parametrize("h,w,c", [(30, 20, 3), (150, 600, 3), (45, 300, 1), (100, 37, 3),
                                   (33, 1000, 3), (64, 256, 3), (61, 255, 3), (150, 80, 3)])
def test_resize_and_pad_matches_jax(h, w, c):
    """Within 1 grey level of PIL's resize (the JAX package's); this numpy
    version reproduces PIL's fixed-point arithmetic, and no pixel differs
    at any of these sizes."""
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, c)).astype(np.uint8)
    want = jimages.resize_and_pad(img, 64, 256)
    got = images.resize_and_pad(img, 64, 256)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and int((diff > 0).sum()) == 0, int((diff > 0).sum())


def test_resize_and_pad_2d_and_normalize_match_jax():
    img = _word_image(50, 120, seed=4)[..., 0]
    np.testing.assert_array_equal(images.resize_and_pad(img), jimages.resize_and_pad(img))
    full = _word_image(64, 256, seed=5)
    np.testing.assert_allclose(images.normalize_to_unit(full), jimages.normalize_to_unit(full),
                               rtol=0, atol=1e-6)


def _corpus(tmp_path, n=7):
    """n word PNGs of varied sizes, half grey, and samples naming them."""
    rng = np.random.default_rng(6)
    names = []
    for i in range(n):
        img = _word_image(int(rng.integers(30, 150)), int(rng.integers(20, 600)), seed=10 + i)
        Image.fromarray(img[..., 0] if i % 2 else img).save(tmp_path / f"w{i}.png")
        names.append(f"w{i}.png")
    words = "the of and to in is was".split()
    return [(name, f"{i % 3:03d}", words[i % len(words)]) for i, name in enumerate(names)]


def test_dataset_image_record_matches_jax(tmp_path):
    rows = _corpus(tmp_path)
    cfg = DataConfig(max_chars=10, image_dir=str(tmp_path))
    jreg, reg = JRegistry(), WriterRegistry()
    for _, wr, _ in rows:
        jreg.add(wr)
        reg.add(wr)
    jds = jdataset.WordImageDataset([JSample(image=a, writer=b, word=c) for a, b, c in rows], jreg,
                                    JTokenizer.from_name("eng_main", 10), cfg)
    ds = WordImageDataset([Sample(image=a, writer=b, word=c) for a, b, c in rows], reg,
                          Tokenizer.from_name("eng_main", 10), port_cfg(cfg))
    for i in range(len(rows)):
        want, got = jds[i], ds[i]
        assert sorted(got) == sorted(want) == ["context", "image", "image_name", "word", "writer"]
        assert got["image"].shape == (64, 256, 3) and got["image"].dtype == np.float32
        np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["context"], want["context"])
        assert got["writer"] == want["writer"]

    # the cache CLI's ordered pass: tail padded by repeating, as JAX's
    for bs in (3, 5):
        jb = [b["image_name"] for b in jloader.batches(jds, bs, shuffle=False,
                                                       drop_remainder=False)]
        pb = [b["image_name"] for b in loader.batches(ds, bs, shuffle=False,
                                                      drop_remainder=False)]
        assert pb == jb


def test_dataset_refuses_missing_images_and_partial_caches(tmp_path):
    from worddiffusion_tpu_torch.data.dataset import LatentLookup

    rows = _corpus(tmp_path, n=3)
    samples = [Sample(image=a, writer=b, word=c) for a, b, c in rows]
    cfg = port_cfg(DataConfig(max_chars=10, image_dir=str(tmp_path)))
    tok, reg = Tokenizer.from_name("eng_main", 10), WriterRegistry()
    # a sample without a file is drawn by the synthetic renderer, as the JAX
    # dataset draws it (once the renderer was ported, it no longer raises)
    missing = samples + [Sample(image="nope.png", writer="000", word="x")]
    drawn = WordImageDataset(missing, reg, tok, cfg)[3]["image"]
    jds = jdataset.WordImageDataset([JSample(s.image, s.writer, s.word) for s in missing],
                                    JRegistry(), JTokenizer.from_name("eng_main", 10),
                                    DataConfig(max_chars=10, image_dir=str(tmp_path)))
    assert np.array_equal(drawn, jds[3]["image"])
    partial = LatentLookup({samples[0].image: np.zeros((8, 32, 4), np.float32)})
    with pytest.raises(ValueError, match="2 of 3 sample"):
        WordImageDataset(samples, reg, tok, cfg, latent_cache=partial)


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import save_file as torch_save

    rng = np.random.default_rng(7)
    tensors = {"a.weight": torch.from_numpy(rng.standard_normal((3, 4, 1, 1)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal(5).astype(np.float16)),
               "c": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)).bfloat16()}
    torch_save(tensors, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    got = safetensors.load_file(str(tmp_path / "pkg.safetensors"))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    safetensors.save_file(tensors, str(tmp_path / "port.safetensors"))
    back = np_load(str(tmp_path / "port.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v.float().numpy())


def _crop_cases(kind: str, n: int, seed: int):
    """n seeded uint8 images of one kind, grey [H, W] or RGB [H, W, 3]."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 120))
        if kind == "word_rgb":
            yield _word_image(max(h, 9), max(w, 30), seed * 1000 + i)
        elif kind == "word_grey":
            yield _word_image(max(h, 9), max(w, 30), seed * 1000 + i)[..., 0]
        elif kind == "noise_rgb":
            yield rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        elif kind == "noise_grey":
            yield rng.integers(0, 256, (h, w), dtype=np.uint8)
        elif kind == "two_level":  # a bimodal page: ink spots on paper
            img = np.full((h, w), rng.integers(128, 256), np.uint8)
            img[rng.random((h, w)) < rng.random() * 0.2] = rng.integers(0, 128)
            yield img
        else:  # "flat": all white, all ink, one grey level, and one ink pixel
            level = (255, 0, int(rng.integers(1, 255)))[i % 3]
            img = np.full((h, w) if i % 2 else (h, w, 3), level, np.uint8)
            if i % 4 == 3:
                img[rng.integers(0, h), rng.integers(0, w)] = 0
            yield img


@pytest.mark.parametrize("kind", ["word_rgb", "word_grey", "noise_rgb", "noise_grey",
                                  "two_level", "flat"])
def test_crop_whitespace_matches_jax(kind):
    """The numpy Otsu crop bitwise against JAX's cv2 crop on 60 seeded
    uint8 images of each kind (360 in all), grey and RGB, all-white and
    all-ink ones among them."""
    pytest.importorskip("cv2")
    for img in _crop_cases(kind, 60, seed=zlib.crc32(kind.encode()) % 1000):
        got, want = images.crop_whitespace(img), jimages.crop_whitespace(img)
        assert got.shape == want.shape and np.array_equal(got, want), img.shape
