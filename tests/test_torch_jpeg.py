"""The port's JPEG decoder (``data/jpeg.py``) against Pillow, and every site
that reads a crop (``data.png.read_image``) against the JAX package's PIL
path.

The oracle is ``np.asarray(Image.open(f).convert("RGB"))`` (Pillow with
libjpeg-turbo, its default islow IDCT, fancy upsampling and fixed-point
colour tables); the decoder is held to it bitwise. The files are seeded word
renders with noise: Pillow writes baseline and progressive files (4:4:4,
4:2:2, 4:2:0, grey, restart intervals, widths 1, 7, 9, 61 and 250 and the
64x256 crop, quality 50-95, the RGB colour space); the check set's encoder
writes what Pillow cannot (4:4:0, 4:1:1, mixed factors, one scan per
component, Adobe transform 1, component ids). ``data/jpeg_check.npz`` is
held without Pillow, as the GPU machine holds it.
"""

import io
import os

import numpy as np
import pytest

from worddiffusion_tpu_torch.data import jpeg, png
from worddiffusion_tpu_torch.data.make_jpeg_check import (
    CHECK_FILE, check_cases, encode_baseline, sample_image)

# (height, width): the crop, and the edge widths of the fancy upsamplers
SIZES = ((64, 256), (13, 1), (9, 7), (17, 9), (31, 61), (5, 250))
RESTARTS = ({}, {"restart_marker_blocks": 2}, {"restart_marker_rows": 1})


def _pil():
    return pytest.importorskip("PIL.Image")


def _pil_decode(raw: bytes, mode: str = "RGB") -> np.ndarray:
    return np.asarray(_pil().open(io.BytesIO(raw)).convert(mode))


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    _pil().fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _check(raw: bytes, label: str) -> None:
    got, want = jpeg.decode_jpeg(raw, label), _pil_decode(raw)
    assert got.shape == want.shape and got.dtype == np.uint8, label
    assert np.array_equal(got, want), (label, np.abs(got.astype(int) - want).max())


@pytest.mark.parametrize("subsampling", [0, 1, 2, "grey"])
@pytest.mark.parametrize("progressive", [False, True])
def test_pillow_files_decode_bitwise(subsampling, progressive):
    """Every size, with and without restart markers, at a seeded quality in
    50..95."""
    rng = np.random.default_rng([[0, 1, 2, "grey"].index(subsampling), int(progressive)])
    for i, (h, w) in enumerate(SIZES):
        img = sample_image(h, w, seed=i)
        for restart in RESTARTS:
            kw = dict(quality=int(rng.integers(50, 96)), progressive=progressive, **restart)
            if subsampling == "grey":
                raw = _pil_jpeg(img[..., 1], **kw)
            else:
                raw = _pil_jpeg(img, subsampling=subsampling, **kw)
            _check(raw, f"{h}x{w} {subsampling} {kw}")


def test_pillow_rgb_colour_space_decodes_bitwise():
    """keep_rgb: no colour transform, an Adobe marker with transform 0."""
    for i, (h, w) in enumerate(SIZES[:3]):
        _check(_pil_jpeg(sample_image(h, w, seed=i), quality=80, keep_rgb=True), f"rgb {h}x{w}")


@pytest.mark.parametrize("factors", [
    ((1, 2), (1, 1), (1, 1)),   # 4:4:0: fancy h1v2
    ((4, 1), (1, 1), (1, 1)),   # 4:1:1: box replication
    ((2, 2), (1, 2), (2, 1)),   # h2v1 and h1v2 in one file
    ((2, 1), (1, 1), (1, 1)),   # 4:2:2, every width (<= 2 chroma columns: box)
    ((1, 1), (2, 2), (1, 1)),   # a chroma plane larger than luma's
])
def test_encoder_sampling_factors_decode_bitwise(factors):
    for i, (h, w) in enumerate(SIZES):
        for restart, interleaved in ((0, True), (3, True), (0, False)):
            raw = encode_baseline(sample_image(h, w, seed=20 + i), factors=factors,
                                  quality=50 + 9 * i, restart=restart, interleaved=interleaved)
            _check(raw, f"{h}x{w} {factors} restart {restart} interleaved {interleaved}")


@pytest.mark.parametrize("markers,ids,ycc", [
    ("adobe1", (1, 2, 3), True), ("adobe0", (1, 2, 3), False), ("none", (82, 71, 66), False),
    ("none", (5, 6, 7), True), ("jfif", (82, 71, 66), True)])
def test_colour_space_rules_decode_bitwise(markers, ids, ycc):
    """JFIF means YCbCr; else Adobe's transform; else the component ids
    ('R', 'G', 'B' means RGB), as libjpeg-turbo decides."""
    raw = encode_baseline(sample_image(21, 30, seed=3), markers=markers, ids=ids, ycc=ycc)
    _check(raw, f"{markers} {ids}")


def test_check_set_decodes_bitwise():
    """The committed check set, without Pillow: every file as Pillow decoded
    it when the set was made."""
    with np.load(CHECK_FILE) as z:
        n = sum(1 for k in z.files if k.startswith("name_"))
        names = [str(z[f"name_{i}"]) for i in range(n)]
        for i, name in enumerate(names):
            got = jpeg.decode_jpeg(z[f"jpeg_{i}"].tobytes(), name)
            assert np.array_equal(got, z[f"rgb_{i}"]), name
    # every mode is in it
    for mode in ("progressive", "subsampling0", "subsampling1", "subsampling2", "restart",
                 "grey", "keep_rgb", "440", "411", "mixed", "noninterleaved", "adobe1",
                 "ids_rgb", "x1", "1x9"):
        assert any(mode in name for name in names), mode


def test_check_set_is_current():
    """The committed files are those ``check_cases`` makes now, with
    Pillow's decodes."""
    _pil()
    cases = check_cases()
    with np.load(CHECK_FILE) as z:
        for i, (name, raw) in enumerate(cases.items()):
            assert str(z[f"name_{i}"]) == name
            assert z[f"jpeg_{i}"].tobytes() == raw, name
            assert np.array_equal(z[f"rgb_{i}"], _pil_decode(raw)), name


def _patched(raw: bytes, offset: int, value: int) -> bytes:
    return raw[:offset] + bytes([value]) + raw[offset + 1:]


def test_refused_modes_name_themselves():
    raw = encode_baseline(sample_image(16, 16, seed=0), markers="none")
    sof = raw.index(b"\xff\xc0")
    for marker, name in ((0xC9, "arithmetic coding"), (0xCA, "arithmetic coding"),
                         (0xC3, "lossless JPEG"), (0xC5, "hierarchical JPEG")):
        with pytest.raises(ValueError, match=f"f.jpg: {name}"):
            jpeg.decode_jpeg(_patched(raw, sof + 1, marker), "f.jpg")
    with pytest.raises(ValueError, match="12-bit samples are not supported"):
        jpeg.decode_jpeg(_patched(raw, sof + 4, 12), "f.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n", "f.jpg")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(raw[:sof + 6], "f.jpg")


def test_cmyk_refused():
    img = _pil().fromarray(sample_image(8, 8, seed=1)).convert("CMYK")
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    with pytest.raises(ValueError, match=r"4 components \(CMYK / YCCK\)"):
        jpeg.decode_jpeg(buf.getvalue())


# -- the sites that read crops ----------------------------------------------------
@pytest.fixture
def jpeg_crops(tmp_path):
    """Two JPEG crops under the names the gt file gives (.png: the reader
    goes by the signature) and a gt file over them."""
    crops = tmp_path / "crops"
    crops.mkdir()
    for i, kw in enumerate((dict(quality=75), dict(quality=90, progressive=True))):
        (crops / f"a01-00{i}u-00.png").write_bytes(_pil_jpeg(sample_image(40 + 9 * i, 150,
                                                                          seed=i), **kw))
    gt = tmp_path / "gt.filter27"
    gt.write_text("000,a01-000u-00 the\n001,a01-001u-00 of\n")
    return crops, gt


def test_read_image_dispatches_on_the_signature(jpeg_crops, tmp_path):
    crops, _ = jpeg_crops
    p = str(crops / "a01-000u-00.png")
    assert np.array_equal(png.read_image(p), _pil_decode(open(p, "rb").read()))
    (tmp_path / "x.png").write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="x.png: GIF is not read here"):
        png.read_image(str(tmp_path / "x.png"))


def test_dataset_reads_jpeg_as_jax(jpeg_crops):
    from worddiffusion_tpu.configs.config import DataConfig
    from worddiffusion_tpu.data import dataset as jdataset
    from worddiffusion_tpu.data.gt import Sample as JSample, WriterRegistry as JRegistry
    from worddiffusion_tpu.data.tokenizer import Tokenizer as JTokenizer
    from test_torch_copies import port_cfg
    from worddiffusion_tpu_torch.data.dataset import WordImageDataset
    from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
    from worddiffusion_tpu_torch.data.tokenizer import Tokenizer

    crops, _ = jpeg_crops
    rows = [("a01-000u-00.png", "000", "the"), ("a01-001u-00.png", "001", "of")]
    cfg = DataConfig(max_chars=10, image_dir=str(crops))
    jreg, reg = JRegistry(), WriterRegistry()
    jds = jdataset.WordImageDataset([JSample(*r) for r in rows], jreg,
                                    JTokenizer.from_name("eng_main", 10), cfg)
    ds = WordImageDataset([Sample(*r) for r in rows], reg, Tokenizer.from_name("eng_main", 10),
                          port_cfg(cfg))
    for i in range(len(rows)):
        assert np.array_equal(ds[i]["image"], jds[i]["image"])


def test_evaluate_reads_jpg_as_jax(jpeg_crops, tmp_path):
    from worddiffusion_tpu.cli import evaluate as jeval_cli
    from worddiffusion_tpu_torch.cli import evaluate as eval_cli

    crops, _ = jpeg_crops
    d = tmp_path / "fake"
    d.mkdir()
    for i, n in enumerate(sorted(os.listdir(crops))):
        (d / f"{i:05d}_3_w{i}.jpg").write_bytes((crops / n).read_bytes())
    (d / "00009_3_png.png").write_bytes(png_bytes(sample_image(20, 30, seed=9)))
    ours, theirs = eval_cli._load_dir(str(d), 64, 256), jeval_cli._load_dir(str(d), 64, 256)
    assert ours[1] == theirs[1] == ["w0", "w1", "png"]
    assert np.array_equal(ours[0], theirs[0])


def png_bytes(img):
    from worddiffusion_tpu_torch.utils.images import encode_png

    return encode_png(img)


def test_phosc_crop_reads_jpeg_as_jax(jpeg_crops):
    from worddiffusion_tpu.utils.images import resize_and_pad as jresize
    from worddiffusion_tpu_torch.cli import train_phosc

    crops, _ = jpeg_crops
    p = str(crops / "a01-001u-00.png")
    want = jresize(_pil_decode(open(p, "rb").read()), 50, 250)
    assert np.array_equal(train_phosc._load_crop(p), want)


def test_cond_image_reads_jpeg_as_jax(jpeg_crops):
    """``sample --cond_image`` in pixel space (no VAE): the image itself."""
    from worddiffusion_tpu.utils.images import normalize_to_unit, resize_and_pad
    from worddiffusion_tpu_torch.cli import sample as sample_cli
    from worddiffusion_tpu_torch.configs import presets

    crops, _ = jpeg_crops
    p = str(crops / "a01-000u-00.png")
    exp = presets.get("iam")
    want = normalize_to_unit(resize_and_pad(_pil_decode(open(p, "rb").read()),
                                            exp.data.img_height, exp.data.img_width))[None]
    assert np.array_equal(sample_cli.cond_latent(None, p, exp, "cpu"), want)


class _Read(Exception):
    """Stops a CLI at its first crop read."""


@pytest.mark.parametrize("cli", ["train_ocr", "train_style", "train_vae", "train_charcounter"])
def test_cli_reads_jpeg_crops(cli, jpeg_crops, tmp_path, monkeypatch):
    """Each side trainer reads its first crop through ``read_image``: the
    JPEG, decoded as PIL decodes it (``train_ocr`` then takes its grey as
    PIL's ``convert("L")``)."""
    import importlib

    from worddiffusion_tpu_torch.cli.train_ocr import grey
    from worddiffusion_tpu_torch.configs import presets
    from test_torch_copies import port_cfg
    from test_torch_train import tiny_exp

    crops, gt = jpeg_crops
    seen, real = [], png.read_image

    def spy(path):
        seen.append((path, real(path)))
        raise _Read

    monkeypatch.setattr(png, "read_image", spy)
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    argv = {"train_ocr": ["--gt_train", str(gt), "--batch_size", "2", "--epochs", "1"],
            "train_style": ["--gt_train", str(gt)],
            "train_vae": ["--preset", "tiny", "--gt_train", str(gt)],
            "train_charcounter": ["--gt_train", str(gt), "--batch_size", "2", "--epochs", "1"]
            }[cli]
    module = importlib.import_module(f"worddiffusion_tpu_torch.cli.{cli}")
    with pytest.raises(_Read):
        module.main(argv + ["--image_dir", str(crops), "--save_dir", str(tmp_path / "out"),
                            "--device", "cpu"])
    path, arr = seen[0]
    raw = open(path, "rb").read()
    assert os.path.dirname(path) == str(crops) and raw[:2] == b"\xff\xd8"
    assert np.array_equal(arr, _pil_decode(raw))
    if cli == "train_ocr":
        assert np.array_equal(grey(arr), _pil_decode(raw, "L")[..., None])
