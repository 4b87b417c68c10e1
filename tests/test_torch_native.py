"""The port's host C pass (``data/native.py`` over its copy of the JAX repo's
``wd_image.cpp``) against the JAX package's library-backed entry points,
and the PNG rounding it repairs.

- each of the four entry points bitwise JAX's, library against library, on
  seeded inputs: ragged widths, 1 and 3 channels, the 255 tie values
  ``(k + 0.5) / 255``, out-of-range eraser columns;
- ``utils.images.denormalize_to_uint8`` and the pixels ``save_single_images``
  writes (read back with ``data.png.read_image``) equal JAX's;
- under ``WD_NATIVE=0`` both packages run their numpy bodies;
- the fault the library repairs: the numpy body rounds half to even, so it
  and the library differ at 128 of the 255 ties;
- a build with a compiler that fails raises, naming the command; with
  ``$CXX`` failing the build takes ``g++``, and raises where that fails too.
"""

import os

import numpy as np
import pytest

from worddiffusion_tpu.data import native as jnative
from worddiffusion_tpu.utils import images as jimages
from worddiffusion_tpu_torch.data import native
from worddiffusion_tpu_torch.data.png import read_image
from worddiffusion_tpu_torch.utils import images

TIES = ((np.arange(255) + 0.5) / 255).astype(np.float32)


@pytest.fixture(autouse=True)
def library_on(monkeypatch):
    monkeypatch.delenv("WD_NATIVE", raising=False)
    assert jnative.preferred() and native.preferred()


def crops(seed: int, channels: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(h), int(w), channels), np.uint8)
            for h, w in zip(rng.integers(20, 90, 6), rng.integers(30, 600, 6))]


def decoder_like(seed: int, shape=(4, 64, 256, 3)):
    """Clipped normal(0.9, 0.2) float32, as the decoder's output looks, with
    the tie values and out-of-range values among it."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0.9, 0.2, shape), -0.1, 1.1).astype(np.float32)
    x.reshape(-1)[:255] = TIES
    return x


def test_library_is_the_ports_own_build():
    lib = native.build()
    assert lib.parent.parent == native.BUILD_ROOT and lib.name == "libwdimage.so"
    assert os.path.realpath(native.load()._name) == os.path.realpath(lib)
    assert os.path.realpath(lib) != os.path.realpath(jnative._LIB_PATH)


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_pad_normalize_is_bitwise_jax(channels):
    for h, w in ((64, 256), (32, 128)):
        imgs = crops(channels, channels)
        got = native.batch_resize_pad_normalize(imgs, h, w)
        assert got.shape == (len(imgs), h, w, channels) and got.dtype == np.float32
        assert np.array_equal(got, jnative.batch_resize_pad_normalize(imgs, h, w))


def test_normalize_is_bitwise_jax_and_numpy():
    u8 = np.concatenate([np.arange(256, dtype=np.uint8),
                         np.random.default_rng(0).integers(0, 256, 4097, dtype=np.uint8)])
    for a in (u8, u8[:4096].reshape(2, 32, 64)):
        got = native.batch_normalize(a)
        assert np.array_equal(got, jnative.batch_normalize(a))
        assert np.array_equal(got, (a.astype(np.float32) / 255.0 - 0.5) / 0.5)
    assert np.array_equal(images.normalize_to_unit(u8), jimages.normalize_to_unit(u8))


def test_denormalize_is_bitwise_jax_and_rounds_half_up():
    for x in (TIES, decoder_like(1), decoder_like(2, (3, 17, 33, 1))):
        got = native.batch_denormalize(x)
        assert np.array_equal(got, jnative.batch_denormalize(x))
        half_up = np.floor(np.clip(x, 0, 1) * np.float32(255) + np.float32(0.5))
        assert np.array_equal(got, half_up.astype(np.uint8))
    assert np.array_equal(native.batch_denormalize(TIES), np.arange(1, 256))


def test_vertical_lines_is_bitwise_jax():
    rng = np.random.default_rng(3)
    for c in (1, 3):
        img = rng.integers(0, 256, (40, 97, c), np.uint8)
        xs = np.array([-5, 0, 3, 3, 50, 96, 97, 400])
        got = native.vertical_lines(img.copy(), xs, 7)
        assert np.array_equal(got, jnative.vertical_lines(img.copy(), xs, 7))
        want = img.copy()
        want[:, [0, 3, 50, 96]] = 7
        assert np.array_equal(got, want)


def test_png_pixels_equal_jax(tmp_path):
    x = decoder_like(4, (3, 64, 256, 3))
    assert np.array_equal(images.denormalize_to_uint8(x), jimages.denormalize_to_uint8(x))
    names = [f"{i:05d}_1_word.png" for i in range(len(x))]
    ours = images.save_single_images(x, names, str(tmp_path / "port"))
    theirs = jimages.save_single_images(x, names, str(tmp_path / "jax"))
    for a, b, want in zip(ours, theirs, jimages.denormalize_to_uint8(x)):
        assert np.array_equal(read_image(a), read_image(b))
        assert np.array_equal(read_image(a), want)


def test_numpy_bodies_under_wd_native_0(monkeypatch):
    monkeypatch.setenv("WD_NATIVE", "0")
    assert not native.preferred() and not jnative.preferred()
    imgs = crops(5, 3)
    assert np.array_equal(native.batch_resize_pad_normalize(imgs, 64, 256),
                          jnative.batch_resize_pad_normalize(imgs, 64, 256))
    x = decoder_like(6)
    numpy_round = (np.clip(x, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    assert np.array_equal(native.batch_denormalize(x), numpy_round)
    assert np.array_equal(jnative.batch_denormalize(x), numpy_round)
    assert np.array_equal(images.denormalize_to_uint8(x), numpy_round)
    u8 = imgs[0]
    assert np.array_equal(native.batch_normalize(u8), jnative.batch_normalize(u8))
    xs = np.array([-1, 2, 1000])
    assert np.array_equal(native.vertical_lines(u8.copy(), xs), jnative.vertical_lines(
        u8.copy(), xs))


def test_numpy_rounding_differs_from_the_library_at_128_ties(monkeypatch):
    lib = native.batch_denormalize(TIES)
    monkeypatch.setenv("WD_NATIVE", "0")
    body = native.batch_denormalize(TIES)
    assert int((lib != body).sum()) == 128
    assert np.all(lib.astype(int) - body.astype(int) >= 0)  # half up against half to even


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build("/bin/false", build_root=tmp_path)
    # $CXX first, then g++ (a $CXX without OpenMP cannot build it): with
    # neither able to, the error carries both
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.compilers() == ["/bin/false", "g++"]
    both = r"(?s)/bin/false failed to build.*'g\+\+' cannot be run"
    with pytest.raises(RuntimeError, match=both):
        native.build(build_root=tmp_path)
    assert not list(tmp_path.rglob("*.so"))
    # no silent fallback: the entry points raise where the library cannot load
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "fresh")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            native.batch_normalize(np.zeros(3, np.uint8))
    finally:
        native.load.cache_clear()
