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

The JAX package's loader builds ``native/libwdimage.so`` with ``make`` in
place and caches a failed load for the life of the process. Under
``pytest -n``, every worker collects ``tests/test_native.py``, whose
``skipif`` runs that loader at import time, so on a tree without the
library the workers' builds race and a worker can be left with the
failure cached. The module fixture ``jax_library`` makes the library
whole first: under a file lock it loads it, or builds it with the
Makefile's own command into a temporary file and renames that over the
target, retrying for a bounded time while another worker's ``make`` may
still be writing; then it clears the loader's cached failure. The tests
still compare the port's library with the one the JAX module loads.
"""

import fcntl
import os
import re
import shlex
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from worddiffusion_tpu.data import native as jnative
from worddiffusion_tpu.utils import images as jimages
from worddiffusion_tpu_torch.data import native
from worddiffusion_tpu_torch.data.png import read_image
from worddiffusion_tpu_torch.utils import images

TIES = ((np.arange(255) + 0.5) / 255).astype(np.float32)
REPO = Path(__file__).resolve().parents[1]
MAKEFILE = REPO / "native" / "Makefile"
# the library's ABI version, as the JAX loader checks it
WD_VERSION = 1


def make_command(target: Path) -> list[str]:
    """``native/Makefile``'s recipe, ``$(CXX) $(CXXFLAGS) -shared -o $@ $<``,
    with its defaults for ``CXX`` and ``CXXFLAGS`` where the environment
    sets neither (``?=``), writing to ``target``."""
    defaults = dict(re.findall(r"^(CXX|CXXFLAGS) \?= (.*)$", MAKEFILE.read_text(), re.M))
    cxx = os.environ.get("CXX") or defaults["CXX"]
    flags = os.environ.get("CXXFLAGS") or defaults["CXXFLAGS"]
    return [*shlex.split(cxx), *shlex.split(flags), "-shared", "-o", str(target),
            str(MAKEFILE.parent / "src" / "wd_image.cpp")]


def _loads(target: Path) -> bool:
    """Whether ``target`` loads and reports the expected version, tried in
    a child process: mapping a library cut short can kill the process
    with SIGBUS, and a loaded library cannot be unloaded."""
    probe = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
             "lib.wd_version.restype = ctypes.c_int; print(lib.wd_version())")
    res = subprocess.run([sys.executable, "-c", probe, str(target)], capture_output=True,
                         text=True, timeout=60)
    return res.returncode == 0 and res.stdout.strip() == str(WD_VERSION)


def ensure_library(target: Path, timeout: float = 120.0) -> None:
    """Leave a library at ``target`` that loads and has the expected
    version: load it, or build it with the Makefile's command into a
    temporary file beside it and rename that onto ``target``, and load
    again. A build that fails raises, naming the command; a library that
    still will not load (another process may be writing the same path)
    is retried until ``timeout`` seconds have passed."""
    deadline = time.monotonic() + timeout
    while not _loads(target):
        if time.monotonic() > deadline:
            raise RuntimeError(f"{target} does not load after {timeout:.0f} s")
        fd, tmp = tempfile.mkstemp(suffix=".so", prefix=".build-", dir=target.parent)
        os.close(fd)
        cmd = make_command(Path(tmp))
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            if res.returncode != 0:
                raise RuntimeError(f"{shlex.join(cmd)} failed to build {target.name} "
                                   f"({res.returncode}): {res.stderr[-2000:]}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if not _loads(target):
            time.sleep(1.0)


def restore_jax_library(mp: pytest.MonkeyPatch, target: Path, lock_path: Path) -> None:
    """Make the JAX package's library at ``target`` whole under a file lock
    (``ensure_library``), then clear the JAX loader's cached result (``mp``
    undoes it), so that its own loader loads ``target`` afresh."""
    lock_path.parent.mkdir(exist_ok=True)
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            ensure_library(target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    mp.setattr(jnative, "_tried", False)
    mp.setattr(jnative, "_lib", None)
    mp.delenv("WD_NATIVE", raising=False)
    assert jnative.preferred()


@pytest.fixture(scope="module")
def jax_library():
    """The JAX package's library, whole and loaded by its own loader."""
    with pytest.MonkeyPatch.context() as mp:
        restore_jax_library(mp, Path(jnative._LIB_PATH), REPO / "build" / "jax_native.lock")
        yield


@pytest.fixture(autouse=True)
def library_on(monkeypatch, jax_library):
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


def test_ensure_library_rebuilds_a_truncated_library(tmp_path):
    """A library cut short (as a reader sees one another process is still
    writing) is rebuilt by the Makefile's command and then loads."""
    target = tmp_path / "libwdimage.so"
    target.write_bytes(Path(jnative._LIB_PATH).read_bytes()[:4096])
    assert not _loads(target)
    ensure_library(target)
    assert _loads(target)
    assert not list(tmp_path.glob(".build-*"))


def test_ensure_library_raises_naming_the_failed_command(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "/bin/false")
    target = tmp_path / "libwdimage.so"
    with pytest.raises(RuntimeError, match=r"^/bin/false .*-shared -o .*failed to build"):
        ensure_library(target, timeout=5.0)
    assert not target.exists() and not list(tmp_path.glob(".build-*"))


@pytest.mark.parametrize("state", ["missing", "truncated", "not_a_library"])
def test_jax_loader_recovers_from_a_cached_failure(monkeypatch, tmp_path, state):
    """The state that failed this module's tests under ``pytest -n``: the
    JAX loader has cached a failed load (``_tried`` set, no library) of a
    library that is missing, cut short or not yet a library. The module
    fixture's logic rebuilds it and clears the cache; the JAX loader then
    loads it itself, and its entry points equal the port's, bitwise."""
    target = tmp_path / "libwdimage.so"
    if state == "truncated":
        target.write_bytes(Path(jnative._LIB_PATH).read_bytes()[:4096])
    elif state == "not_a_library":
        target.write_bytes(b"half-written\n")
    monkeypatch.setattr(jnative, "_LIB_PATH", str(target))
    monkeypatch.setattr(jnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    assert not jnative.preferred()
    restore_jax_library(monkeypatch, target, tmp_path / "jax_native.lock")
    assert jnative.preferred() and _loads(target)
    assert os.path.samefile(jnative._load()._name, target)
    imgs = crops(7, 3)
    assert np.array_equal(jnative.batch_resize_pad_normalize(imgs, 64, 256),
                          native.batch_resize_pad_normalize(imgs, 64, 256))
    x = decoder_like(8)
    assert np.array_equal(jnative.batch_denormalize(x), native.batch_denormalize(x))
    assert np.array_equal(jnative.batch_denormalize(TIES), np.arange(1, 256))
