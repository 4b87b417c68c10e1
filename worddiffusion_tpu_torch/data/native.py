# Copy of worddiffusion_tpu/data/native.py: the port imports nothing of the JAX package.
"""Batch image preprocessing on the host: resize + pad + normalise,
normalise, denormalise, vertical eraser lines.

Each function runs the port's copy of the JAX repo's C pass
(``csrc/host/wd_image.cpp``: one OpenMP loop over a whole batch, through a
plain C ABI) when ``preferred()``, as the JAX package does whenever its
library loads; ``WD_NATIVE=0`` (read at each call) opts out and runs the
numpy bodies, which are also the plain versions the tests hold the library
against. The C pass differs from them in two places: ``batch_denormalize``
rounds half up in float32 (``(uint8)(v * 255 + 0.5)``) where numpy rounds
half to even, and ``batch_resize_pad_normalize`` resamples with its own
bilinear, not PIL's.

The library is built at first use, in the style of ``ops/build.py``::

    $CXX -O3 -march=native -fPIC -fopenmp -std=c++17 -Wall -shared \\
         -o build/wd_torch_host/<hash>/libwdimage.so csrc/host/wd_image.cpp

(the flags are the JAX repo's Makefile's; the hash covers the source, the
flags and the compiler's ``--version``, as ``-march=native`` builds for the
host that compiles). The compiler is ``$CXX``, as the Makefile's
``CXX ?= g++`` takes it, and ``g++`` where ``$CXX`` is unset or cannot build
the pass (a ``$CXX`` without OpenMP fails on ``-fopenmp``). Unlike the JAX
package, which falls back to numpy in silence, no compiler that builds it,
or a library of another version, raises ``RuntimeError`` with each
compiler's output.

The library is loaded after ``import torch``: torch brings its own OpenMP
runtime, and a library loaded after it binds to that one where the two
share a soname (``libgomp.so.1``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "wd_image.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall", "-shared")
LIB_NAME = "libwdimage.so"
BUILD_ROOT = SOURCE.parents[3] / "build" / "wd_torch_host"
VERSION = 1


def _compiler_version(cxx: str) -> str:
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"the C++ compiler {cxx!r} cannot be run: {e}") from e
    return proc.stdout + proc.stderr


def compilers() -> list[str]:
    """The compilers to try, in order: ``$CXX``, then ``g++``."""
    return [c for c in dict.fromkeys((os.environ.get("CXX"), "g++")) if c]


def build(cxx: str | None = None, build_root: str | Path | None = None) -> Path:
    """Compile the host library with ``cxx`` (else the first of
    ``compilers()`` that builds it) unless one for this source, these flags
    and that compiler exists; returns its path."""
    errors = []
    for c in [cxx] if cxx else compilers():
        try:
            return _build_with(c, Path(build_root or BUILD_ROOT))
        except RuntimeError as e:
            errors.append(str(e))
    raise RuntimeError("no compiler built the host library:\n" + "\n".join(errors))


def _build_with(cxx: str, build_root: Path) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_compiler_version(cxx).encode())
    out_dir = build_root / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build the host library (exit code "
                               f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp / LIB_NAME, lib)  # atomic: a concurrent build never loads half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its argtypes (built on first call)."""
    import torch  # noqa: F401  (its OpenMP runtime first: the module docstring)

    lib = ctypes.CDLL(str(build()))
    lib.wd_version.restype = ctypes.c_int
    if lib.wd_version() != VERSION:
        raise RuntimeError(f"{lib._name}: wd_version() is {lib.wd_version()}, not {VERSION}")
    lib.wd_batch_resize_pad_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.wd_batch_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.wd_batch_denormalize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.wd_vertical_lines.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_uint8,
    ]
    for fn in (lib.wd_batch_resize_pad_normalize, lib.wd_batch_normalize,
               lib.wd_batch_denormalize, lib.wd_vertical_lines):
        fn.restype = None
    return lib


def available() -> bool:
    """True once the library is built and loaded (it raises where it
    cannot be)."""
    return load() is not None


def preferred() -> bool:
    """The C pass unless ``WD_NATIVE=0``, read at each call."""
    return os.environ.get("WD_NATIVE", "1") != "0" and available()


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def batch_resize_pad_normalize(
    images: Sequence[np.ndarray], height: int, width: int
) -> np.ndarray:
    """list of uint8 HWC (variable size) -> float32 [N, height, width, C]
    in [-1, 1], white-padded."""
    if not preferred():
        from ..utils.images import normalize_to_unit, resize_and_pad

        return np.stack([
            normalize_to_unit(resize_and_pad(img, height, width)) for img in images
        ])
    lib = load()
    n = len(images)
    c = images[0].shape[2]
    if any(img.ndim != 3 or img.shape[2] != c for img in images):
        raise ValueError(f"batch_resize_pad_normalize takes HWC images of {c} channels")
    flat = np.concatenate([np.ascontiguousarray(i, np.uint8).reshape(-1) for i in images])
    offsets = np.zeros(n, np.int64)
    shapes = np.zeros(2 * n, np.int32)
    off = 0
    for i, img in enumerate(images):
        offsets[i] = off
        shapes[2 * i] = img.shape[0]
        shapes[2 * i + 1] = img.shape[1]
        off += img.size
    out = np.empty((n, height, width, c), np.float32)
    lib.wd_batch_resize_pad_normalize(
        _ptr(flat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(shapes, ctypes.c_int32), n, c,
        _ptr(out, ctypes.c_float), height, width,
    )
    return out


def batch_normalize(images: np.ndarray) -> np.ndarray:
    """uint8 [...] -> float32 [-1,1], same shape."""
    if not preferred():
        return (images.astype(np.float32) / 255.0 - 0.5) / 0.5
    src = np.ascontiguousarray(images, np.uint8)
    out = np.empty(src.shape, np.float32)
    load().wd_batch_normalize(_ptr(src, ctypes.c_uint8), _ptr(out, ctypes.c_float), src.size)
    return out


def batch_denormalize(images: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8: the C pass rounds half up in float32, the numpy
    body half to even."""
    if not preferred():
        return (np.clip(images, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    src = np.ascontiguousarray(images, np.float32)
    out = np.empty(src.shape, np.uint8)
    load().wd_batch_denormalize(_ptr(src, ctypes.c_float), _ptr(out, ctypes.c_uint8), src.size)
    return out


def vertical_lines(img: np.ndarray, xs: np.ndarray, value: int = 255) -> np.ndarray:
    """in-place vertical eraser lines; returns img."""
    if not preferred():
        img[:, xs[(xs >= 0) & (xs < img.shape[1])]] = value
        return img
    if not (img.flags["C_CONTIGUOUS"] and img.dtype == np.uint8 and img.ndim == 3):
        raise ValueError("vertical_lines draws in place on a C-contiguous uint8 HWC image")
    xs32 = np.ascontiguousarray(xs, np.int32)
    h, w, c = img.shape
    load().wd_vertical_lines(
        _ptr(img, ctypes.c_uint8), h, w, c, _ptr(xs32, ctypes.c_int32), len(xs32), value,
    )
    return img
