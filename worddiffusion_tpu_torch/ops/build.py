"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled, at first use, into one shared
library with a plain ``extern "C"`` interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <lib> csrc/*.cu

The library lands in ``build/wd_torch_kernels/<hash>/`` beside the
package (``.gitignore`` lists ``build/``); the hash covers the sources
and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. A missing nvcc or a failed compile raises ``RuntimeError`` with
nvcc's output: there is no fallback.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libwd_torch_kernels.so"
BUILD_ROOT = CSRC.parent.parent / "build" / "wd_torch_kernels"


def find_nvcc() -> str | None:
    """nvcc from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = [
        Path(os.environ[env]) / "bin" / "nvcc"
        for env in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(env)
    ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(nvcc: str | None = None, build_root: str | Path | None = None) -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns the library's path."""
    sources = _sources()
    out_dir = Path(build_root or BUILD_ROOT) / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = nvcc or find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library (built on first call)."""
    return ctypes.CDLL(str(build()))
