"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file is compiled, at first use, into one shared
library with a plain ``extern "C"`` interface: one nvcc per source, all
started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <src>.o csrc/<src>.cu        # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

The library lands in ``build/wd_torch_kernels/<hash>/`` beside the
package (``.gitignore`` lists ``build/``); the hash covers the sources
(``csrc/*.cu``) with the headers they include (``csrc/*.cuh``) and the
flags, so an edited kernel or header is rebuilt and an unchanged one is
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
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


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path]) -> str:
    """Hash of the flags, the sources and every header beside them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *_headers()]:
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
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp / f"{src.stem}.o" for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for o, src in zip(objs, sources)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME), *map(str, objs)]])
        os.replace(tmp / LIB_NAME, lib)  # atomic: a concurrent build never loads half a file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands together; wait for all, then raise with the output
    of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {p.returncode}: {' '.join(cmd)}\n{out}")


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library (built on first call)."""
    return ctypes.CDLL(str(build()))


@functools.cache
def _raw_stream():
    import torch

    fast = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return fast or (lambda dev: torch.cuda.current_stream(dev).cuda_stream)


def launch_on(x, call):
    """``call(stream)`` with the current stream of CUDA tensor ``x``'s device
    as an int: under ``torch.cuda.device`` only where x is not on the current
    device, as the kernels launch on the current device."""
    import torch

    dev = x.get_device()
    if dev == torch._C._cuda_getDevice():
        return call(_raw_stream()(dev))
    with torch.cuda.device(dev):
        return call(_raw_stream()(dev))
