"""Read and write safetensors files with the stdlib, numpy and torch (the
port's counterpart of ``safetensors.numpy.load_file`` / ``save_file``,
which the JAX package imports for SD VAE checkpoints).

The format: an unsigned 64-bit little-endian header length N, N bytes of
JSON mapping each name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the data that follows the header; an optional
``__metadata__`` entry holds strings), then the data, row-major and
little-endian. Read: F32, F16, BF16 (through ``torch.frombuffer``, numpy
has no bfloat16), F64; written: F32.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "F64": torch.float64}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """name -> CPU tensor in the file's dtype."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}; reads "
                             f"{sorted(_DTYPES)}")
        begin, end = entry["data_offsets"]
        dtype = _DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name} holds {end - begin} bytes for {shape} "
                             f"{entry['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        buf = bytearray(data[begin:end])  # a writable copy the tensor owns
        out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor | np.ndarray], path: str) -> None:
    """Write ``tensors`` as F32, in key order."""
    header, chunks, offset = {}, [], 0
    for name, value in tensors.items():
        a = np.ascontiguousarray(torch.as_tensor(value).detach().float().cpu().numpy(),
                                 dtype="<f4")
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        chunks.append(a.tobytes())
        offset += a.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for chunk in chunks:
            f.write(chunk)
