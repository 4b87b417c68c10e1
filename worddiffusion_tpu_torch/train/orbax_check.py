"""The committed check set of the orbax reader (``orbax_check.npz``, made by
``python tests/test_torch_orbax.py`` where JAX and orbax are installed): the
files of four checkpoint directories the JAX package wrote, as byte arrays
under ``files/<set>/<path>``, and what they must decode to.

- ``narrow``: a small random ``TrainState`` (fp32, bfloat16, int32 and 0-d
  leaves, some sharded over 2 devices, zero Adam moments): the
  Huffman/FSE-heavy data.
- ``iam``: the full-width ``iam`` UNet's ``TrainState``; ``vae`` and
  ``ocr``: the in-repo VAE and the OCR as ``cli.train_vae`` /
  ``cli.train_ocr`` write them. Their leaves are tiled (``seeded_leaf``),
  so they compress to a few KB a tensor.

``leaves/<set>`` (JSON) lists each leaf's path, shape, dtype and rule, from
which ``expected`` rebuilds what it must decode to: a seed (a tiled leaf),
``"zero"``, ``{"const": v}``, ``"stored"`` (the array is under
``expected/<set>/<path>``: the narrow set's random parameters) or
``"same:<path>"`` (the EMA copy of a parameter).

The card's machine has no JAX, orbax or zstandard: ``unpack`` writes a set
back into a directory for ``train.orbax.read_orbax`` and the CLIs.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

CHECK_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orbax_check.npz")
SETS = ("narrow", "iam", "vae", "ocr")
STEP = 8  # the tiled TrainState's step and Adam count


def seeded_leaf(path: str, shape, seed: int) -> np.ndarray:
    """A leaf of a tiled tree: its own 256-value block (0.05 N(0, 1) on a
    1/1024 grid, seeded by ``seed`` and the CRC-32 of its path), repeated
    to ``shape``. The grid keeps the low mantissa bytes zero, so a block
    compresses to about a quarter (a leaf's block is stored twice, in the
    process's tree and the merged one)."""
    rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
    block = (np.round(0.05 * 1024 * rng.standard_normal(256)) / 1024).astype(np.float32)
    return np.resize(block, tuple(shape))


def _load(path: str = CHECK_FILE):
    return np.load(path, allow_pickle=False)


def unpack(set_name: str, dest: str, path: str = CHECK_FILE) -> str:
    """Writes the files of ``set_name`` under ``dest`` and returns ``dest``."""
    prefix = f"files/{set_name}/"
    with _load(path) as z:
        for key in z.files:
            if key.startswith(prefix):
                out = os.path.join(dest, key[len(prefix):])
                os.makedirs(os.path.dirname(out), exist_ok=True)
                with open(out, "wb") as f:
                    f.write(z[key].tobytes())
    return dest


def expected(set_name: str, path: str = CHECK_FILE) -> dict:
    """{leaf path: array} of what ``set_name`` decodes to; a bfloat16 leaf as
    its uint16 bits."""
    with _load(path) as z:
        leaves = json.loads(z[f"leaves/{set_name}"].tobytes())
        stored = {p: z[f"expected/{set_name}/{p}"] for p, _, _, rule in leaves
                  if rule == "stored"}
    out = {}
    for p, shape, dtype, rule in leaves:
        if isinstance(rule, dict):
            out[p] = np.full(shape, rule["const"], dtype)
        elif rule == "zero":
            out[p] = np.zeros(shape, dtype)
        elif rule == "stored":
            out[p] = stored[p]
        elif isinstance(rule, int):
            out[p] = seeded_leaf(p, shape, rule).astype(dtype)
    for p, _, _, rule in leaves:
        if isinstance(rule, str) and rule.startswith("same:"):
            out[p] = out[rule[5:]]
    return out


def flatten(tree, prefix: str = "") -> dict:
    """{"a.b.0.c": leaf} of a ``read_orbax`` tree (``None`` leaves left
    out); a ``torch.bfloat16`` leaf as its uint16 bits."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.view(torch.int16).numpy().view(np.uint16)
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        if v is not None:
            out.update(flatten(v, f"{prefix}{k}."))
    return out
