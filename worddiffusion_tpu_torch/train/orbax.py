"""The JAX package's checkpoints: orbax's ``StandardSave`` layout, read
without JAX, orbax or TensorStore.

A ``CheckpointManager`` directory holds one directory per committed step,
``<dir>/<step>/`` with ``_CHECKPOINT_METADATA``; an unfinished write is
``<step>.orbax-checkpoint-tmp-<n>`` and is skipped. The item is in
``<step>/default/``: ``_METADATA`` (JSON: ``tree_metadata``, keyed by the
pytree path, each with its ``key_metadata``: ``key_type`` 1 for a sequence
index, 2 for a dict key or attribute) and an OCDBT store
(``utils.ocdbt``) whose keys are zarr v2 arrays: ``<a.b.c>/.zarray`` (JSON:
shape, chunks, dtype, zstd compressor, fill value) and one key a chunk,
``<a.b.c>/<i>.<j>...`` (``0`` for a 0-d array), each a zstd frame
(``utils.zstd``). An array written sharded (a model axis above 1) has one
chunk a shard; a chunk equal to the fill value may be absent.

``read_orbax(step_dir)`` returns the pytree as nested dicts and lists of
numpy arrays, the tree ``StandardRestore`` restores: bitwise its values
(``bfloat16`` leaves as ``torch.bfloat16`` tensors, numpy having no such
type; optax's empty states as ``None``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..utils import zstd
from ..utils.ocdbt import OcdbtStore

COMMIT_FILE = "_CHECKPOINT_METADATA"


def is_orbax(path: str) -> bool:
    """Whether ``path`` is an orbax ``CheckpointManager`` directory or one of
    its steps."""
    return bool(path) and (os.path.isfile(os.path.join(path, COMMIT_FILE))
                           or bool(orbax_steps(path)))


def orbax_steps(directory: str) -> list[int]:
    """The committed steps of an orbax ``CheckpointManager`` directory,
    oldest first (unfinished ``*.orbax-checkpoint-tmp-*`` writes skipped)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, COMMIT_FILE)))


def orbax_step_dir(path: str, step: Optional[int] = None) -> str:
    """The step directory ``path`` names: itself where it is one, else its
    newest committed step (or ``step``). ``FileNotFoundError`` where there
    is none."""
    if os.path.isfile(os.path.join(path, COMMIT_FILE)):
        return path
    steps = orbax_steps(path)
    if not steps or (step is not None and step not in steps):
        raise FileNotFoundError(f"{path} holds no orbax checkpoint"
                                f"{'' if step is None else f' of step {step}'}")
    return os.path.join(path, str(steps[-1] if step is None else step))


def _item_dir(step_dir: str) -> str:
    for d in (os.path.join(step_dir, "default"), step_dir):
        if os.path.isfile(os.path.join(d, "_METADATA")):
            return d
    raise FileNotFoundError(f"{step_dir}: no orbax item (default/_METADATA)")


def _dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _fill(value, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return int(np.float32(value).view(np.uint32) >> 16) if bf16 else value


def read_zarr(store: OcdbtStore, name: str):
    """The zarr v2 array ``name`` of ``store``: numpy, or ``torch.bfloat16``."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    layout = (meta.get("zarr_format"), meta.get("filters"), (meta.get("compressor") or {}).get("id"),
              meta.get("order"))
    if layout != (2, None, "zstd", "C"):
        raise ValueError(f"{name}: zarr format, filters, compressor, order {layout}: only what "
                         f"orbax writes, (2, None, 'zstd', 'C'), is read")
    dtype, shape, chunks = _dtype(meta["dtype"]), tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), meta["dtype"] == "bfloat16"), dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue  # a chunk equal to the fill value
        chunk = np.frombuffer(zstd.decompress(store.read(key)), dtype,
                              math.prod(chunks)).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        region = tuple(slice(a, min(a + c, s)) for a, c, s in zip(lo, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _insert(tree: dict, keys: Sequence[dict], value) -> None:
    node = tree
    for i, km in enumerate(keys):
        k = km["key"]
        if i == len(keys) - 1:
            node[(km["key_type"], k)] = value
        else:
            node = node.setdefault((km["key_type"], k), {})


def _build(node):
    """Dicts keyed (key_type, key) -> dicts and lists (key_type 1: an index)."""
    if not isinstance(node, dict):
        return node
    if node and all(t == 1 for t, _ in node):
        return [_build(node[(1, str(i))]) for i in range(len(node))]
    return {k: _build(v) for (_, k), v in node.items()}


def read_orbax(step_dir: str, subtree: Union[None, str, Sequence[str]] = None):
    """The pytree of one orbax step (``<dir>/<step>``, or the manager's
    directory for its newest step): nested dicts and lists of arrays. With
    ``subtree`` (a top-level key, or a path of keys) only that branch is
    read, and returned."""
    item = _item_dir(orbax_step_dir(step_dir))
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{item}: zarr3 arrays are not read")
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{item}: a checkpoint without OCDBT is not read")
    path = (subtree,) if isinstance(subtree, str) else tuple(subtree or ())
    store = OcdbtStore(item)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys, value = entry["key_metadata"], entry["value_metadata"]
        if tuple(k["key"] for k in keys[:len(path)]) != path:
            continue
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            leaf = None
        else:
            leaf = read_zarr(store, ".".join(k["key"] for k in keys))
        _insert(tree, keys, leaf)
    if not tree:
        raise KeyError(f"{item}: no leaf under {'/'.join(path)}")
    out = _build(tree)
    for k in path:
        out = out[int(k)] if isinstance(out, list) else out[k]
    return out
