"""The data axis of the device mesh (port of
``worddiffusion_tpu/parallel/mesh.py``).

JAX lays a ``('data', 'model')`` mesh over its devices and shards the batch
over ``data``; here the data axis is the ``torch.distributed`` process group
(one process per card, ``DistributedDataParallel``), and a process holds
rows ``[rank * B/n, (rank + 1) * B/n)`` of every global batch, as
``P('data')`` places them on JAX's devices. The model axis (tensor
parallelism: column/row sharding of q/k/v and the FF) is not ported; it
waits for slice 13 of the port (ROADMAP A).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import NEXT_SLICE
from ..configs.config import MeshConfig
from .distributed import process_count, process_index

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis."""

    data: int
    rank: int


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """``cfg.data`` -1 (or 0) spans every process; any other value must be
    the world size. A model axis above 1 raises."""
    if cfg.model > 1:
        raise NotImplementedError(
            f"a model (tensor-parallel) mesh axis of {cfg.model} is not ported yet; it waits "
            f"for {NEXT_SLICE}")
    world = process_count()
    data = world if cfg.data <= 0 else cfg.data
    if data != world:
        raise ValueError(f"--mesh_data {cfg.data} must equal the number of processes "
                         f"({world}; launch with torchrun --nproc_per_node {cfg.data})")
    return Mesh(data=data, rank=process_index())


def shard_rows(n: int, mesh: Mesh) -> slice:
    """The rows of a global batch of ``n`` that ``mesh.rank`` holds."""
    if n % mesh.data:
        raise ValueError(f"global batch {n} not divisible by the data axis {mesh.data}")
    per = n // mesh.data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This process's slice of a global batch: every array (numpy or torch)
    and list in a dict is cut along its first axis; a scalar stays whole."""
    def cut(v):
        if isinstance(v, (np.ndarray, torch.Tensor, list)) and np.ndim(v) > 0:
            return v[shard_rows(len(v), mesh)]
        return v

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return cut(batch)
