"""The device mesh and the tensor-parallel layout (port of
``worddiffusion_tpu/parallel/mesh.py``).

JAX lays a ``('data', 'model')`` mesh over its devices; here the mesh is a
grid of ``torch.distributed`` processes, one per card
(``parallel.distributed.grid_groups``), with rank = data_rank · model +
model_rank as JAX's reshape lays devices out.

- ``data``: a process holds rows ``[data_rank * B/D, (data_rank + 1) * B/D)``
  of every global batch, as ``P('data')`` places them on JAX's devices; the
  ranks of a model group hold the same rows. The gradients are averaged
  over the data group (``DistributedDataParallel``).
- ``model``: tensor parallelism over the transformer blocks (Megatron's
  layout, ``parallel.tensor``). ``param_spec`` names each UNet parameter's
  layout: the attention's ``to_q``/``to_k``/``to_v`` column-parallel (each
  rank its heads), ``to_out.0`` and the FF's out-projection ``net.2``
  row-parallel, the FF's in-projection ``net.0.proj`` column-parallel with
  its ``a`` and gate halves cut alike (``"geglu_col"``: rank r holds the
  r-th slice of each half, so its GEGLU is local); every other parameter is
  replicated. JAX's ``param_sharding`` agrees but for the FF: its row
  pattern misses the out-projection (kept replicated) and its column split
  of the in-projection gives whole halves to ranks (ROADMAP C); the
  function is the same either way.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import numpy as np
import torch

from ..configs.config import MeshConfig
from .distributed import grid_groups, process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the ``data`` x ``model`` grid, and the
    process groups of its two axes (None without a model axis: the data
    axis is then the whole world, the default group)."""

    data: int
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def rank(self) -> int:
        """The global rank."""
        return self.data_rank * self.model + self.model_rank

    def __deepcopy__(self, memo):  # models hold it; a process group cannot be copied
        return self


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """``cfg.model`` (at least 1) ranks a model group; ``cfg.data`` -1 (or 0)
    takes the rest of the world, any other value must make ``data · model``
    the world size."""
    world = process_count()
    model = max(1, cfg.model)
    data = world // model if cfg.data <= 0 else cfg.data
    if data * model != world:
        if model == 1:
            raise ValueError(f"--mesh_data {cfg.data} must equal the number of processes "
                             f"({world}; launch with torchrun --nproc_per_node {cfg.data})")
        raise ValueError(f"--mesh_data {cfg.data} x --mesh_model {model} must equal the number "
                         f"of processes ({world}; launch with torchrun --nproc_per_node "
                         f"{max(data, 1) * model})")
    rank = process_index()
    data_group, model_group = grid_groups(data, model)
    return Mesh(data=data, model=model, data_rank=rank // model, model_rank=rank % model,
                data_group=data_group, model_group=model_group)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """The rows of a global batch of ``n`` that ``mesh.data_rank`` holds."""
    if n % mesh.data:
        raise ValueError(f"global batch {n} not divisible by the data axis {mesh.data}")
    per = n // mesh.data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


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


_BLOCK = r"(^|\.)transformer_blocks\.\d+\."
_SPECS = (
    (re.compile(_BLOCK + r"attn[12]\.to_[qkv]\.weight$"), "col"),
    (re.compile(_BLOCK + r"attn[12]\.to_out\.0\.weight$"), "row"),
    (re.compile(_BLOCK + r"ff\.net\.0\.proj\.weight$"), "geglu_col"),
    (re.compile(_BLOCK + r"ff\.net\.2\.weight$"), "row"),
)


def param_spec(key: str) -> Optional[str]:
    """A UNet state-dict key's layout over the model axis (the counterpart
    of JAX's ``param_sharding``): ``"col"`` (the rows of the [out, in]
    weight: output features), ``"row"`` (its columns: input features),
    ``"geglu_col"`` (the rows of each of the two GEGLU halves) or None
    (replicated)."""
    for pattern, spec in _SPECS:
        if pattern.search(key):
            return spec
    return None
