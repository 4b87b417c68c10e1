"""Multi-process initialisation (port of
``worddiffusion_tpu/parallel/distributed.py``).

PyTorch's data parallelism is one process per GPU, launched by ``torchrun``
(``torchrun --nproc_per_node N -m worddiffusion_tpu_torch.cli.train
--mesh_data N``), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``. ``initialize_multihost`` reads them and
joins the process group: NCCL on the card, gloo on the CPU. Without them it
is a no-op and the run is one process.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("worddiffusion")


def initialize_multihost(device: str = "cuda") -> tuple[int, int]:
    """Join the process group that ``torchrun``'s environment describes ->
    (rank, world size); (0, 1) without that environment. On ``cuda`` each
    process takes the card ``LOCAL_RANK`` (NCCL); on ``cpu`` gloo."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 0, 1
    if not dist.is_initialized():
        backend = "gloo"
        if torch.device(device).type == "cuda":
            backend = "nccl"
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
        log.info("process group up: rank %d of %d (%s)", dist.get_rank(),
                 dist.get_world_size(), backend)
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device: str) -> torch.device:
    """The card this process drives: ``cuda:LOCAL_RANK`` under ``torchrun``,
    else ``device`` as given."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return d


def local_batch_slice(global_batch: int) -> int:
    """Per-process batch size for an evenly sharded global batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n
