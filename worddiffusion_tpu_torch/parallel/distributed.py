"""Multi-process initialisation and the 2-D process grid (port of
``worddiffusion_tpu/parallel/distributed.py``).

PyTorch's parallelism is one process per GPU, launched by ``torchrun``
(``torchrun --nproc_per_node N -m worddiffusion_tpu_torch.cli.train
--mesh_data D --mesh_model M``, N = D·M), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.
``initialize_multihost`` reads them and joins the process group: NCCL on
the card, gloo on the CPU. Without them it is a no-op and the run is one
process.

Ranks that share a card: NCCL refuses two ranks on one device, so more
ranks on a host than it has cards raise, unless ``SHARE_CARD_ENV``
(``WD_TORCH_SHARE_CARD=1``) is set; then the ranks run gloo on their CUDA
tensors (staged through the host) and rank ``LOCAL_RANK`` drives card
``LOCAL_RANK % device_count``. That is a way to run the multi-process
paths on one card, not a way to make them fast. The port's collectives
are the ones gloo takes on CUDA tensors: ``all_reduce``, ``all_gather``
and ``broadcast``.

The grid lays ranks out as JAX's ``make_mesh`` lays devices out,
``np.reshape(devices, (data, model))``: rank = data_rank · model +
model_rank, so a model group is ``model`` consecutive ranks and a data
group the ranks ``model`` apart.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("worddiffusion")

SHARE_CARD_ENV = "WD_TORCH_SHARE_CARD"


def share_card() -> bool:
    """Whether the environment asks ranks to share cards (gloo on CUDA)."""
    return os.environ.get(SHARE_CARD_ENV, "0") not in ("", "0")


def card_index(local_rank: int) -> int:
    """The card of local rank ``local_rank``: itself, or, with
    ``SHARE_CARD_ENV``, itself modulo the card count. A rank without a card
    of its own raises, naming the setting."""
    n = torch.cuda.device_count()
    if share_card():
        return local_rank % max(n, 1)
    if local_rank >= n:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({n} visible): NCCL refuses two "
            f"ranks on one card. Launch at most {n} processes per host, or set "
            f"{SHARE_CARD_ENV}=1 to run gloo on shared cards")
    return local_rank


def initialize_multihost(device: str = "cuda") -> tuple[int, int]:
    """Join the process group that ``torchrun``'s environment describes ->
    (rank, world size); (0, 1) without that environment. On ``cuda`` each
    process takes its card (``card_index``) and NCCL, or gloo with
    ``SHARE_CARD_ENV``; on ``cpu`` gloo."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 0, 1
    if not dist.is_initialized():
        backend = "gloo"
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(card_index(int(os.environ.get("LOCAL_RANK", 0))))
            backend = "gloo" if share_card() else "nccl"
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
    """The card this process drives: ``cuda:card_index(LOCAL_RANK)`` under
    ``torchrun``, else ``device`` as given."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", card_index(int(os.environ["LOCAL_RANK"])))
    return d


def local_batch_slice(global_batch: int) -> int:
    """Per-process batch size for an evenly sharded global batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n


def grid_groups(data: int, model: int):
    """(data group, model group) of this process on a ``data`` x ``model``
    grid of the world's ranks; (None, None) without a model axis, where the
    data axis is the whole world (the default group). Every rank must call
    it, with the same sizes, in the same order: each group is created by
    all of them."""
    if not dist.is_initialized() or model == 1:
        return None, None
    rank = dist.get_rank()
    data_group = model_group = None
    for d in range(data):  # model groups: `model` consecutive ranks
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if rank // model == d:
            model_group = g
    for m in range(model):  # data groups: the ranks `model` apart
        g = dist.new_group(list(range(m, data * model, model)))
        if rank % model == m:
            data_group = g
    return data_group, model_group
