"""The training loop (port of ``worddiffusion_tpu/train/loop.py``):
epochs, checkpoints, previews, stop flag, resume.

The data comes from a latent cache (``data.dataset``), the production
fast path of the JAX trainer, or from word images that the step encodes
with the frozen VAE (``encode_fn``), or, in pixel space
(``exp.data.latent`` False), from the images themselves; the batches
(latents or images) are staged on the device by the prefetch worker.

Data parallel (one process per card, ``parallel.distributed``): the model
runs under ``DistributedDataParallel`` over the data group, each process
loads and steps on its data rank's rows of every global batch
(``parallel.mesh.shard_rows``), and the step's draws are the global
batch's, so an n-process step is the one-process step on the global batch
(the JAX mesh step). Tensor parallel (``exp.mesh.model`` M > 1): the UNet
is built sharded (``UNet(cfg, mesh)``), from the one-process run's seeded
initialisation cut by ``parallel.tensor.shard_state_dict``; the M ranks of
a model group hold the same rows. AdamW and the EMA run on the shards
(both are elementwise). Checkpoints are written gathered by rank 0, the
one-process run's keys and shapes (``train.checkpoint``), and previews
come from the ranks of data rank 0 (a sharded forward needs its whole
model group), rank 0 writing them. Rank 0 alone writes metrics and reads
the stop flag, which it broadcasts over a gloo group so that no step waits
on the card for it.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..configs.config import Experiment
from ..data.loader import epoch_batches
from ..diffusion.schedule import NoiseSchedule
from ..models.layers import init_weights_, skip_default_init
from ..models.unet import UNet
from ..ops import attention
from ..parallel.mesh import Mesh, make_mesh, shard_rows
from ..parallel.tensor import shard_state_dict
from ..utils.metrics import MetricsLogger, StepTimer
from ..utils.stop_flag import StopFlag
from .checkpoint import CheckpointManager
from .state import TrainState, make_optimizer
from .step import make_train_step

log = logging.getLogger("worddiffusion")


def check_attention_backward(exp: Experiment, batch: int, model: int = 1) -> None:
    """Raise before the first step where a self-attention's plain-recompute
    backward would not fit (``ops.attention.BACKWARD_BYTES_LIMIT``): the
    UNet's attentions over ``H/ds x W/ds`` positions at each resolution ``ds``
    of ``attention_resolutions``, in the space the model runs in, on a model
    rank's ``num_heads / model`` heads."""
    u = exp.unet
    if u.attn1_cross:
        return
    h, w = exp.data.img_height, exp.data.img_width
    if exp.data.latent:
        h, w = h // 8, w // 8
    for ds in u.attention_resolutions:
        n = (h // ds) * (w // ds)
        attention.check_backward_size(batch, u.num_heads // model, n, n)


class Trainer:
    def __init__(
        self,
        exp: Experiment,
        dataset,
        preview_fn: Optional[Callable] = None,
        device: torch.device | str = "cuda",
        encode_fn: Optional[Callable] = None,
        model: Optional[nn.Module] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``preview_fn(state, epoch)`` renders the fixed probe words.
        ``encode_fn(images, generator) -> latent [B, 8, 32, 4]`` maps image
        batches into the diffusion space (the VAE encode), inside the step.

        The FF sub-layer: ``use_pallas_ffn`` None or True runs the forward
        kernel and the backward kernel on a CUDA device, False the plain
        autograd path. The JAX Trainer resolves None to off from TPU v5e
        measurements, which say nothing about this card. On an H100
        (700 W, ``iam`` width, B=128) the two paths' s/step lay within
        each other's run-to-run spread (the step is host-bound), and the
        kernel path's peak memory was 3.9 against 6.2 GiB (PERF.md), so
        None stays on the kernels for the memory; ``chip_smoke.py``
        phase 7 times both.

        ``model``: the denoiser (default ``UNet(exp.unet, mesh)``; the HiGAN+
        adapter with ``--hiGanArch 1``, replicated over a model axis: nothing
        of it is sharded, as in JAX). ``mesh``: the processes' layout, by
        default ``parallel.mesh.make_mesh(exp.mesh)`` (which creates the
        axes' process groups)."""
        self.exp = exp
        self.dataset = dataset
        self.preview_fn = preview_fn
        self.encode_fn = encode_fn
        self.device = torch.device(device)
        self.schedule = NoiseSchedule.linear(
            exp.diffusion.num_steps, exp.diffusion.beta_start, exp.diffusion.beta_end
        )
        self.mesh = make_mesh(exp.mesh) if mesh is None else mesh
        if model is None:
            with skip_default_init():  # the seeded initialisation at once, as init_state's
                model = init_weights_(UNet(exp.unet, self.mesh), exp.train.seed)
        self.model = model.to(self.device)
        self.rank = self.mesh.rank
        if isinstance(self.model, UNet):
            check_attention_backward(exp, exp.data.batch_size // self.mesh.data, self.mesh.model)
        self.rows = (shard_rows(exp.data.batch_size, self.mesh) if self.mesh.data > 1
                     else None)
        # under torchrun (a process group), at any world size
        self.distributed = dist.is_available() and dist.is_initialized()
        self._ddp = None
        # the gloo group the stop flag is broadcast over
        self._control = dist.new_group(backend="gloo") if self.distributed else None
        self.ckpt = CheckpointManager(f"{exp.train.save_path}/ckpt")
        self.stop = StopFlag(exp.train.stop_flag_file)
        self.metrics = (MetricsLogger(f"{exp.train.save_path}/metrics.jsonl")
                        if self.rank == 0 else None)
        self.timer = StepTimer()
        # (wall seconds, steps) per completed epoch of the last run(): the
        # end-to-end training rate including host batch assembly
        self.epoch_seconds: list[tuple[float, int]] = []

    def init_state(self) -> TrainState:
        """A fresh state from the seeded initialisation (every run() starts
        from it, as every JAX run() inits its params); a sharded UNet takes
        its shard of the one-process initialisation."""
        if self.mesh.model > 1 and isinstance(self.model, UNet):
            with skip_default_init():
                full = init_weights_(UNet(self.exp.unet), self.exp.train.seed)
            self.model.load_state_dict(shard_state_dict(full.state_dict(), self.mesh))
        else:
            init_weights_(self.model, self.exp.train.seed)
        opt = make_optimizer(self.model.parameters(), self.exp.train.lr,
                             self.exp.train.weight_decay)
        return TrainState.create(self.model.train(), opt)

    def _forward_model(self) -> Optional[nn.Module]:
        """The ``DistributedDataParallel`` wrapper over the data group that the
        step calls (made once: each wrapper hooks the parameters), or None
        without a process group."""
        if not self.distributed:
            return None
        if self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel

            ids = [self.device.index] if self.device.type == "cuda" else None
            # a replaced context leaves the character encoder without a
            # gradient, and the CTC head without its loss weight; every other
            # step uses every parameter, and DDP then skips the graph walk
            u = self.exp.unet
            unused = u.style_replace_context or (u.ocr_head and self.exp.train.ctc_weight <= 0)
            self._ddp = DistributedDataParallel(self.model, device_ids=ids,
                                                process_group=self.mesh.data_group,
                                                find_unused_parameters=bool(unused))
        return self._ddp

    def _should_stop(self) -> bool:
        """Rank 0's stop flag, on every process."""
        if not self.distributed:
            return self.stop.should_stop()
        flag = torch.tensor([int(self.stop.should_stop()) if self.rank == 0 else 0])
        dist.broadcast(flag, 0, group=self._control)
        return bool(flag.item())

    def _global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data group (``t`` itself on a data axis
        of 1: the ranks of a model group hold the same loss)."""
        if self.mesh.data == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.mesh.data_group)
        return t / self.mesh.data

    def _to_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _device_batch(self, batch: dict) -> dict:
        key = "latent" if "latent" in batch else "image"
        out = {
            key: self._to_device(batch[key].astype("float32", copy=False)),
            "context": self._to_device(batch["context"].astype("int64")),
            "writer": self._to_device(batch["writer"].astype("int64")),
        }
        for k, dtype in (("phosc", "int64"), ("ocr_ids", "int64"), ("ocr_len", "int64"),
                         ("style_vec", "float32"), ("char_images", "float32")):
            if k in batch:
                out[k] = self._to_device(batch[k].astype(dtype, copy=False))
        return out

    def run(
        self,
        epochs: Optional[int] = None,
        resume: bool = False,
        max_steps: Optional[int] = None,
    ) -> TrainState:
        """Train to ``epochs`` TOTAL epochs (not "epochs from here").

        **RNG & resume contract** (as the JAX Trainer's): every stochastic
        input of a step is a pure function of ``(seed, step)`` or
        ``(seed, epoch)`` —

        - per-step randomness: ``step.step_generator(seed, state.step)``,
          seeded from (seed + 1, step), draws the VAE posterior's noise
          (image batches), then t, noise and the CFG drop;
        - batch order for epoch ``e``: the ``np.random.default_rng((seed,
          e))`` permutation of the dataset (``data/loader.epoch_batches``);
        - EMA warmup counter: ``state.step`` itself.

        Checkpoints hold {model, EMA, optimizer, step}; on ``resume=True``
        the loop derives ``(start_epoch, batch offset)`` from the restored
        step and replays the epoch's permutation up to the offset, so a
        run resumed after any interruption (epoch end, stop flag,
        ``max_steps``) ends bitwise equal to an uninterrupted ``run(epochs)``
        with the same dataset, batch size, seed and device.

        ``max_steps``: checkpoint and stop once ``state.step`` reaches it.
        """
        tcfg = self.exp.train
        epochs = epochs if epochs is not None else tcfg.epochs
        bs = self.exp.data.batch_size
        state = self.init_state()
        start_epoch, skip_batches = 0, 0
        if resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state, mesh=self.mesh)
            steps_per_epoch = max(len(self.dataset) // bs, 1)
            start_epoch = state.step // steps_per_epoch
            skip_batches = state.step - start_epoch * steps_per_epoch
            log.info("resumed from step %d (epoch %d, %d batches into it)",
                     state.step, start_epoch, skip_batches)

        step_fn = make_train_step(self.schedule, self.exp, self.encode_fn,
                                  forward=self._forward_model(), rows=self.rows,
                                  world=self.mesh.data)
        history = []
        stopped = False
        self.epoch_seconds = []
        # Host-sync discipline: the step never reads a device value; the
        # losses are reduced on the device and read once per epoch, and the
        # metrics once per log_every steps, as ONE stacked transfer.
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            losses = []
            for bi, batch in enumerate(epoch_batches(
                self.dataset, bs, epoch=epoch, seed=tcfg.seed, map_fn=self._device_batch,
                rows=self.rows,
            )):
                if epoch == start_epoch and bi < skip_batches:
                    continue  # replay the interrupted epoch's permutation
                if self._should_stop():
                    log.info("stop flag raised; finishing at epoch %d", epoch)
                    stopped = True
                    break
                if max_steps is not None and state.step >= max_steps:
                    log.info("max_steps %d reached; checkpoint and stop", max_steps)
                    stopped = True
                    break
                metrics = step_fn(state, batch)
                losses.append(metrics["loss"])
                self.timer.tick()
                if state.step % max(tcfg.log_every, 1) == 0:
                    keys = sorted(metrics)
                    vals = self._global_mean(torch.stack([metrics[k] for k in keys])).tolist()
                    if self.metrics is not None:
                        self.metrics.log(state.step, **dict(zip(keys, vals)),
                                         step_time=self.timer.step_time_ema or 0.0)
            if losses:
                # the epoch's one sync
                mean_loss = self._global_mean(torch.stack(losses).mean()).item()
                history.append(mean_loss)
                self.epoch_seconds.append((time.time() - t0, len(losses)))
                log.info("epoch %d: loss %.4f (%d steps, %.1fs)",
                         epoch, mean_loss, len(losses), time.time() - t0)
            save = stopped or (epoch + 1) % tcfg.ckpt_every_epochs == 0 or epoch == epochs - 1
            # data rank 0's model group: rank 0, and under a model axis the
            # ranks that hold the other shards (the gather and the sharded
            # preview need each of them)
            first = self.mesh.data_rank == 0
            if save and first:
                self.ckpt.save(state.step, state, {"loss": history[-1] if history else 0.0},
                               mesh=self.mesh)
            if save and self.distributed:
                dist.barrier(group=self._control)  # the checkpoint is on disk for every rank
            if (self.preview_fn is not None and first
                    and (epoch + 1) % tcfg.ckpt_every_epochs == 0):
                imgs = self.preview_fn(state, epoch)
                if imgs is not None and self.metrics is not None:
                    self.metrics.log_images(state.step, "preview", imgs)
            if stopped:
                break
        return state
