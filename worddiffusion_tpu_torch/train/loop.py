"""The training loop (port of ``worddiffusion_tpu/train/loop.py``):
epochs, checkpoints, previews, stop flag, resume.

The data comes from a latent cache (``data.dataset``), the production
fast path of the JAX trainer; the batches are staged on the device by
the prefetch worker.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch

from ..configs.config import Experiment
from ..data.loader import epoch_batches
from ..diffusion.schedule import NoiseSchedule
from ..models.layers import init_weights_
from ..models.unet import UNet
from ..utils.metrics import MetricsLogger, StepTimer
from ..utils.stop_flag import StopFlag
from .checkpoint import CheckpointManager
from .state import TrainState, make_optimizer
from .step import make_train_step

log = logging.getLogger("worddiffusion")


class Trainer:
    def __init__(
        self,
        exp: Experiment,
        dataset,
        preview_fn: Optional[Callable] = None,
        device: torch.device | str = "cuda",
    ):
        """``preview_fn(state, epoch)`` renders the fixed probe words.

        The FF sub-layer: ``use_pallas_ffn`` None or True runs the forward
        kernel and the backward kernel on a CUDA device, False the plain
        autograd path. The JAX Trainer resolves None to off from TPU v5e
        measurements, which say nothing about this card. On an H100
        (700 W, ``iam`` width, B=128) the two paths' s/step lay within
        each other's run-to-run spread (the step is host-bound), and the
        kernel path's peak memory was 3.9 against 6.2 GiB (PERF.md), so
        None stays on the kernels for the memory; ``chip_smoke.py``
        phase 7 times both."""
        self.exp = exp
        self.dataset = dataset
        self.preview_fn = preview_fn
        self.device = torch.device(device)
        self.schedule = NoiseSchedule.linear(
            exp.diffusion.num_steps, exp.diffusion.beta_start, exp.diffusion.beta_end
        )
        self.model = UNet(exp.unet).to(self.device)
        self.ckpt = CheckpointManager(f"{exp.train.save_path}/ckpt")
        self.stop = StopFlag(exp.train.stop_flag_file)
        self.metrics = MetricsLogger(f"{exp.train.save_path}/metrics.jsonl")
        self.timer = StepTimer()
        # (wall seconds, steps) per completed epoch of the last run(): the
        # end-to-end training rate including host batch assembly
        self.epoch_seconds: list[tuple[float, int]] = []

    def init_state(self) -> TrainState:
        """A fresh state from the seeded initialisation (every run() starts
        from it, as every JAX run() inits its params)."""
        init_weights_(self.model, self.exp.train.seed)
        opt = make_optimizer(self.model.parameters(), self.exp.train.lr,
                             self.exp.train.weight_decay)
        return TrainState.create(self.model.train(), opt)

    def _to_device(self, a) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _device_batch(self, batch: dict) -> dict:
        out = {
            "latent": self._to_device(batch["latent"].astype("float32", copy=False)),
            "context": self._to_device(batch["context"].astype("int64")),
            "writer": self._to_device(batch["writer"].astype("int64")),
        }
        if "phosc" in batch:
            out["phosc"] = self._to_device(batch["phosc"].astype("int64"))
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
          seeded from (seed + 1, step), draws t, noise and the CFG drop;
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
            state = self.ckpt.restore(state)
            steps_per_epoch = max(len(self.dataset) // bs, 1)
            start_epoch = state.step // steps_per_epoch
            skip_batches = state.step - start_epoch * steps_per_epoch
            log.info("resumed from step %d (epoch %d, %d batches into it)",
                     state.step, start_epoch, skip_batches)

        step_fn = make_train_step(self.schedule, self.exp)
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
            )):
                if epoch == start_epoch and bi < skip_batches:
                    continue  # replay the interrupted epoch's permutation
                if self.stop.should_stop():
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
                    vals = torch.stack([metrics[k] for k in keys]).tolist()
                    self.metrics.log(state.step, **dict(zip(keys, vals)),
                                     step_time=self.timer.step_time_ema or 0.0)
            if losses:
                mean_loss = torch.stack(losses).mean().item()  # the epoch's one sync
                history.append(mean_loss)
                self.epoch_seconds.append((time.time() - t0, len(losses)))
                log.info("epoch %d: loss %.4f (%d steps, %.1fs)",
                         epoch, mean_loss, len(losses), time.time() - t0)
            if stopped or (epoch + 1) % tcfg.ckpt_every_epochs == 0 or epoch == epochs - 1:
                self.ckpt.save(state.step, state, {"loss": history[-1] if history else 0.0})
            if self.preview_fn is not None and (epoch + 1) % tcfg.ckpt_every_epochs == 0:
                imgs = self.preview_fn(state, epoch)
                if imgs is not None:
                    self.metrics.log_images(state.step, "preview", imgs)
            if stopped:
                break
        return state
