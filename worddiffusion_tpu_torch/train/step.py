"""The training step (port of ``worddiffusion_tpu/train/step.py``):
q_sample -> UNet -> MSE(eps) [+ CTC aux] -> backward -> AdamW -> EMA.

The step's randomness (timesteps, noise, the writer-conditioning drop)
is drawn from a ``torch.Generator`` that is a pure function of
(seed, step), so every step is reproducible. ``StepDraws`` can also be
handed in, which is how the parity tests feed JAX's draws to the port.

Batch dict layout (``data.loader``, staged on the device):
  ``latent``  [B, 8, 32, 4] float32 — VAE latents, already * 0.18215
              (or ``image`` [B, H, W, 3] float32 in [-1, 1], encoded by
              the step's ``encode_fn``, or itself x0 in pixel space:
              ``exp.data.latent`` False)
  ``context`` [B, L] int64 char ids
  ``writer``  [B] int64 dense writer index
  ``phosc``   [B, P] int64 PHOSC ids (``use_phosc`` models)
  ``ocr_ids`` [B, L] int64 CTC targets, ``ocr_len`` [B] their lengths
              (``ctc_weight`` > 0 with the aux head)
  ``style_vec``    [B, D] float32 writer-style vectors (``style_vec_dim``)
  ``char_images``  [B, L, gh, gw, 1] glyph crops (``use_char_images``)
  ``cond_latents`` [B, 8, 32, 4] reference latents (``img_conditioned``;
                   defaults to the clean ``latent``)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.config import Experiment
from ..diffusion.forward import q_sample, sample_timesteps
from ..diffusion.schedule import NoiseSchedule
from ..ops.ctc import ctc_loss
from .state import TrainState, ema_update


def _check_conditioning_keys(exp: Experiment, batch) -> None:
    """Refuse a model config that needs a conditioning input the batch
    lacks (the JAX step's check; the reference silently trains without
    it, ``unet.py:1628``)."""
    required = []
    if exp.unet.style_vec_dim:
        required.append("style_vec")
    if exp.unet.use_char_images:
        required.append("char_images")
    if exp.unet.img_conditioned and "latent" not in batch:
        required.append("cond_latents")
    missing = [k for k in required if batch.get(k) is None]
    if missing:
        raise ValueError(
            f"UNet config requires conditioning batch keys {missing} but the "
            "batch only has "
            f"{sorted(k for k, v in batch.items() if v is not None)}"
        )


@dataclasses.dataclass
class StepDraws:
    t: torch.Tensor                # [B] in [1, T)
    noise: torch.Tensor            # latent-shaped fp32
    keep: Optional[torch.Tensor]   # scalar 0/1 fp32: keep the writer conditioning


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``: seeded from (seed + 1, step), as the
    JAX loop folds the step into ``PRNGKey(seed + 1)``."""
    mixed = np.random.SeedSequence([seed + 1, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def draw_step(schedule: NoiseSchedule, exp: Experiment, latent: torch.Tensor,
              generator: torch.Generator, rows: Optional[slice] = None,
              world: int = 1) -> StepDraws:
    """t, noise and the CFG keep flag, in that order, on the latent's device.
    Under data parallelism (``world`` processes, this one holding ``rows`` of
    the global batch) every process draws the global batch's t and noise and
    keeps its rows, so that the step is the one-process step."""
    b, dev = latent.shape[0] * world, latent.device
    t = sample_timesteps(schedule, b, generator, dev)
    noise = torch.randn((b,) + tuple(latent.shape[1:]), generator=generator, device=dev)
    if rows is not None:
        t, noise = t[rows], noise[rows]
    keep = None
    if exp.train.cfg_drop_prob > 0:
        u = torch.rand((), generator=generator, device=dev)
        keep = (u >= exp.train.cfg_drop_prob).float()
    return StepDraws(t, noise, keep)


def loss_fn(model, schedule: NoiseSchedule, exp: Experiment, batch: dict,
            draws: StepDraws):
    """-> (loss, metrics) as device tensors; MSE in fp32."""
    _check_conditioning_keys(exp, batch)
    latent = batch["latent"]
    x_t = q_sample(schedule, latent, draws.t, draws.noise)
    writer_mask = None
    if draws.keep is not None:
        # one draw per batch: the whole batch keeps or drops its writer
        # (reference train.py:284-285)
        writer_mask = torch.ones(latent.shape[0], device=latent.device) * draws.keep
    cond_latents = None
    if exp.unet.img_conditioned:
        # the clean latents of the same batch condition it (reference
        # trainModifyCondition.py:733)
        cond_latents = batch.get("cond_latents", latent)
    out = model(x_t, draws.t, batch["context"], batch["writer"], phosc_ids=batch.get("phosc"),
                writer_mask=writer_mask, style_vec=batch.get("style_vec"),
                char_images=batch.get("char_images"), cond_latents=cond_latents)
    out = out if isinstance(out, tuple) else (out,)  # (eps[, logits][, maps])
    eps, ocr_logits = out[0], (out[1] if exp.unet.ocr_head else None)
    mse = (eps.float() - draws.noise).square().mean()
    metrics = {"mse": mse.detach()}
    loss = mse
    if exp.train.ctc_weight > 0 and ocr_logits is not None:
        # the mean over the batch of each sequence's NLL (jnp.mean of
        # optax.ctc_loss), blank 0; the head gives [T, B, K]
        ctc = ctc_loss(ocr_logits.transpose(0, 1), batch["ocr_ids"], batch["ocr_len"],
                       blank_id=0).mean()
        loss = loss + exp.train.ctc_weight * ctc
        metrics["ctc"] = ctc.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def make_train_step(schedule: NoiseSchedule, exp: Experiment,
                    encode_fn: Optional[Callable] = None, forward: Optional[Callable] = None,
                    rows: Optional[slice] = None, world: int = 1):
    """-> ``train_step(state, batch, draws=None) -> metrics``; updates
    ``state`` in place. Without ``draws`` the step draws its own from
    ``step_generator(exp.train.seed, state.step)``.

    A batch of images (``image`` [B, H, W, 3] in [-1, 1], no ``latent``)
    is first encoded by ``encode_fn(images, generator) -> latent`` under
    no_grad, with the step's generator (the posterior sample's noise is
    its first draw), so a resumed run stays bitwise the uninterrupted one.
    In pixel space (``exp.data.latent`` False) the image is x0 itself.

    Data parallelism: ``forward`` is the module the loss calls (the
    ``DistributedDataParallel`` wrapper of ``state.model``, whose backward
    averages the gradients over the processes), and the batch is this
    process's ``rows`` of a global batch of ``world`` times its size; the
    draws are the global batch's (``draw_step``), so the mean of the
    processes' losses is the global batch's loss."""
    tcfg = exp.train

    def train_step(state: TrainState, batch: dict, draws: Optional[StepDraws] = None):
        gen = None
        if "latent" not in batch and not exp.data.latent:
            batch = {**batch, "latent": batch["image"]}
        if "latent" not in batch:
            if encode_fn is None:
                raise ValueError("a batch of images needs the train step's encode_fn (the VAE)")
            gen = step_generator(tcfg.seed, state.step, batch["image"].device)
            with torch.no_grad():
                if world > 1:  # the global batch's posterior noise, this process's rows
                    img = batch["image"]
                    shape = (img.shape[0] * world, img.shape[1] // 8, img.shape[2] // 8,
                             exp.vae.latent_channels)
                    noise = torch.randn(shape, generator=gen, device=img.device)[rows]
                    lat = encode_fn(img, gen, noise=noise)
                else:
                    lat = encode_fn(batch["image"], gen)
                batch = {**batch, "latent": lat}
        if draws is None:
            if gen is None:
                gen = step_generator(tcfg.seed, state.step, batch["latent"].device)
            draws = draw_step(schedule, exp, batch["latent"], gen, rows, world)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(forward or state.model, schedule, exp, batch, draws)
        loss.backward()
        for p in state.model.parameters():
            if p.grad is None:  # unused by this config (a replaced context): AdamW
                p.grad = torch.zeros_like(p)  # still decays it, as optax.adamw does
        state.optimizer.step()
        ema_update(state.ema, state.model, state.step, tcfg.ema_beta, tcfg.ema_warmup_steps)
        state.step += 1
        return metrics

    return train_step
