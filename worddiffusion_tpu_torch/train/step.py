"""The training step (port of ``worddiffusion_tpu/train/step.py``):
q_sample -> UNet -> MSE(eps) -> backward -> AdamW -> EMA.

The step's randomness (timesteps, noise, the writer-conditioning drop)
is drawn from a ``torch.Generator`` that is a pure function of
(seed, step), so every step is reproducible. ``StepDraws`` can also be
handed in, which is how the parity tests feed JAX's draws to the port.

Batch dict layout (``data.loader``, staged on the device):
  ``latent``  [B, 8, 32, 4] float32 — VAE latents, already * 0.18215
  ``context`` [B, L] int64 char ids
  ``writer``  [B] int64 dense writer index
  ``phosc``   [B, P] int64 PHOSC ids (``use_phosc`` models)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.config import Experiment
from ..diffusion.forward import q_sample, sample_timesteps
from ..diffusion.schedule import NoiseSchedule
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
              generator: torch.Generator) -> StepDraws:
    """t, noise and the CFG keep flag, in that order, on the latent's device."""
    b, dev = latent.shape[0], latent.device
    t = sample_timesteps(schedule, b, generator, dev)
    noise = torch.randn(latent.shape, generator=generator, device=dev)
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
    eps = model(x_t, draws.t, batch["context"], batch["writer"], phosc_ids=batch.get("phosc"),
                writer_mask=writer_mask)
    mse = (eps.float() - draws.noise).square().mean()
    return mse, {"mse": mse.detach(), "loss": mse.detach()}


def make_train_step(schedule: NoiseSchedule, exp: Experiment):
    """-> ``train_step(state, batch, draws=None) -> metrics``; updates
    ``state`` in place. Without ``draws`` the step draws its own from
    ``step_generator(exp.train.seed, state.step)``."""
    tcfg = exp.train

    def train_step(state: TrainState, batch: dict, draws: Optional[StepDraws] = None):
        if draws is None:
            gen = step_generator(tcfg.seed, state.step, batch["latent"].device)
            draws = draw_step(schedule, exp, batch["latent"], gen)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, schedule, exp, batch, draws)
        loss.backward()
        state.optimizer.step()
        ema_update(state.ema, state.model, state.step, tcfg.ema_beta, tcfg.ema_warmup_steps)
        state.step += 1
        return metrics

    return train_step
