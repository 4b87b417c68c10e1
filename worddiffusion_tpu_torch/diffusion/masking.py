"""Inpainting-style latent masking (port of
``worddiffusion_tpu/diffusion/masking.py``, the ``sampling4.py``
experiments).

- the mask derives from reference latents: channel-mean > (1 - t/T), in
  fp32 as JAX computes it;
- the binary mask is dilated by a 3x3 max (``F.max_pool2d(3, 1, 1)``, whose
  padding is -inf, as JAX's ``reduce_window``) wherever ``int(1.68 * t /
  T) > 0``;
- the deterministic reverse update keeps masked regions pinned to the
  re-noised reference latent and lets the rest follow the denoiser.

The re-noising draws come from an explicit ``torch.Generator``, or from
``noises(i)`` (parity tests hand in JAX's ``fold_in(rng, i)`` draws).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .forward import q_sample
from .schedule import NoiseSchedule


def timestep_mask(ref_latents: torch.Tensor, t: int, num_steps: int,
                  dilate_scale: float = 1.68) -> torch.Tensor:
    """[B, H, W, C], step t -> the dilated binary mask [B, H, W, 1] in the
    latents' dtype."""
    m = ref_latents.mean(dim=-1, keepdim=True)
    thresh = np.float32(1.0) - np.float32(t) / np.float32(num_steps)
    mask = (m > float(thresh)).to(ref_latents.dtype)
    d_size = int(np.float32(dilate_scale) * np.float32(t) / np.float32(num_steps))
    if d_size <= 0:
        return mask
    k = 2 * max(1, int(dilate_scale)) + 1
    return F.max_pool2d(mask.permute(0, 3, 1, 2), k, 1, k // 2).permute(0, 2, 3, 1)


def masked_ddpm_sample(
    schedule: NoiseSchedule,
    eps_fn: Callable,
    ref_latents: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    x_init: Optional[torch.Tensor] = None,
    noises: Optional[Callable[[int], torch.Tensor]] = None,
    snapshot_every: int = 0,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Deterministic masked reverse process from step T-1 down to 1: masked
    (fixed) regions track ``q_sample(ref, t - 1)``, free regions follow
    ``eps_fn(x, t)``. x starts at ``x_init`` or a unit normal from
    ``generator``; step i's re-noising is ``noises(i)`` or a unit normal
    from ``generator``. Returns (final latent, every ``snapshot_every``-th
    intermediate stacked, or None)."""
    T = schedule.num_steps
    dev = ref_latents.device
    alpha = torch.from_numpy(schedule.alpha).to(dev)
    alpha_hat = torch.from_numpy(schedule.alpha_hat).to(dev)

    def draw(i=None):
        if i is not None and noises is not None:
            return noises(i).to(dev)
        return torch.randn(ref_latents.shape, generator=generator, device=dev)

    x = x_init if x_init is not None else draw()
    snaps = []
    for i in range(T - 1, 0, -1):
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=dev)
        eps = eps_fn(x, t)
        a, ah = alpha[i], alpha_hat[i]
        x = (x - ((1.0 - a) / torch.sqrt(1.0 - ah)) * eps) / torch.sqrt(a)
        ref_t = q_sample(schedule, ref_latents, torch.clamp_min(t - 1, 0), draw(i))
        mask = timestep_mask(ref_latents, i, T)
        x = mask * ref_t + (1.0 - mask) * x
        if snapshot_every:
            snaps.append(x)
    if snapshot_every:
        return x, torch.stack(snaps)[::snapshot_every]
    return x, None
