"""Forward (noising) process and timestep sampling (port of
``worddiffusion_tpu/diffusion/forward.py``).

Randomness comes from an explicit ``torch.Generator``; it gives other
numbers than JAX's threefry from the same seed, so the parity tests
hand both sides the same t and noise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .schedule import NoiseSchedule


def q_sample(schedule: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(a-hat_t) x0 + sqrt(1 - a-hat_t) eps, in fp32.
    x0, noise [B, ...]; t [B] int."""
    dev = x0.device
    sqrt_ah = torch.from_numpy(schedule.sqrt_alpha_hat).to(dev)[t]
    sqrt_omah = torch.from_numpy(schedule.sqrt_one_minus_alpha_hat).to(dev)[t]
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return sqrt_ah.reshape(shape) * x0 + sqrt_omah.reshape(shape) * noise


def sample_timesteps(schedule: NoiseSchedule, batch: int,
                     generator: Optional[torch.Generator] = None,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """t ~ Uniform{1, ..., T-1} (the reference never trains on t=0), int64."""
    return torch.randint(1, schedule.num_steps, (batch,), generator=generator,
                         device=device)
