"""Reverse-diffusion sampling (port of ``ddpm_sample``, ``ddim_sample``
and ``latent_to_image`` from ``worddiffusion_tpu/diffusion/sampler.py``).

The JAX version is one compiled ``lax.scan``; here it is a Python loop
over t = T-1 .. 1 whose work is queued on the device without a host
sync. A step whose call-mask entry is off reuses the previous eps
(zeros before the first call); the update math and the latent carry
are fp32; no noise is added at the last step. Classifier-free guidance
(``cfg_scale`` > 0 with an ``uncond_eps_fn``) replaces eps by ``uncond +
cfg_scale * (cond - uncond)`` on the steps that call the model.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedule import NoiseSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _guided(eps_fn: EpsFn, cfg_scale: float, uncond_eps_fn: Optional[EpsFn]) -> EpsFn:
    """eps_fn, or its classifier-free guided form where ``cfg_scale`` > 0
    and there is an unconditional model call."""
    if cfg_scale <= 0.0 or uncond_eps_fn is None:
        return eps_fn

    def guided(x, t):
        uncond = uncond_eps_fn(x, t)
        return uncond + cfg_scale * (eps_fn(x, t) - uncond)

    return guided


def regen_call_mask(
    num_steps: int, epoch: int = 0, full_sampling: bool = False
) -> np.ndarray:
    """Boolean mask over timesteps: True where the denoiser is invoked.

    Copied from ``worddiffusion_tpu/diffusion/sampler.py::regen_call_mask``
    (that module imports jax). The reference condition is ``i%100==0 or
    i%5==0 or i==T or i==T-1 or (epoch>3 and i%25==0) or (epoch>5 and
    i%15==0) or (epoch>10 and i%10==0)``.
    """
    if full_sampling:
        return np.ones(num_steps, dtype=bool)
    i = np.arange(num_steps)
    mask = (
        (i % 100 == 0)
        | (i % 5 == 0)
        | (i == num_steps)
        | (i == num_steps - 1)
    )
    if epoch > 3:
        mask |= i % 25 == 0
    if epoch > 5:
        mask |= i % 15 == 0
    if epoch > 10:
        mask |= i % 10 == 0
    return mask


@torch.no_grad()
def ddpm_sample(
    schedule: NoiseSchedule,
    eps_fn: EpsFn,
    x_init: torch.Tensor,
    *,
    stochastic: bool = True,
    call_mask: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    noise_seq: Optional[torch.Tensor] = None,
    cfg_scale: float = 0.0,
    uncond_eps_fn: Optional[EpsFn] = None,
) -> torch.Tensor:
    """Run the reverse process from ``x_init`` and return the final
    latent (fp32, ``x_init``'s layout).

    ``eps_fn(x, t) -> eps_hat``. ``stochastic=False`` is the
    regeneration's deterministic update. In stochastic mode the noise
    comes from ``noise_seq[t]`` when given (timestep-indexed, for tests
    that feed both frameworks the same noise), else from ``generator``.
    """
    eps_fn = _guided(eps_fn, cfg_scale, uncond_eps_fn)
    T = schedule.num_steps
    mask = np.ones(T, dtype=bool) if call_mask is None else np.asarray(call_mask)
    one = np.float32(1.0)
    x = x_init.float()
    eps = torch.zeros_like(x)
    for i in range(T - 1, 0, -1):
        if mask[i]:
            t = torch.full((x.shape[0],), i, dtype=torch.int32, device=x.device)
            eps = eps_fn(x, t).float()
        a, ah, b = schedule.alpha[i], schedule.alpha_hat[i], schedule.beta[i]
        coef = float((one - a) / np.sqrt(one - ah))
        x = (x - coef * eps) / float(np.sqrt(a))
        if stochastic and i > 1:
            if noise_seq is not None:
                noise = noise_seq[i].to(x.device, torch.float32)
            else:
                noise = torch.randn(x.shape, generator=generator, device=x.device)
            x = x + float(np.sqrt(b)) * noise
    return x


@torch.no_grad()
def ddim_sample(
    schedule: NoiseSchedule,
    eps_fn: EpsFn,
    x_init: torch.Tensor,
    *,
    num_steps: int = 50,
    eta: float = 0.0,
    cfg_scale: float = 0.0,
    uncond_eps_fn: Optional[EpsFn] = None,
    generator: Optional[torch.Generator] = None,
    noise_seq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM over a subsampled timestep grid (port of ``ddim_sample``):
    ``num_steps`` model calls from t = T-1 down to 0. ``eta`` 0 is
    deterministic; with ``eta`` > 0 each step but the last adds
    ``sigma * noise``, the noise from ``noise_seq[idx]`` when given (for
    tests that feed both frameworks the same noise), else from
    ``generator``. The step coefficients are fp32, as in the JAX scan."""
    eps_fn = _guided(eps_fn, cfg_scale, uncond_eps_fn)
    T = schedule.num_steps
    # the JAX grid is a float32 linspace, rounded half to even
    ts = np.linspace(T - 1, 0, num_steps + 1, dtype=np.float32).round().astype(np.int64)
    f32 = np.float32
    x = x_init.float()
    for idx in range(num_steps):
        t_cur, t_next = int(ts[idx]), int(ts[idx + 1])
        eps = eps_fn(x, torch.full((x.shape[0],), t_cur, dtype=torch.int32,
                                   device=x.device)).float()
        a_cur = schedule.alpha_hat[t_cur]
        a_next = schedule.alpha_hat[t_next] if t_next > 0 else f32(1.0)
        sigma = f32(eta) * np.sqrt((f32(1) - a_next) / (f32(1) - a_cur)) * np.sqrt(
            f32(1) - a_cur / a_next)
        x0 = (x - float(np.sqrt(f32(1) - a_cur)) * eps) / float(np.sqrt(a_cur))
        dir_xt = float(np.sqrt(np.maximum(f32(1) - a_next - sigma ** 2, f32(0)))) * eps
        x = float(np.sqrt(a_next)) * x0 + dir_xt
        if eta > 0 and t_next > 0:
            if noise_seq is not None:
                noise = noise_seq[idx].to(x.device, torch.float32)
            else:
                noise = torch.randn(x.shape, generator=generator, device=x.device)
            x = x + float(sigma) * noise
    return x


def latent_to_image(x: torch.Tensor, decode_fn, scaling: float = 0.18215) -> torch.Tensor:
    """VAE decode + [0, 1] clamp. NHWC float32."""
    img = decode_fn(x / scaling)
    return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)


def pixel_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """The pixel-space path's images: [-1, 1] -> uint8, truncating as JAX's
    ``astype(uint8)`` does (0.999 -> 254), in fp32 in the JAX order."""
    x = (torch.clamp(x.float(), -1.0, 1.0) + 1.0) / 2.0
    return (x * 255.0).to(torch.uint8)
