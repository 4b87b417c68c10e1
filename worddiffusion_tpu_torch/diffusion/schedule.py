# Copy of worddiffusion_tpu/diffusion/schedule.py: the port imports nothing of the JAX package.
"""DDPM noise schedule.

Linear beta schedule matching the reference ``Diffusion`` classes:
``torch.linspace(1e-4, 0.02, steps)`` with 600 steps in the main trainer
(``trainModifyCondition.py:515-529``) and 1000 in the original
(``train.py:175-188``). All derived arrays are precomputed in float32 on
host; inside jit they become compile-time constants gathered by traced
timesteps, which XLA lowers to cheap dynamic-slices — no host sync in
the hot loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    num_steps: int
    beta: np.ndarray            # [T]
    alpha: np.ndarray           # [T] = 1 - beta
    alpha_hat: np.ndarray       # [T] = cumprod(alpha)

    @classmethod
    def linear(
        cls,
        num_steps: int = 600,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
    ) -> "NoiseSchedule":
        beta = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
        alpha = 1.0 - beta
        alpha_hat = np.cumprod(alpha)
        return cls(
            num_steps=num_steps,
            beta=beta.astype(np.float32),
            alpha=alpha.astype(np.float32),
            alpha_hat=alpha_hat.astype(np.float32),
        )

    @property
    def sqrt_alpha_hat(self) -> np.ndarray:
        return np.sqrt(self.alpha_hat)

    @property
    def sqrt_one_minus_alpha_hat(self) -> np.ndarray:
        return np.sqrt(1.0 - self.alpha_hat)
