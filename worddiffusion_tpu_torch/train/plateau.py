"""Reduce-on-plateau learning-rate scale: the counterpart of
``optax.contrib.reduce_on_plateau`` (optax 0.2.6) with one value a step
(``accumulation_size=1``) and no floor on the scale (``min_scale=0``), as
``cli/train_phosc`` configures it, step for step.

The state machine is optax's, not ``torch.optim.lr_scheduler.ReduceLROnPlateau``'s
(whose thresholds, cooldown and counting differ): one ``update(value)`` per
optimizer step; a value below ``(1 - rtol) * best - atol`` is an
improvement; ``patience`` steps without one multiply the scale by
``factor`` and start ``cooldown`` steps in which the plateau count stays 0.
Values, thresholds and the scale are float32 as in optax, so the scale
sequence is the same for the same values. optax multiplies the whole update
by the scale; for AdamW that is setting the learning rate to ``base *
scale`` (``apply``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_f32 = np.float32


@dataclasses.dataclass
class ReduceOnPlateau:
    factor: float = 0.1
    patience: int = 10
    rtol: float = 1e-4
    atol: float = 0.0
    cooldown: int = 0
    scale: np.float32 = _f32(1.0)
    best_value: np.float32 = _f32(np.inf)
    plateau_count: int = 0
    cooldown_count: int = 0

    def __post_init__(self):
        if not 0.0 < self.factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {self.factor}.")
        if self.rtol < 0.0 or self.atol < 0.0:
            raise ValueError("Both rtol and atol must be non-negative, got "
                             f"rtol = {self.rtol} and atol = {self.atol}.")
        if self.rtol == 0.0 and self.atol == 0.0:
            raise ValueError("At least one of rtol or atol must be positive, got "
                             f"rtol = {self.rtol} and atol = {self.atol}.")
        if self.rtol > 1.0:
            raise ValueError(f"rtol must be less than or equal to 1.0, got rtol = {self.rtol}.")

    def update(self, value: float) -> float:
        """One optimizer step's value -> the scale that step applies."""
        value = _f32(value)
        with np.errstate(over="ignore", invalid="ignore"):
            improved = value < _f32(_f32(1 - self.rtol) * self.best_value) - _f32(self.atol)
        if improved:
            self.best_value = value
        plateau = 0 if improved else self.plateau_count + 1
        if self.cooldown_count > 0:
            self.plateau_count, self.cooldown_count = 0, self.cooldown_count - 1
        elif plateau == self.patience:
            self.scale = _f32(self.scale * _f32(self.factor))
            if self.scale < np.finfo(np.float32).tiny:  # XLA flushes subnormals to 0
                self.scale = _f32(0.0)
            self.plateau_count, self.cooldown_count = 0, self.cooldown
        else:
            self.plateau_count, self.cooldown_count = plateau, 0
        return float(self.scale)

    def apply(self, optimizer: torch.optim.Optimizer, base_lr: float, value: float) -> float:
        """``update(value)``, then every param group's lr = ``base_lr`` x scale;
        returns the scale."""
        scale = self.update(value)
        for group in optimizer.param_groups:
            group["lr"] = base_lr * scale
        return scale
