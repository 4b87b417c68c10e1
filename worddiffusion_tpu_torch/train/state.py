"""Train state: step, model, optimizer and EMA copy (port of
``worddiffusion_tpu/train/state.py``).

EMA semantics match the JAX package (reference ``train.py:140-170``):
while the step before the update is below ``warmup`` the EMA copy is
reset to the raw parameters; afterwards it is ``ema*beta + p*(1-beta)``.
The port updates the EMA and the parameters in place.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: nn.Module

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer) -> "TrainState":
        ema = copy.deepcopy(model).requires_grad_(False).eval()
        return cls(step=0, model=model, optimizer=optimizer, ema=ema)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, step: int, beta: float, warmup: int) -> None:
    """In place; ``step`` is the count of updates before this one."""
    e = list(ema.parameters())
    p = list(model.parameters())
    if step < warmup:
        torch._foreach_copy_(e, p)
    else:
        torch._foreach_mul_(e, beta)
        torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - beta))


def make_optimizer(params, lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW lr=1e-4 (reference ``trainModifyCondition.py:1110``). The
    defaults are optax.adamw's: b1 0.9, b2 0.999, eps 1e-8, decoupled
    decay on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)
