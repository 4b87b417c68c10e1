"""Checkpoints of the full train state (port of
``worddiffusion_tpu/train/checkpoint.py``, which uses orbax).

Each checkpoint is a step-named directory ``<dir>/<step>/`` holding
``state.pt`` ({step, model, optimizer, ema, metrics}) and ``ema_unet.pt``,
the EMA weights alone as a reference-keyed UNet state dict: the
regeneration CLI's ``--torch_ckpt``. Both are written with
``torch.save`` into a temporary directory that ``os.replace`` then
moves into place, so a reader never sees half a checkpoint. The newest
``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

from .state import TrainState

STATE_FILE = "state.pt"
EMA_FILE = "ema_unet.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(self.path(int(n), STATE_FILE)))

    def path(self, step: int, name: str = STATE_FILE) -> str:
        return os.path.join(self.directory, str(step), name)

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None) -> None:
        tmp = tempfile.mkdtemp(prefix=".tmp-", dir=self.directory)
        torch.save({
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema.state_dict(),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }, os.path.join(tmp, STATE_FILE))
        torch.save(state.ema.state_dict(), os.path.join(tmp, EMA_FILE))
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Loads the checkpoint into ``state`` in place and returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ck = torch.load(self.path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(ck["model"])
        state.ema.load_state_dict(ck["ema"])
        state.optimizer.load_state_dict(ck["optimizer"])
        state.step = int(ck["step"])
        return state
