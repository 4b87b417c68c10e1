# Copy of worddiffusion_tpu/utils/metrics.py (MetricsLogger and StepTimer): the port imports nothing of the JAX package.
"""Metrics logging — first-class observability.

- ``MetricsLogger``: JSONL metrics stream + optional wandb mirror
  (wandb is used only if importable AND explicitly enabled),
- ``StepTimer``: wall-clock per-step timing with EMA.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: str, use_wandb: bool = False, wandb_project: str = ""):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project or "worddiffusion-tpu")
            except Exception:
                self._wandb = None

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, step: int, key: str, images) -> None:
        """Mirror preview grids to wandb (the reference logs sampled
        images per epoch, ``train.py:311-313``); JSONL records only the
        shape — images live on disk next to it."""
        import numpy as np

        arr = np.asarray(images)
        self._f.write(json.dumps({
            "step": int(step), "time": time.time(),
            f"{key}_shape": list(arr.shape),
        }) + "\n")
        if self._wandb is not None:
            self._wandb.log(
                {key: [self._wandb.Image(a) for a in arr]}, step=step
            )

    def close(self) -> None:
        self._f.close()


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self._ema_coeff = ema
        self._last: Optional[float] = None
        self.step_time_ema: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.step_time_ema = (
                dt if self.step_time_ema is None
                else self._ema_coeff * self.step_time_ema + (1 - self._ema_coeff) * dt
            )
        self._last = now
        return dt
