# Copy of worddiffusion_tpu/utils/stop_flag.py: the port imports nothing of the JAX package.
"""Cooperative stop-flag files.

Compat with the reference ops mechanism (``trainModifyCondition.py:
667-676``, ``regenerateFromtrain2.py:523-529``, ``ResPhoSCNetZSL/
main.py:276-285``): a text file holding an integer; 0 means "stop at
the next batch". Polling is rate-limited so the hot loop never waits on
filesystem latency.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class StopFlag:
    def __init__(self, path: Optional[str], poll_interval_s: float = 2.0):
        self.path = path
        self.poll_interval_s = poll_interval_s
        self._last_poll = 0.0
        self._stopped = False

    def should_stop(self) -> bool:
        if self.path is None or self._stopped:
            return self._stopped
        now = time.monotonic()
        if now - self._last_poll < self.poll_interval_s:
            return False
        self._last_poll = now
        try:
            with open(self.path) as f:
                self._stopped = int(f.read().strip() or "1") == 0
        except (OSError, ValueError):
            self._stopped = False
        return self._stopped

    def arm(self) -> None:
        """Write 1 (run) to the flag file, creating it."""
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                f.write("1")
