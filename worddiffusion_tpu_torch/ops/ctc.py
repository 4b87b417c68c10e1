"""Greedy CTC decoding (port of the decode half of
``worddiffusion_tpu/ops/ctc.py``; the CTC loss is not ported yet).

The argmax runs on the device, the string assembly on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def greedy_frame_ids(logits: torch.Tensor) -> torch.Tensor:
    """[B, T, K] -> [B, T] int32 argmax ids (device side)."""
    return logits.argmax(dim=-1).to(torch.int32)


def collapse_and_decode(
    frame_ids: np.ndarray, alphabet: str, blank: str = "_"
) -> list[str]:
    """Host-side: collapse adjacent repeats, map to chars, drop blanks.

    Copied from ``worddiffusion_tpu/ops/ctc.py::collapse_and_decode``
    (that module imports jax and optax). Repeats are collapsed *before*
    blank removal, as in the reference decode loop.
    """
    out = []
    for row in np.asarray(frame_ids):
        prev = None
        chars = []
        for t in row:
            t = int(t)
            if t != prev:
                chars.append(alphabet[t] if t < len(alphabet) else "")
            prev = t
        out.append("".join(chars).replace(blank, "").strip())
    return out
