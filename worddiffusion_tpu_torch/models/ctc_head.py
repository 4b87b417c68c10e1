"""Auxiliary CTC OCR head on the denoiser output (port of
``worddiffusion_tpu/models/ctc_head.py``, the reference ``CTCtopC``).

A stack of (1, 5) temporal convolutions along the width axis, each with
a GroupNorm and a ReLU, a class projection, then two dense layers that
widen the 32-wide latent into 256 CTC frames; the first height row is
the CTC sequence. The parameter names are the reference's
(``auxhead.temporal_i.0`` the conv, ``.1`` its norm), which the JAX
converter reads. The norm is flax's ``GroupNorm`` default (32 groups, eps
1e-6, not ``GroupNorm32``'s 1e-5), run by ``ops.groupnorm`` without SiLU
(kernel B.5 on the card); ``norm="none"`` (converted reference heads,
whose BatchNorm is folded into the convs) has no norm. The dropout slot
is a no-op, as JAX applies the head with ``deterministic=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2D, Dense, GroupNorm32

FRAMES = 256  # CTC frames: lin1 then lin2 widen the latent's width to these
WIDTH = 32    # the latent's width (of the 64 x 256 word crops)


def _temporal(in_ch: int, out_ch: int, norm: str) -> nn.Sequential:
    conv = Conv2D(in_ch, out_ch, (1, 5), padding=(0, 2))
    if norm == "group":
        return nn.Sequential(conv, GroupNorm32(out_ch, min(32, out_ch), eps=1e-6))
    if norm == "none":
        return nn.Sequential(conv)
    raise ValueError(f"CTCHead norm {norm!r}: takes 'group' or 'none'")


class CTCHead(nn.Module):
    """forward(eps [B, C, H, WIDTH], NCHW in the model's dtype) -> logits
    [FRAMES, B, nclasses] fp32."""

    def __init__(self, in_ch: int = 4, hidden: int = 256, layers: int = 3, nclasses: int = 52,
                 norm: str = "group"):
        super().__init__()
        self.temporal_i = _temporal(in_ch, hidden, norm)
        self.temporal_m = nn.ModuleList([_temporal(hidden, hidden, norm) for _ in range(layers)])
        self.temporal_o = Conv2D(hidden, nclasses, (1, 5), padding=(0, 2))
        self.lin1 = Dense(WIDTH, FRAMES // 2)
        self.lin2 = Dense(FRAMES // 2, FRAMES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for block in (self.temporal_i, *self.temporal_m):
            y = block[0](y)
            if len(block) > 1:
                y = block[1](y)
            y = F.relu(y)
        y = self.temporal_o(y)[:, :, 0]  # [B, K, W]: only height row 0 is kept
        y = self.lin2(self.lin1(y))       # [B, K, T]
        return y.permute(2, 0, 1).float()
