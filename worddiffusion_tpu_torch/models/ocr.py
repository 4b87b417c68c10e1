"""CTC word recognizer for the regeneration filter (port of
``worddiffusion_tpu/models/ocr.py``).

Input: grayscale word image [B, 64, W, 1] in [-1, 1], NHWC. Output:
CTC logits [B, W/4, num_classes] fp32. In training (``deterministic=False``)
the sequence takes flax's ``Dropout(0.25)`` before the head, its keep mask
drawn from an explicit ``torch.Generator`` or handed in. Parameter names follow the
Flax module tree (``b1.conv0``, ``b1.gn0``, ..., ``t0``, ``head``);
``models.convert.jax_ocr_to_torch`` maps a Flax tree onto them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2D, Dense, GroupNorm32


class _Conv1D(nn.Conv1d):
    """Temporal conv with fp32 params that computes in its input's dtype;
    SAME padding for kernel 3 at dilation ``dil``."""

    def __init__(self, ch: int, dil: int):
        super().__init__(ch, ch, 3, padding=dil, dilation=dil)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvBlock(nn.Module):
    """(3x3 conv -> GroupNorm(min(32, f), eps 1e-6, fp32) -> relu) x 2,
    then a VALID max-pool."""

    def __init__(self, in_ch: int, features: int, pool: tuple, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.pool = pool
        self.conv0 = Conv2D(in_ch, features)
        self.gn0 = GroupNorm32(features, groups=min(32, features), eps=1e-6)
        self.conv1 = Conv2D(features, features)
        self.gn1 = GroupNorm32(features, groups=min(32, features), eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.gn0(self.conv0(x).to(self.dtype)))
        x = F.relu(self.gn1(self.conv1(x).to(self.dtype)))
        if self.pool != (1, 1):
            x = F.max_pool2d(x, self.pool, self.pool)
        return x


class CTCRecognizer(nn.Module):
    """conv trunk -> column features -> dilated temporal convs -> CTC
    logits. ``widths`` scales every stage (tests use narrow models)."""

    def __init__(self, num_classes: int = 54, widths: tuple = (64, 128, 256, 256, 512),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w1, w2, w3, w4, w5 = widths
        self.b1 = ConvBlock(1, w1, (2, 2), dtype)     # 32 x W/2
        self.b2 = ConvBlock(w1, w2, (2, 2), dtype)    # 16 x W/4
        self.b3 = ConvBlock(w2, w3, (2, 1), dtype)    # 8  x W/4
        self.b4 = ConvBlock(w3, w4, (2, 1), dtype)    # 4  x W/4
        self.b5 = ConvBlock(w4, w5, (4, 1), dtype)    # 1  x W/4
        self.t0, self.t1, self.t2 = (_Conv1D(w5, dil) for dil in (1, 2, 4))
        self.head = Dense(w5, num_classes)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """x NHWC [B, 64, W, 1] -> logits [B, W/4, K]. ``deterministic=False``
        applies the dropout: ``keep`` (bool [B, W/4, C], the flax layout)
        when given, else a mask drawn from ``generator``."""
        if x.shape[1] != 64:
            raise ValueError(
                f"CTCRecognizer expects 64-px-high input, got {tuple(x.shape)} "
                "(the pooling stack collapses exactly 64 -> 1)"
            )
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        for block in (self.b1, self.b2, self.b3, self.b4, self.b5):
            h = block(h)
        seq = h[:, :, 0, :] if h.shape[2] == 1 else h.mean(dim=2)  # [B, C, T]
        for conv in (self.t0, self.t1, self.t2):
            seq = F.relu(conv(seq)) + seq
        seq = seq.transpose(1, 2)  # [B, T, C]
        if not deterministic:
            seq = self._dropout(seq, generator, keep)
        return self.head(seq).float()  # [B, T, K]

    @staticmethod
    def _dropout(seq: torch.Tensor, generator: torch.Generator | None,
                 keep: torch.Tensor | None, rate: float = 0.25) -> torch.Tensor:
        """flax ``nn.Dropout(rate)``: keep with probability 1 - rate and scale
        the kept by 1 / (1 - rate)."""
        if keep is None:
            if generator is None:
                raise ValueError("CTCRecognizer: training-mode dropout needs a torch.Generator "
                                 "or a keep mask")
            keep = torch.rand(seq.shape, generator=generator, device=seq.device) < 1.0 - rate
        return torch.where(keep.to(seq.device), seq / (1.0 - rate),
                           torch.zeros((), dtype=seq.dtype, device=seq.device))
