"""Writer-style image encoder (port of ``worddiffusion_tpu/models/style.py``).

A ResNet50-shaped trunk (a 7x7 stride-2 stem, a 3x3 stride-2 max-pool, then
3, 4, 6 and 3 bottlenecks of 64, 128, 256 and 512 features, x4 out) with a
global max pool -> [B, 2048] style vector, or ``out_dim`` through a
projection. Its 48 GroupNorms (``min(32, C)`` groups, eps 1e-6, fp32
statistics, no SiLU) run kernel B.5 on the card through
``models.layers.GroupNorm32``; flax's SAME padding, asymmetric at stride 2,
comes from ``phoscnet.SameConv`` and the max-pool pads (0, 1) with -inf as
flax does. The trunk runs NCHW in ``channels_last`` memory (the NHWC input
permuted, a view), so each GroupNorm hands B.5 its NHWC view.

Module and parameter names follow the flax tree (``stem``, ``s0b0.c1``,
``s0b0.n1``, ..., ``proj``); ``models.convert.jax_style_to_torch`` maps a
flax tree onto them and ``torch_style_to_jax`` back.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense
from .phoscnet import SameConv, _norm, _same_pads

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class _Bottleneck(nn.Module):
    """1x1 -> GN -> ReLU -> 3x3 (stride) -> GN -> ReLU -> 1x1 (x4) -> GN, plus
    the input (through a 1x1 conv where the shape changes), then ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out_f = features * 4
        self.c1, self.n1 = SameConv(cin, features, 1), _norm(features)
        self.c2, self.n2 = SameConv(features, features, 3, stride), _norm(features)
        self.c3, self.n3 = SameConv(features, out_f, 1), _norm(out_f)
        self.sc = SameConv(cin, out_f, 1, stride) if cin != out_f or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.sc is None else self.sc(x)
        h = F.relu(self.n1(self.c1(x)))
        h = F.relu(self.n2(self.c2(h)))
        return F.relu(self.n3(self.c3(h)) + res)


def _max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: -inf padding
    split as flax's SAME splits it."""
    (top, bottom), (left, right) = (_same_pads(n, k, s) for n in x.shape[2:])
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), k, s)


class StyleEncoder(nn.Module):
    """x NHWC [B, H, W, 3] in [-1, 1] -> [B, 2048] fp32 (or [B, out_dim]
    through ``proj``). Parameters are fp32; the trunk computes in ``dtype``
    (bf16 by default, the only dtype B.5 takes on the card)."""

    def __init__(self, out_dim: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_dim, self.dtype = out_dim, dtype
        self.stem = SameConv(3, 64, 7, 2)
        self.blocks: list[str] = []
        cin = 64
        for stage, (feats, blocks, stride) in enumerate(STAGES):
            for b in range(blocks):
                name = f"s{stage}b{b}"
                setattr(self, name, _Bottleneck(cin, feats, stride if b == 0 else 1))
                self.blocks.append(name)
                cin = feats * 4
        self.proj = Dense(cin, out_dim) if out_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        h = _max_pool_same(F.relu(self.stem(h)))
        for name in self.blocks:
            h = getattr(self, name)(h)
        feat = h.amax(dim=(2, 3)).float()  # global max pool
        return self.proj(feat) if self.proj is not None else feat


def triplet_loss(anchor, positive, negative, margin: float = 0.2) -> torch.Tensor:
    """Writer-style triplet objective: mean of max(|a - p|² - |a - n|² +
    margin, 0)."""
    d_pos = torch.sum(torch.square(anchor - positive), dim=-1)
    d_neg = torch.sum(torch.square(anchor - negative), dim=-1)
    return torch.mean(torch.clamp_min(d_pos - d_neg + margin, 0.0))


@torch.no_grad()
def build_style_dict(encoder: StyleEncoder, images_by_writer: dict,
                     batch_size: int = 32) -> dict[str, np.ndarray]:
    """writer -> mean style vector over that writer's crops (NHWC float
    arrays in [-1, 1]), encoded ``batch_size`` at a time on the encoder's
    device."""
    device = next(encoder.parameters()).device
    out = {}
    for writer, imgs in images_by_writer.items():
        vecs = [encoder(torch.as_tensor(np.asarray(imgs[s : s + batch_size]),
                                        device=device)).cpu().numpy()
                for s in range(0, len(imgs), batch_size)]
        out[writer] = np.concatenate(vecs).mean(axis=0)
    return out
