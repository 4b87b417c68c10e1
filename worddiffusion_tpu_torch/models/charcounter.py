"""Word-length (character-counter) classifier (port of
``worddiffusion_tpu/models/charcounter.py``): the PHOSCNet VGG trunk +
temporal pyramid pooling + a softmax head over word lengths 1..17. It
runs no Pallas kernel in JAX and no hand-written kernel here: cuDNN convs
and a cuBLAS Dense on the card."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense
from .phoscnet import _VGGTrunk, temporal_pyramid_pool


class CharacterCounterNet(nn.Module):
    def __init__(self, outputs: int = 17, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.trunk = _VGGTrunk()
        self.head = Dense(_VGGTrunk.out_channels * 8, outputs)  # TPP levels 1 + 2 + 5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [B, 50, 250, 3] -> [B, outputs] class probabilities (fp32)."""
        feats = temporal_pyramid_pool(self.trunk(x.to(self.dtype).permute(0, 3, 1, 2)))
        return F.softmax(self.head(feats).float(), dim=-1)


def length_onehot(words, outputs: int = 17) -> torch.Tensor:
    """word -> one-hot float32 of (len - 1), lengths clamped to [1, outputs]."""
    idx = np.asarray([min(max(len(w), 1), outputs) - 1 for w in words], np.int64)
    return F.one_hot(torch.from_numpy(idx), outputs).float()


def counter_loss(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """CE over the softmax output (the reference applies CE to softmaxed
    probabilities)."""
    return torch.mean(-torch.sum(onehot * torch.log(probs + 1e-9), dim=-1))
