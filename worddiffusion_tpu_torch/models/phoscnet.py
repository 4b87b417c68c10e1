"""PHOSC zero-shot word recognizer, the evaluation head (port of
``worddiffusion_tpu/models/phoscnet.py``).

A conv trunk (VGG, or one of the residual trunks), temporal pyramid
pooling over levels [1, 2, 5] and two MLP heads: phos (ReLU) and phoc
(sigmoid). The public model takes the JAX package's NHWC word crops
[B, 50, 250, 3]; inside, the trunk runs NCHW in ``channels_last`` memory
(the NHWC input permuted, a view), so each GroupNorm hands ``ops.groupnorm``
its NHWC view without a copy: the residual trunks' GroupNorms (32 groups,
eps 1e-6, no SiLU) run kernel B.5 on the card.

Module and parameter names follow the flax tree (``trunk.stem``,
``trunk.s0b0_c1``, ``phos_fc0``, ...); ``models.convert.jax_phoscnet_to_torch``
maps a flax tree onto them and ``torch_phoscnet_to_jax`` back.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2D, Dense, GroupNorm32


def _pool_windows(x: torch.Tensor, kh: int, kw: int, pads: tuple) -> torch.Tensor:
    """Max over (kh x kw) windows of x padded with -inf by ``pads``
    (F.pad order); a window that is all padding gives 0."""
    xp = F.pad(x, pads, value=-math.inf) if any(pads) else x
    pooled = F.max_pool2d(xp, (kh, kw), (kh, kw))
    return pooled.masked_fill(torch.isneginf(pooled), 0.0)


def temporal_pyramid_pool(x: torch.Tensor, levels=(1, 2, 5)) -> torch.Tensor:
    """NCHW -> [B, C * sum(levels)]: for each level, the width padded
    (-inf, split as JAX splits it) so ``level`` equal stripes cover it, each
    stripe max-pooled over the full height. Each level flattens stripe-major,
    channel-minor, as JAX's [B, 1, level, C] reshape does."""
    b, c, h, w = x.shape
    out = []
    for level in levels:
        kw = math.ceil(w / level)
        pad = kw * level - w
        pooled = _pool_windows(x, h, kw, (pad // 2, pad - pad // 2))  # [B, C, 1, level]
        out.append(pooled.permute(0, 2, 3, 1).reshape(b, level * c))
    return torch.cat(out, dim=1)


def spatial_pyramid_pool(x: torch.Tensor, levels=(1, 2, 4)) -> torch.Tensor:
    """NCHW -> [B, C * sum(level^2)]: max-pooled level x level grids,
    each flattened [level, level, C] as JAX's NHWC reshape does."""
    b, c, h, w = x.shape
    out = []
    for level in levels:
        kh, kw = math.ceil(h / level), math.ceil(w / level)
        ph, pw = kh * level - h, kw * level - w
        pooled = _pool_windows(x, kh, kw, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        out.append(pooled.permute(0, 2, 3, 1).reshape(b, level * level * c))
    return torch.cat(out, dim=1)


class FixedPatchPrompter(nn.Module):
    """Additive learned visual prompt over the whole input: a [1, H, W, 3]
    parameter ``patch`` (standard normal from ``generator``) added to every
    NHWC image."""

    def __init__(self, height: int = 50, width: int = 250,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch = nn.Parameter(torch.randn(1, height, width, 3, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.patch.to(x.dtype)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax's SAME padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv(Conv2D):
    """Square conv with flax's padding: ``"SAME"`` pads each axis
    ``total // 2`` before and the rest after, where total = max((ceil(n/s) -
    1) * s + k - n, 0), which under stride is not always symmetric (the
    7x7 stride-2 stem on 50x250 pads 2 and 3); ``"VALID"`` pads nothing; a
    number pads that much on every side. Symmetric padding goes to the conv
    itself; asymmetric padding is one ``F.pad``, then the conv pads nothing."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: str | int = "SAME"):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0)
        self.same = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        k, s = self.kernel_size[0], self.stride[0]
        if self.same == "VALID":
            return F.conv2d(x, w, b, s)
        if self.same != "SAME":
            return F.conv2d(x, w, b, s, self.same)
        (top, bottom), (left, right) = (_same_pads(n, k, s) for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, w, b, s, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, s)


def _norm(feats: int) -> GroupNorm32:
    """flax ``nn.GroupNorm(num_groups=min(32, feats))``: eps 1e-6, fp32
    statistics and affine, output in the input's dtype (B.5 on the card)."""
    return GroupNorm32(feats, groups=min(32, feats), eps=1e-6)


class _VGGTrunk(nn.Module):
    """13 3x3 convs with ReLU, a 2x2 max-pool after the second and the
    fourth (``conv0`` .. ``conv12``)."""

    PLAN = ((64, False), (64, True), (128, False), (128, True), (256, False), (256, False),
            (256, False), (256, False), (256, False), (256, False), (512, False), (512, False),
            (512, False))
    out_channels = 512

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (feats, _) in enumerate(self.PLAN):
            setattr(self, f"conv{i}", SameConv(cin, feats, 3))
            cin = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, pool_after) in enumerate(self.PLAN):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if pool_after:
                x = F.max_pool2d(x, 2, 2)
        return x


class _ResNet18Trunk(nn.Module):
    """A 7x7 stride-2 stem, then four stages of two blocks (64, 128 at
    stride 2, 256, 512): each block conv -> GN -> ReLU -> conv -> GN, plus
    the input (through a 1x1 conv where the shape changes), then ReLU. Its
    16 GroupNorms run B.5 on the card."""

    STAGES = ((64, 1), (128, 2), (256, 1), (512, 1))
    out_channels = 512

    def __init__(self):
        super().__init__()
        self.stem = SameConv(3, 64, 7, 2)
        self.blocks = []
        cin = 64
        for stage, (feats, stride) in enumerate(self.STAGES):
            for b, s in ((0, stride), (1, 1)):
                name = f"s{stage}b{b}"
                setattr(self, name + "_c1", SameConv(cin, feats, 3, s))
                setattr(self, name + "_n1", _norm(feats))
                setattr(self, name + "_c2", SameConv(feats, feats, 3))
                setattr(self, name + "_n2", _norm(feats))
                # the flax block adds a shortcut conv where the shape changes
                shortcut = cin != feats or s != 1
                if shortcut:
                    setattr(self, name + "_sc", SameConv(cin, feats, 1, s))
                self.blocks.append((name, shortcut))
                cin = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem(x))
        for name, shortcut in self.blocks:
            res = getattr(self, name + "_sc")(x) if shortcut else x
            h = F.relu(getattr(self, name + "_n1")(getattr(self, name + "_c1")(x)))
            h = getattr(self, name + "_n2")(getattr(self, name + "_c2")(h))
            x = F.relu(h + res)
        return x


class _TorchResNetTrunk(nn.Module):
    """The torchvision resnet18/34 layout with the reference's changes: a 7x7
    stride-2 stem without padding and with a bias, a 3x3 stride-2 max-pool
    without padding, biased BasicBlock convs. ``norm="group"`` puts a
    GroupNorm (B.5 on the card) where torchvision has BatchNorm: 20 for
    ``blocks=(2, 2, 2, 2)``, 36 for ``(3, 4, 6, 3)``; ``norm="none"`` has none
    (checkpoints whose BatchNorm ``convert_torchvision_resnet`` folded into
    the convs)."""

    out_channels = 512

    def __init__(self, blocks: tuple = (2, 2, 2, 2), norm: str = "group"):
        super().__init__()
        self.norm = norm
        self.conv1 = SameConv(3, 64, 7, 2, padding="VALID")
        self._gn("bn1", 64)
        self.blocks = []
        cin = 64
        for stage, n in enumerate(blocks):
            feats = 64 * 2 ** stage
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"l{stage}b{b}"
                setattr(self, name + "_c1", SameConv(cin, feats, 3, stride, padding=1))
                self._gn(name + "_n1", feats)
                setattr(self, name + "_c2", SameConv(feats, feats, 3, padding=1))
                self._gn(name + "_n2", feats)
                down = cin != feats or stride != 1
                if down:
                    setattr(self, name + "_ds", SameConv(cin, feats, 1, stride))
                    self._gn(name + "_dsn", feats)
                self.blocks.append((name, down))
                cin = feats

    def _gn(self, name: str, feats: int) -> None:
        if self.norm == "group":
            setattr(self, name, _norm(feats))

    def _n(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(h) if self.norm == "group" else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 1:  # grayscale -> 3 channels (the reference's expand)
            x = x.expand(-1, 3, -1, -1).contiguous(memory_format=torch.channels_last)
        h = F.relu(self._n("bn1", self.conv1(x)))
        h = F.max_pool2d(h, 3, 2)
        for name, down in self.blocks:
            res = h
            h = F.relu(self._n(name + "_n1", getattr(self, name + "_c1")(h)))
            h = self._n(name + "_n2", getattr(self, name + "_c2")(h))
            if down:
                res = self._n(name + "_dsn", getattr(self, name + "_ds")(res))
            h = F.relu(h + res)
        return h


TRUNKS = {
    "vgg": lambda norm: _VGGTrunk(),
    "resnet18": lambda norm: _ResNet18Trunk(),
    "resnet18_pretrain": lambda norm: _TorchResNetTrunk((2, 2, 2, 2), norm),
    # the reference's ResNet18PretrainAttention is the plain pretrain variant
    "resnet18_attention": lambda norm: _TorchResNetTrunk((2, 2, 2, 2), norm),
    "resnet34": lambda norm: _TorchResNetTrunk((3, 4, 6, 3), norm),
}


class PHOSCNet(nn.Module):
    """Trunk -> temporal pyramid pooling -> phos and phoc heads. Each head is
    ``head_layers`` x (Dense -> ReLU -> Dropout), then a Dense, then in fp32
    ReLU (phos) or sigmoid (phoc). Parameters are fp32; the model computes in
    ``dtype`` (bf16 by default, which the card's GroupNorm kernel takes)."""

    def __init__(self, phos_size: int = 165, phoc_size: int = 604, hidden: int = 4096,
                 levels: tuple = (1, 2, 5), trunk: str = "vgg", head_layers: int = 2,
                 trunk_norm: str = "group", dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.levels, self.dropout, self.dtype = tuple(levels), dropout, dtype
        self.head_layers = head_layers
        self.trunk = TRUNKS[trunk](trunk_norm)
        feats = self.trunk.out_channels * sum(self.levels)
        for name, out_dim in (("phos", phos_size), ("phoc", phoc_size)):
            d = feats
            for i in range(head_layers):
                setattr(self, f"{name}_fc{i}", Dense(d, hidden))
                d = hidden
            setattr(self, f"{name}_out", Dense(d, out_dim))

    def _dropout(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
        by 1/keep; the mask is drawn from ``generator`` (needed)."""
        if generator is None:
            raise ValueError("PHOSCNet: training-mode dropout needs a torch.Generator")
        keep = 1.0 - self.dropout
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                return_features: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """x: NHWC [B, H, W, 3] (values in [-1, 1]). ``deterministic=False``
        applies dropout with masks from ``generator``. ``return_features``
        adds the fp32 pooled trunk features (the FID featurizer's vector)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        feats = temporal_pyramid_pool(self.trunk(x), self.levels)
        drop = not deterministic and self.dropout > 0

        def head(name):
            h = feats
            for i in range(self.head_layers):
                h = F.relu(getattr(self, f"{name}_fc{i}")(h))
                if drop:
                    h = self._dropout(h, generator)
            return getattr(self, f"{name}_out")(h).float()

        out = {"phos": F.relu(head("phos")), "phoc": torch.sigmoid(head("phoc"))}
        if return_features:
            out["features"] = feats.float()
        return out


def resnet18_pretrain_phoscnet(**kw) -> PHOSCNet:
    """The paper's reported recognizer: the torchvision-resnet18 trunk +
    TPP[1, 2, 5] + one-hidden-layer heads, phos 180 / phoc 646."""
    base = dict(phos_size=180, phoc_size=646, trunk="resnet18_pretrain", head_layers=1)
    base.update(kw)
    return PHOSCNet(**base)


def convert_torchvision_resnet(sd, blocks=(2, 2, 2, 2)) -> dict[str, np.ndarray]:
    """A torchvision resnet18/34 state dict -> the ``_TorchResNetTrunk``
    state dict (``norm="none"``) with eval-mode BatchNorm folded into the
    convs: ``model.trunk.load_state_dict`` takes it. numpy in and out."""

    def arr(k):
        return np.asarray(sd[k], np.float32)

    out: dict[str, np.ndarray] = {}

    def fold(name, conv_prefix, bn_prefix, eps=1e-5):
        w = arr(conv_prefix + ".weight")  # OIHW
        b = (arr(conv_prefix + ".bias") if conv_prefix + ".bias" in sd
             else np.zeros(w.shape[0], np.float32))
        g, beta = arr(bn_prefix + ".weight"), arr(bn_prefix + ".bias")
        mean, var = arr(bn_prefix + ".running_mean"), arr(bn_prefix + ".running_var")
        s = g / np.sqrt(var + eps)
        out[name + ".weight"] = np.ascontiguousarray(w * s[:, None, None, None])
        out[name + ".bias"] = (b - mean) * s + beta

    fold("conv1", "conv1", "bn1")
    for stage, n in enumerate(blocks):
        for b in range(n):
            t, name = f"layer{stage + 1}.{b}", f"l{stage}b{b}"
            fold(name + "_c1", t + ".conv1", t + ".bn1")
            fold(name + "_c2", t + ".conv2", t + ".bn2")
            if t + ".downsample.0.weight" in sd:
                fold(name + "_ds", t + ".downsample.0", t + ".downsample.1")
    return out


def phosc_loss(pred: dict, target_phos: torch.Tensor, target_phoc: torch.Tensor,
               phos_w: float = 4.5, phoc_w: float = 1.0) -> torch.Tensor:
    """4.5 * MSE(phos) + CE(phoc), where the reference feeds the *sigmoid
    outputs* to a cross-entropy with a float multi-hot target:
    ``-sum(target * log_softmax(phoc))`` averaged over the batch (what the
    published recognizers were trained with)."""
    phos_loss = phos_w * torch.mean(torch.square(pred["phos"] - target_phos))
    logp = F.log_softmax(pred["phoc"], dim=-1)
    return phos_loss + phoc_w * torch.mean(-torch.sum(target_phoc * logp, dim=-1))
