"""InceptionV3 feature extractor and torchvision-checkpoint converter (port
of ``worddiffusion_tpu/eval/inception.py``).

Classic FID uses the pool3 (2048-d) features of an ImageNet InceptionV3.
Its weights are not in the repo and are never fetched: point
``cli.evaluate --inception_weights`` at a torchvision-layout
``inception_v3`` state dict (``.pt``/``.pth``, or ``.npz``). The network
follows torchvision's ``models/inception.py`` (BasicConv2d = conv +
BatchNorm(eps=1e-3) + ReLU; Mixed_5b..7c) with the BatchNorm folded into
each conv at conversion, as the JAX module does. No TPU kernel runs here:
conv + bias + ReLU run on cuDNN. The convs run in true fp32: TF32 is off
inside the forward (cuDNN would otherwise take it for fp32 convolutions by
default).

Module names follow the flax tree (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.conv``, ...); the JAX module's NHWC input is
permuted to NCHW (channels_last memory).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class _BasicConv(nn.Module):
    """Folded conv + BN + ReLU: a biased conv, then ReLU."""

    def __init__(self, cin: int, features: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, padding, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avgpool3(x):
    # torch avg_pool2d(3, stride=1, padding=1, count_include_pad=True), as the
    # JAX module's flax avg_pool over explicit padding
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class _InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = _BasicConv(cin, 64, 1)
        self.branch5x5_1 = _BasicConv(cin, 48, 1)
        self.branch5x5_2 = _BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = _BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, padding=1)
        self.branch_pool = _BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], 1)


class _InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = _BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = _BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class _InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = _BasicConv(cin, 192, 1)
        self.branch7x7_1 = _BasicConv(cin, c7, 1)
        self.branch7x7_2 = _BasicConv(c7, c7, (1, 7), padding=p17)
        self.branch7x7_3 = _BasicConv(c7, 192, (7, 1), padding=p71)
        self.branch7x7dbl_1 = _BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = _BasicConv(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_3 = _BasicConv(c7, c7, (1, 7), padding=p17)
        self.branch7x7dbl_4 = _BasicConv(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_5 = _BasicConv(c7, 192, (1, 7), padding=p17)
        self.branch_pool = _BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], 1)


class _InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = _BasicConv(cin, 192, 1)
        self.branch3x3_2 = _BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = _BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = _BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = _BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = _BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class _InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        p13, p31 = (0, 1), (1, 0)
        self.branch1x1 = _BasicConv(cin, 320, 1)
        self.branch3x3_1 = _BasicConv(cin, 384, 1)
        self.branch3x3_2a = _BasicConv(384, 384, (1, 3), padding=p13)
        self.branch3x3_2b = _BasicConv(384, 384, (3, 1), padding=p31)
        self.branch3x3dbl_1 = _BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = _BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = _BasicConv(384, 384, (1, 3), padding=p13)
        self.branch3x3dbl_3b = _BasicConv(384, 384, (3, 1), padding=p31)
        self.branch_pool = _BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], 1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, C, 299, 299] as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, a triangle filter widened on a downscale
    (antialiased), taps outside the image dropped. That is
    ``F.interpolate(..., "bilinear")`` with ``antialias`` where an axis
    shrinks (within 3e-5 of JAX's; without it where both grow, within
    2e-7)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=max(x.shape[2:]) > 299)


class InceptionV3Features(nn.Module):
    """x NHWC [B, H, W, 3] in [-1, 1] -> pool3 features [B, 2048] fp32.

    The input is resized to 299x299 (``resize_299``) as the JAX module's
    ``jax.image.resize`` does."""

    def __init__(self, resize: bool = True):
        super().__init__()
        self.resize = resize
        self.Conv2d_1a_3x3 = _BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = _BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = _BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = _BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = _BasicConv(80, 192, 3)
        self.Mixed_5b = _InceptionA(192, 32)
        self.Mixed_5c = _InceptionA(256, 64)
        self.Mixed_5d = _InceptionA(288, 64)
        self.Mixed_6a = _InceptionB(288)
        self.Mixed_6b = _InceptionC(768, 128)
        self.Mixed_6c = _InceptionC(768, 160)
        self.Mixed_6d = _InceptionC(768, 160)
        self.Mixed_6e = _InceptionC(768, 192)
        self.Mixed_7a = _InceptionD(768)
        self.Mixed_7b = _InceptionE(1280)
        self.Mixed_7c = _InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        if self.resize and tuple(x.shape[2:]) != (299, 299):
            x = resize_299(x)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, 2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                         "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # global average pool


def _fold_bn(w, gamma, beta, mean, var, eps=1e-3):
    """conv weight OIHW + BN -> (OIHW kernel, bias), both fp32 (the JAX
    ``_fold_bn`` returns the kernel HWIO, flax's layout)."""
    scale = gamma / np.sqrt(var + eps)
    k = w * scale[:, None, None, None]
    b = beta - mean * scale
    return k.astype(np.float32), b.astype(np.float32)


def convert_torch_inception(sd: dict) -> dict[str, np.ndarray]:
    """torchvision ``inception_v3`` state dict (numpy values; keys like
    ``Mixed_5b.branch1x1.conv.weight`` / ``...bn.{weight,bias,running_mean,
    running_var}``) -> the ``InceptionV3Features`` state dict, BN folded
    (eps 1e-3, torchvision's BasicConv2d). fc / AuxLogits entries are
    ignored."""
    out: dict[str, np.ndarray] = {}
    prefixes = sorted({k[: -len(".conv.weight")] for k in sd
                       if k.endswith(".conv.weight") and not k.startswith("AuxLogits")})
    for p in prefixes:
        k, b = _fold_bn(*(np.asarray(sd[f"{p}.{leaf}"]) for leaf in (
            "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")))
        out[f"{p}.conv.weight"], out[f"{p}.conv.bias"] = np.ascontiguousarray(k), b
    return out


def seeded_torchvision_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """A torchvision-layout ``inception_v3`` trunk state dict with seeded
    random values (He-scaled conv weights, so the features do not fade
    through the 94 ReLU layers; BN statistics away from the identity), for
    runs without the real weights."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}
    for name, m in InceptionV3Features().named_modules():
        if isinstance(m, nn.Conv2d):
            p = name[: -len(".conv")]
            w = torch.randn(m.weight.shape, generator=g) * (2.0 / m.weight[0].numel()) ** 0.5
            c = w.shape[0]
            sd[f"{p}.conv.weight"] = w
            sd[f"{p}.bn.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
            sd[f"{p}.bn.bias"] = 0.1 * torch.randn(c, generator=g)
            sd[f"{p}.bn.running_mean"] = 0.2 * torch.randn(c, generator=g)
            sd[f"{p}.bn.running_var"] = 0.75 + 0.5 * torch.rand(c, generator=g)
            sd[f"{p}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_inception_featurizer(weights_path: str, device: torch.device | str = "cuda"):
    """-> featurizer(images [B, H, W, 3] in [-1, 1], numpy or tensor) ->
    numpy [B, 2048]. ``weights_path``: a torch ``.pt``/``.pth`` state dict
    or an ``.npz``."""
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as z:
            sd = {k: z[k] for k in z.files}
    else:
        obj = torch.load(weights_path, map_location="cpu", weights_only=True)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        sd = {k: v.numpy() for k, v in obj.items()}
    net = InceptionV3Features()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in convert_torch_inception(sd).items()})
    net = net.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)

    def featurize(images) -> np.ndarray:
        with torch.no_grad():
            x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
            return net(x.to(device)).cpu().numpy()

    return featurize
