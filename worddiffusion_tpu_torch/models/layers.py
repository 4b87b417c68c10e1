"""Shared model layers (port of ``worddiffusion_tpu/models/layers.py``).

Parameters are fp32; every layer computes in its input's dtype, which
the models set from their config (``UNetConfig.dtype``). Images are
NCHW inside the models; the public model functions take and return the
JAX package's NHWC, which lands in torch's ``channels_last`` memory
layout without a copy.
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import gn_conv, groupnorm


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in [cos | sin] order. Always fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def char_positional_encoding(max_seq_len: int, dim: int) -> torch.Tensor:
    """The CharacterEncoder's positional table: sin with exponent i/d on
    even slots, cos with exponent (i+1)/d on odd slots."""
    pos = torch.arange(max_seq_len, dtype=torch.float32)[:, None]
    i = torch.arange(0, dim, 2, dtype=torch.float32)[None, :]
    pe_even = torch.sin(pos / torch.pow(10000.0, i / dim))
    pe_odd = torch.cos(pos / torch.pow(10000.0, (i + 1.0) / dim))
    pe = torch.stack([pe_even, pe_odd], dim=-1).reshape(max_seq_len, -1)
    return pe[:, :dim]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> the kernels' NHWC; a view (no copy) for channels_last memory."""
    return x.permute(0, 2, 3, 1).contiguous()


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with fp32 statistics (``E[x²] - mu²``, the JAX
    ``GroupNorm32`` formula) and affine, cast back to the input dtype,
    through ``ops.groupnorm`` (kernel B.5 on the card). ``silu`` applies
    SiLU in fp32 before the cast. Defaults are the UNet's: ``min(32, c)``
    groups, eps 1e-5; the VAE and the OCR pass their own groups and eps.
    Takes NCHW (channels_last memory on the card)."""

    def __init__(self, channels: int, groups: int | None = None, eps: float = 1e-5):
        super().__init__(groups or min(32, channels), channels, eps=eps)

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        out = groupnorm.fused_groupnorm(_nhwc(x), self.weight, self.bias, self.num_groups,
                                        self.eps, silu)
        return out.permute(0, 3, 1, 2)


def gn_silu_conv(norm: GroupNorm32, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(silu(norm(x)))`` on NCHW x: one ``ops.gn_conv`` call (kernel
    B.6 on the card) where the conv is 3x3, stride 1, padding 1 and keeps
    the width; otherwise ``norm`` with SiLU (B.5), then the conv."""
    if (conv.in_channels != conv.out_channels or conv.kernel_size != (3, 3)
            or conv.stride != (1, 1) or conv.padding != (1, 1)):
        return conv(norm(x, silu=True))
    out = gn_conv.fused_gn_silu_conv3x3(_nhwc(x), norm.weight, norm.bias, conv.weight,
                                        conv.bias, norm.num_groups, norm.eps)
    return out.permute(0, 3, 1, 2)


class Conv2D(nn.Conv2d):
    """Conv with fp32 params that computes in its input's dtype.
    ``zero_init`` marks the residual-branch output convs that start at
    zero (``init_weights_``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int | None = None, zero_init: bool = False):
        super().__init__(in_ch, out_ch, kernel, stride,
                         kernel // 2 if padding is None else padding)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Dense(nn.Linear):
    """Linear with fp32 params that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class GEGLU(nn.Module):
    """Gated GELU projection; the gelu is tanh-approximate, as flax's."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """Transformer FF with GEGLU gating, mult 4 (reference keys
    ``net.0.proj``, ``net.2``). ``BasicTransformerBlock`` runs the whole
    FF sub-layer through ``ops.ffn`` over these parameters. ``net.1`` is
    the reference's Dropout slot, a no-op: JAX applies it with
    ``deterministic=True`` in training and in sampling. Under a model axis
    of ``model`` ranks it holds a rank's 1/model of the inner width
    (``parallel.mesh.param_spec``) but the whole, replicated, in-projection
    bias, as JAX's layout has it (``ops.ffn.ffn_sublayer_tp`` cuts it)."""

    def __init__(self, dim: int, mult: int = 4, model: int = 1):
        super().__init__()
        inner = dim * mult // model
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Identity(), Dense(inner, dim))
        if model > 1:
            self.net[0].proj.bias = nn.Parameter(torch.zeros(2 * inner * model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """3x3 stride-2 conv with symmetric padding 1 (torch's, not SAME)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2D(channels, channels, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
# The draws of the last few initialisations (the SD-shape VAE's: 0.34 GB on
# the host), by seed and the shapes drawn: a process that builds the same
# model again copies them instead of drawing them anew, bit for bit.
_DRAWS: OrderedDict = OrderedDict()
_DRAWS_KEPT = 6


def _is_kernel(m: nn.Module) -> bool:
    return isinstance(m, (nn.Linear, nn.modules.conv._ConvNd))


def _draws(seed: int, sites: tuple) -> list:
    """``init_weights_``'s random draws for ``sites``, ("kernel" | "embedding",
    shape) in its order, from one generator seeded with ``seed``."""
    key = (seed, torch.get_default_dtype(), sites)
    if key in _DRAWS:
        _DRAWS.move_to_end(key)
        return _DRAWS[key]
    g = torch.Generator().manual_seed(seed)
    out = []
    for kind, shape in sites:
        if kind == "kernel":
            std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD  # fan-in
            w = torch.empty(shape)  # drawn on the host, whatever the device
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        else:
            w = torch.randn(shape, generator=g) * shape[1] ** -0.5  # std 1/sqrt(features)
        out.append(w)
    _DRAWS[key] = out
    while len(_DRAWS) > _DRAWS_KEPT:
        _DRAWS.popitem(last=False)
    return out


@contextlib.contextmanager
def skip_default_init():
    """Linear and conv layers built inside skip torch's default
    initialisation (a host draw the size of each layer, from torch's global
    generator). Only for a model whose every parameter is written at once
    after, by ``init_weights_`` or a strict ``load_state_dict``: until then
    those layers hold uninitialised memory."""
    saved = nn.Linear.reset_parameters, nn.modules.conv._ConvNd.reset_parameters
    nn.Linear.reset_parameters = nn.modules.conv._ConvNd.reset_parameters = lambda self: None
    try:
        yield
    finally:
        nn.Linear.reset_parameters, nn.modules.conv._ConvNd.reset_parameters = saved


@torch.no_grad()
def init_weights_(module: nn.Module, seed: int = 0, zero_init: bool = True) -> nn.Module:
    """Seeded initialisation with flax's defaults: lecun-normal kernels
    (zeros where a layer is marked ``zero_init``, unless ``zero_init`` is
    False here), zero biases, unit norms, and embeddings with std
    1/sqrt(features)."""
    mods = list(module.modules())
    drawn = lambda m: ((_is_kernel(m) and not (zero_init and getattr(m, "zero_init", False)))
                       or isinstance(m, nn.Embedding))
    sites = tuple(("kernel" if _is_kernel(m) else "embedding", tuple(m.weight.shape))
                  for m in mods if drawn(m))
    draws = iter(_draws(seed, sites))
    for m in mods:
        if drawn(m):
            m.weight.copy_(next(draws))
        elif _is_kernel(m):
            m.weight.zero_()
        if _is_kernel(m) and m.bias is not None:
            m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
