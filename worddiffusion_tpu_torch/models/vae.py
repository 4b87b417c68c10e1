"""Stable-Diffusion AutoencoderKL, decode half (port of the decoder in
``worddiffusion_tpu/models/vae.py``). The encoder is not ported yet.

Parameter names are diffusers' (``decoder.up_blocks.0.resnets.0...``,
``post_quant_conv``), so ``models.convert.jax_vae_to_torch`` and
diffusers-format state dicts load with ``load_state_dict``. NHWC at
the interface; 8x32x4 latents decode to 64x256x3 images.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.config import VAEConfig
from .layers import Conv2D, Dense, GroupNorm32, Upsample


def _gn(c: int) -> GroupNorm32:
    """SD convention: eps 1e-6; 32 groups, or one per channel for narrow
    widths that 32 does not divide."""
    return GroupNorm32(c, groups=32 if c % 32 == 0 else c, eps=1e-6)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _gn(in_ch)
        self.conv1 = Conv2D(in_ch, out_ch)
        self.norm2 = _gn(out_ch)
        self.conv2 = Conv2D(out_ch, out_ch)
        self.conv_shortcut = Conv2D(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x).to(self.dtype)))
        h = self.conv2(F.silu(self.norm2(h).to(self.dtype)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens, scaled c^-0.5."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.group_norm = _gn(channels)
        self.to_q = Dense(channels, channels)
        self.to_k = Dense(channels, channels)
        self.to_v = Dense(channels, channels)
        self.to_out = nn.ModuleList([Dense(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).to(self.dtype).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * c ** -0.5
        attn = sim.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float()).to(self.dtype)
        out = self.to_out[0](out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, dtype), VAEResnetBlock(ch, ch, dtype)])
        self.attentions = nn.ModuleList([VAEAttention(ch, dtype)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_res: int, upsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_ch if j == 0 else out_ch, out_ch, dtype) for j in range(n_res)
        ])
        self.upsamplers = nn.ModuleList([Upsample(out_ch)] if upsample else [])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in (*self.resnets, *self.upsamplers):
            h = layer(h)
        return h


class Decoder(nn.Module):
    """latent [B, C, h, w] -> image [B, 3, 8h, 8w] fp32 (NCHW)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.dtype = getattr(torch, cfg.dtype)
        mult = cfg.channel_mult
        ch = cfg.base_channels * mult[-1]
        self.conv_in = Conv2D(cfg.latent_channels, ch)
        self.mid_block = _MidBlock(ch, self.dtype)
        self.up_blocks = nn.ModuleList()
        for i in reversed(range(len(mult))):
            out_ch = cfg.base_channels * mult[i]
            self.up_blocks.append(
                _UpBlock(ch, out_ch, cfg.num_res_blocks + 1, i != 0, self.dtype)
            )
            ch = out_ch
        self.conv_norm_out = _gn(ch)
        self.conv_out = Conv2D(ch, cfg.in_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z.to(self.dtype)))
        for block in self.up_blocks:
            h = block(h)
        h = F.silu(self.conv_norm_out(h).to(self.dtype))
        return self.conv_out(h).float()


class AutoencoderKL(nn.Module):
    """The decode half of the SD AutoencoderKL: ``decode(z)`` NHWC."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv2D(cfg.latent_channels, cfg.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, C] -> image [B, 8h, 8w, 3] fp32, about [-1, 1]."""
        zc = z.permute(0, 3, 1, 2).to(self.decoder.dtype)
        return self.decoder(self.post_quant_conv(zc)).permute(0, 2, 3, 1)


def decode_from_latent(vae: AutoencoderKL, z: torch.Tensor,
                       scaling: float = 0.18215) -> torch.Tensor:
    return vae.decode(z / scaling)
