"""Stable-Diffusion AutoencoderKL (port of ``worddiffusion_tpu/models/vae.py``):
the decoder, and the encoder with ``encode`` and ``encode_to_latent``.

Parameter names are diffusers' (``decoder.up_blocks.0.resnets.0...``,
``encoder.down_blocks.0.downsamplers.0.conv``, ``quant_conv``,
``post_quant_conv``), so ``models.convert.jax_vae_to_torch`` output loads
with ``load_state_dict(strict=True)``, and ``load_diffusers_vae`` takes a
diffusers checkpoint. ``AutoencoderKL(cfg)`` is the decode half, which
regeneration and the training previews use (decoder-only state dicts load
into it strictly, and its seeded weights do not depend on the encoder);
``AutoencoderKL(cfg, with_encoder=True)`` adds the encoder and
``quant_conv``. NHWC at the interface; 64x256x3 images encode to 8x32x4
latents and back.

Every GroupNorm -> SiLU -> 3x3 conv that keeps the width runs as one
``ops.gn_conv`` call (kernel B.6 on the card), every other GroupNorm
through ``ops.groupnorm`` (B.5).
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.config import VAEConfig
from .layers import (Conv2D, Dense, GroupNorm32, Upsample, gn_silu_conv, init_weights_,
                     skip_default_init)


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
        h = gn_silu_conv(self.norm1, self.conv1, x)
        h = gn_silu_conv(self.norm2, self.conv2, h)
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


class _Downsample(nn.Module):
    """SD's asymmetric downsample: pad (0, 1) at the bottom and right, then
    a VALID 3x3 stride-2 conv (JAX ``vae.py:105-109``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, stride=2, padding=0)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        # padded as NHWC, so the result stays in channels_last memory
        padded = F.pad(h.permute(0, 2, 3, 1), (0, 0, 0, 1, 0, 1))
        return self.conv(padded.permute(0, 3, 1, 2))


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_res: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_ch if j == 0 else out_ch, out_ch, dtype) for j in range(n_res)
        ])
        self.downsamplers = nn.ModuleList([_Downsample(out_ch)] if downsample else [])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in (*self.resnets, *self.downsamplers):
            h = layer(h)
        return h


class Encoder(nn.Module):
    """image [B, 3, H, W] -> moments [B, 2 * latent_channels, H/8, W/8] in
    the config's dtype (NCHW)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.dtype = getattr(torch, cfg.dtype)
        mult = cfg.channel_mult
        ch = cfg.base_channels
        self.conv_in = Conv2D(cfg.in_channels, ch)
        self.down_blocks = nn.ModuleList()
        for i, m in enumerate(mult):
            out_ch = cfg.base_channels * m
            self.down_blocks.append(
                _DownBlock(ch, out_ch, cfg.num_res_blocks, i != len(mult) - 1, self.dtype))
            ch = out_ch
        self.mid_block = _MidBlock(ch, self.dtype)
        self.conv_norm_out = _gn(ch)
        self.conv_out = Conv2D(ch, 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return gn_silu_conv(self.conv_norm_out, self.conv_out, h)


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
        return gn_silu_conv(self.conv_norm_out, self.conv_out, h).float()


class AutoencoderKL(nn.Module):
    """``decode(z)`` NHWC; with ``with_encoder`` also ``encode(x)``. The
    decoder is registered first, so ``init_weights_`` draws the same
    decoder weights with or without the encoder."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), with_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv2D(cfg.latent_channels, cfg.latent_channels, 1)
        self.with_encoder = with_encoder
        if with_encoder:
            self.encoder = Encoder(cfg)
            self.quant_conv = Conv2D(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """image [B, H, W, 3] in [-1, 1] -> (mean, logvar) [B, H/8, W/8, C]
        fp32, logvar clipped to [-30, 20]."""
        if not self.with_encoder:
            raise ValueError("this AutoencoderKL is the decode half; build it with "
                             "with_encoder=True to encode")
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).float()
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, h, w, C] -> image [B, 8h, 8w, 3] fp32, about [-1, 1]."""
        zc = z.permute(0, 3, 1, 2).to(self.decoder.dtype)
        return self.decoder(self.post_quant_conv(zc)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The training forward (JAX ``AutoencoderKL.__call__``): encode,
        sample the posterior with the unit normal ``noise`` (parity tests
        hand in JAX's draw) or one drawn from ``generator``, decode. ->
        (reconstruction [B, H, W, 3] fp32, mean, logvar)."""
        mean, logvar = self.encode(x)
        if noise is None:
            if generator is None:
                raise ValueError("AutoencoderKL: sampling the posterior needs the noise or a "
                                 "torch.Generator")
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = mean + torch.exp(0.5 * logvar) * noise
        return self.decode(z), mean, logvar


def encode_to_latent(vae: AutoencoderKL, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     scaling: float = 0.18215, sample: bool = True,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """latent = sample of the posterior * 0.18215 (JAX ``encode_to_latent``).
    The sample's unit normal is ``noise`` when given (parity tests hand in
    JAX's draw), else drawn from ``generator``; ``sample=False`` takes the
    posterior mean."""
    mean, logvar = vae.encode(x)
    if not sample:
        return mean * scaling
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return (mean + torch.exp(0.5 * logvar) * noise) * scaling


def decode_from_latent(vae: AutoencoderKL, z: torch.Tensor,
                       scaling: float = 0.18215) -> torch.Tensor:
    return vae.decode(z / scaling)


# ---------------------------------------------------------------------------
# diffusers checkpoints
# ---------------------------------------------------------------------------

_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def diffusers_to_port(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict -> the port's keys (JAX
    ``convert_diffusers_vae``'s reading of it): both attention naming eras
    (``to_q/to_k/to_v/to_out.0`` and ``query/key/value/proj_attn``), and
    attention weights stored as 1x1 convs [out, in, 1, 1] taken as [out,
    in]; every value fp32."""
    out = {}
    for key, value in sd.items():
        t = torch.as_tensor(value).float()
        prefix, _, leaf = key.rpartition(".")
        head, _, name = prefix.rpartition(".")
        if ".attentions." in key and name in _OLD_ATTN:
            key = f"{head}.{_OLD_ATTN[name]}.{leaf}"
        if ".attentions." in key and t.dim() == 4:
            t = t[:, :, 0, 0]
        out[key] = t.contiguous()
    return out


def load_diffusers_vae(sd: Mapping[str, torch.Tensor], cfg: VAEConfig = VAEConfig(),
                       with_encoder: bool = True) -> AutoencoderKL:
    """An AutoencoderKL loaded strictly from a diffusers state dict (e.g.
    ``utils.safetensors.load_file`` of an SD ``vae.safetensors``). The
    decode half takes the file's ``decoder.*`` and ``post_quant_conv``."""
    port = diffusers_to_port(sd)
    if not with_encoder:
        port = {k: v for k, v in port.items()
                if not k.startswith(("encoder.", "quant_conv."))}
    with skip_default_init():  # every parameter is loaded below
        vae = AutoencoderKL(cfg, with_encoder=with_encoder)
    vae.load_state_dict(port, strict=True)
    return vae


def make_vae(cfg: VAEConfig, stable_dif_path: str = "", vae_sd: Optional[dict] = None,
             with_encoder: bool = True, seed: int = 0) -> AutoencoderKL:
    """The frozen codec of the CLIs (JAX ``cli/sample.py::make_vae``): from a
    diffusers ``--stable_dif_path`` safetensors file, from ``vae_sd`` (a
    state dict in the port's keys, ``train.checkpoint.side_weights``': a
    full one, or a decoder-only one for the decode half), or seeded random
    with a warning. On the CPU; the caller moves it."""
    from ..utils.safetensors import load_file

    if stable_dif_path:
        return load_diffusers_vae(load_file(stable_dif_path), cfg, with_encoder)
    with skip_default_init():  # every parameter is loaded or initialised below
        vae = AutoencoderKL(cfg, with_encoder=with_encoder)
    if vae_sd is not None:
        sd = vae_sd
        has_encoder = any(k.startswith("encoder.") for k in sd)
        if with_encoder and not has_encoder:
            raise ValueError("the VAE weights are a decoder-only state dict; encoding images "
                             "needs a full one (encoder.*, quant_conv.*)")
        if has_encoder and not with_encoder:
            sd = {k: v for k, v in sd.items() if not k.startswith(("encoder.", "quant_conv."))}
        vae.load_state_dict(sd, strict=True)
        return vae
    logging.warning("no --stable_dif_path / --vae_pt: seeded random VAE (seed %d)", seed)
    return init_weights_(vae, seed)

