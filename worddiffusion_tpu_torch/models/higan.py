"""BigGAN-style conditional generator as an alternative denoiser (port of
``worddiffusion_tpu/models/higan.py``, ``--hiGanArch 1``).

Condition-modulated residual blocks at constant resolution: every norm is
``GroupNorm32`` without SiLU (kernel B.5 on the card), followed by the
modulation ``h * (1 + scale) + shift`` and the SiLU in the model's dtype, as
the JAX module rounds them (the norm's output in bf16 first), then a stock
conv; ``out_norm`` runs B.5 with SiLU. That is 2 * ``num_blocks`` + 1 B.5
launches a call (13 at the default 6 blocks).

The JAX adapter drops ``phosc_ids``, ``style_vec``, ``cond_latents``,
``char_images``, ``writer_id2`` and ``mix_rate`` without a word: a model
trained or sampled with them would silently ignore them. The port refuses
each. ``writer_mask`` (the training's classifier-free drop) is accepted and
has no effect, as in the JAX adapter, so that the trainer's step runs
unchanged; a HiGAN model is therefore never trained for guidance.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.config import UNetConfig
from ..data.tokenizer import PAD_TOKEN
from .encoders import CharacterEncoder
from .layers import Conv2D, Dense, GroupNorm32, timestep_embedding

_DROPPED = ("phosc_ids", "style_vec", "cond_latents", "char_images", "writer_id2", "mix_rate")


def refuse_conditioning(cfg: UNetConfig, who: str = "the HiGAN+ denoiser",
                        error: type = ValueError, **given) -> None:
    """Raise ``error`` naming each conditioning that ``cfg`` turns on, or
    that ``given`` (a description -> a value, set when truthy) holds, which
    the HiGAN+ generator does not take (``who``: the adapter, or a CLI's
    flag). The JAX adapter drops them silently (ROADMAP C)."""
    named = [k for k, on in {"PHOSC": cfg.use_phosc, "style vectors": cfg.style_vec_dim,
                             "glyph images": cfg.use_char_images,
                             "reference images": cfg.img_conditioned,
                             "the CTC aux head": cfg.ocr_head, **given}.items() if on]
    if named:
        raise error(f"{who} takes no {', '.join(named)}: the HiGAN+ generator is conditioned "
                    "on the characters, the writer and t only (the JAX adapter drops the rest "
                    "silently; ROADMAP C)")


class CondResBlock(nn.Module):
    """cgn1 -> SiLU -> conv1 -> cgn2 -> SiLU -> conv2 (zero init) + x, each
    cgn a GroupNorm modulated by a projection of the shared condition. The
    generator keeps one width throughout, so the JAX block's 1x1 skip for a
    change of width is never built."""

    def __init__(self, channels: int, cond_dim: int):
        super().__init__()
        self.cgn1 = GroupNorm32(channels)
        self.cgn1_proj = Dense(cond_dim, 2 * channels)
        self.conv1 = Conv2D(channels, channels)
        self.cgn2 = GroupNorm32(channels)
        self.cgn2_proj = Dense(cond_dim, 2 * channels)
        self.conv2 = Conv2D(channels, channels, zero_init=True)

    @staticmethod
    def _cgn(norm: GroupNorm32, proj: Dense, h: torch.Tensor, cond: torch.Tensor):
        scale, shift = proj(cond)[:, :, None, None].chunk(2, dim=1)
        return norm(h) * (1 + scale) + shift

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self._cgn(self.cgn1, self.cgn1_proj, x, cond)))
        h = self.conv2(F.silu(self._cgn(self.cgn2, self.cgn2_proj, h, cond)))
        return x + h


class HiGanGenerator(nn.Module):
    """x_t [B, H, W, C] + (text ids, text length, t, writer) -> predicted
    noise [B, H, W, out_channels] fp32. NCHW (channels_last) inside."""

    def __init__(self, cfg: UNetConfig, num_blocks: int = 6):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        mc = cfg.model_channels
        self.t_proj = Dense(mc, mc)
        self.writer_emb = nn.Embedding(cfg.num_writers, mc)
        self.text_enc = CharacterEncoder(cfg.vocab_size, cfg.context_dim, cfg.max_seq_len,
                                         self.dtype)
        cond_dim = 2 * mc + cfg.context_dim
        self.conv_in = Conv2D(cfg.in_channels, mc)
        self.blocks = nn.ModuleList([CondResBlock(mc, cond_dim) for _ in range(num_blocks)])
        self.out_norm = GroupNorm32(mc)
        self.conv_out = Conv2D(mc, cfg.out_channels, zero_init=True)

    def forward(self, x, text_ids, text_len, t, writer_id) -> torch.Tensor:
        cfg, dtype = self.cfg, self.dtype
        t_emb = self.t_proj(timestep_embedding(t, cfg.model_channels).to(dtype))
        w_emb = self.writer_emb(writer_id.clamp(0, cfg.num_writers - 1)).to(dtype)
        txt = self.text_enc(text_ids)
        # length-masked mean of the text tokens
        mask = (torch.arange(text_ids.shape[1], device=txt.device)[None, :]
                < text_len[:, None]).to(txt.dtype)
        pooled = (txt * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp_min(1.0)
        cond = torch.cat([t_emb, w_emb, pooled.to(dtype)], dim=-1)
        h = self.conv_in(x.permute(0, 3, 1, 2).to(dtype))
        for block in self.blocks:
            h = block(h, cond)
        out = self.conv_out(self.out_norm(h, silu=True))
        return out.float().permute(0, 2, 3, 1)


class HiGanDenoiserAdapter(nn.Module):
    """The UNet's call signature around ``HiGanGenerator`` (module
    ``generator``), so it drops into the train step and the samplers; the
    text length is the count of non-PAD context ids."""

    def __init__(self, cfg: UNetConfig, num_blocks: int = 6):
        super().__init__()
        self.cfg = cfg
        self.generator = HiGanGenerator(cfg, num_blocks)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context_ids: Optional[torch.Tensor] = None,
                writer_id: Optional[torch.Tensor] = None,
                phosc_ids: Optional[torch.Tensor] = None,
                writer_mask: Optional[torch.Tensor] = None, **cond) -> torch.Tensor:
        unknown = [k for k in cond if k not in _DROPPED]
        if unknown:
            raise TypeError(f"HiGanDenoiserAdapter got unexpected arguments {unknown}")
        refuse_conditioning(self.cfg, **{k: v is not None
                                         for k, v in {"phosc_ids": phosc_ids, **cond}.items()})
        text_len = (context_ids != PAD_TOKEN).sum(dim=1)
        return self.generator(x, context_ids, text_len, t, writer_id)
