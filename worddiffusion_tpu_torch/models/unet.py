"""Conditional UNet denoiser (port of ``worddiffusion_tpu/models/unet.py``).

The parameter names are the reference torch state-dict keys, so
``worddiffusion_tpu.models.convert.export_reference_unet`` output loads
with ``load_state_dict(strict=True)`` and carries JAX weights across.

Ported: the character-conditioned, writer-conditioned UNet with the
concat-form ResBlock (the ``iam`` preset and its relatives), the
PHOSC-conditioned one (``use_phosc``: the ``iam_phosc`` and ``gw``
presets, self-attention then cross-attention over the characters and
the PHOSC tokens), the context-folded cross-attention
(``attn_fold_context``: ``ops.fold_attention``), and the training's
classifier-free drop of the writer conditioning (``writer_mask``). The
other conditioning variants (style vectors, glyph images, reference
latents, the OCR head, FiLM ResBlocks) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..configs.config import UNetConfig
from .attention import SpatialTransformer
from .encoders import CharacterEncoder
from .layers import (
    Conv2D, Dense, Downsample, GroupNorm32, Upsample, gn_silu_conv, timestep_embedding,
)

_UNPORTED_CONFIG = (
    "style_vec_dim", "use_char_images", "img_conditioned",
    "ocr_head", "use_scale_shift_norm", "split_skip_conv", "return_attn",
    "fast_softmax",
)


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv residual block with the timestep embedding
    added between the convs (reference keys ``in_layers``,
    ``emb_layers``, ``out_layers``, ``skip_connection``; the Sequentials
    hold the parameters, ``forward`` runs the fused ops on them).
    ``out_layers.2`` is the reference's Dropout slot, a no-op: JAX applies
    the UNet with ``deterministic=True`` in training and in sampling."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(), Conv2D(in_ch, out_ch))
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_dim, out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch), nn.SiLU(), nn.Identity(),
            Conv2D(out_ch, out_ch, zero_init=True),
        )
        self.skip_connection = Conv2D(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        # each GroupNorm -> SiLU -> conv runs as one fused op on the
        # Sequentials' parameters (B.6 where the conv keeps the width, else
        # B.5 + SiLU then the conv)
        h = gn_silu_conv(self.in_layers[0], self.in_layers[2], x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + gn_silu_conv(self.out_layers[0], self.out_layers[3], h)


class TimestepBlock(nn.ModuleList):
    """One entry of input_blocks / middle_block / output_blocks."""

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, context)
            else:
                h = layer(h)
        return h


class UNet(nn.Module):
    """forward(x_t [B,H,W,C], t [B], context_ids [B,L], writer_id [B],
    phosc_ids [B,P]?) -> eps-hat [B,H,W,C] fp32. NHWC at the interface,
    like the JAX UNet."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        unported = [f for f in _UNPORTED_CONFIG if getattr(cfg, f)]
        if unported:
            raise NotImplementedError(
                f"UNetConfig options not ported to PyTorch yet: {unported}"
            )
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = nn.Sequential(Dense(mc, ted), nn.SiLU(), Dense(ted, ted))
        self.label_emb = nn.Embedding(cfg.num_writers, ted)
        self.word_emb = CharacterEncoder(
            cfg.vocab_size, cfg.context_dim, cfg.max_seq_len, self.dtype
        )

        def st(ch):
            return SpatialTransformer(
                ch, cfg.num_heads, ch // cfg.num_heads, cfg.transformer_depth,
                cfg.context_dim, cfg.attn1_cross, self.dtype,
                cfg.use_pallas_ffn, bool(cfg.attn_fold_context),
            )

        self.input_blocks = nn.ModuleList([TimestepBlock([Conv2D(cfg.in_channels, mc)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, mult * mc, ted)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(st(ch))
                self.input_blocks.append(TimestepBlock(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(TimestepBlock([Downsample(ch)]))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepBlock([
            ResBlock(ch, ch, ted), st(ch), ResBlock(ch, ch, ted),
        ])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mc * mult, ted)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(st(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepBlock(layers))

        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(), Conv2D(ch, cfg.out_channels, zero_init=True)
        )

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context_ids: Optional[torch.Tensor] = None,
                writer_id: Optional[torch.Tensor] = None,
                phosc_ids: Optional[torch.Tensor] = None,
                writer_mask: Optional[torch.Tensor] = None,
                **conditioning) -> torch.Tensor:
        """``phosc_ids`` [B, P] int: the PHOSC descriptor as token ids, read
        only with ``use_phosc``. ``writer_mask`` [B] scales each sample's
        writer embedding (0 drops it: the training's classifier-free drop)."""
        given = [k for k, v in conditioning.items() if v is not None]
        if given:
            raise NotImplementedError(f"UNet conditioning not ported yet: {given}")
        cfg, dtype = self.cfg, self.dtype
        emb = self.time_embed(timestep_embedding(t, cfg.model_channels).to(dtype))
        if writer_id is not None:
            # clamp instead of a device assert on out-of-range ids
            wid = writer_id.clamp(0, cfg.num_writers - 1)
            w_emb = self.label_emb(wid).to(dtype)
            if writer_mask is not None:
                w_emb = w_emb * writer_mask[:, None].to(dtype)
            emb = emb + w_emb
        context = None
        if context_ids is not None:
            context = self.word_emb(context_ids)
            if cfg.use_phosc and phosc_ids is not None:
                # the PHOSC ids go through the same encoder and extend the
                # sequence axis (JAX unet.py:273-276)
                context = torch.cat([context, self.word_emb(phosc_ids)], dim=1)

        h = x.permute(0, 3, 1, 2).to(dtype)  # NHWC -> NCHW (channels_last memory)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return gn_silu_conv(self.out[0], self.out[2], h).float().permute(0, 2, 3, 1)
