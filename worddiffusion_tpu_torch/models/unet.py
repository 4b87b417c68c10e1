"""Conditional UNet denoiser (port of ``worddiffusion_tpu/models/unet.py``).

The parameter names are the reference torch state-dict keys, so
``worddiffusion_tpu.models.convert.export_reference_unet`` output loads
with ``load_state_dict(strict=True)`` and carries JAX weights across
(with ``models.convert.jax_unet_extras_to_torch`` for the parameters that
exporter leaves out: the CTC aux head and the glyph encoder).

Ported: the character- and writer-conditioned UNet (the ``iam`` preset
and its relatives), the PHOSC-conditioned one (``use_phosc``), the
context-folded cross-attention (``attn_fold_context``), the training's
classifier-free drop of the writer conditioning (``writer_mask``), the
interpolation between two writers (``writer_id2``, ``mix_rate``), writer
style vectors (``style_vec_dim``: appended to the context, or replacing
it), glyph images (``use_char_images``, the model side), reference
latents (``img_conditioned``), the CTC aux head (``ocr_head``), FiLM
ResBlocks (``use_scale_shift_norm``). ``split_skip_conv`` is accepted and
runs the concat form: the JAX option is the same math on the same
parameters, emitted another way for the TPU, and two B.6 launches on the
halves are slower on the card than one on the concat. ``return_attn``
appends a dict of every attention's fp32 maps [B, H, Nq, Nk] to the output,
keyed by the JAX model's ``intermediates`` paths (``in_0_0_attn/block_0/
attn1/attn``); on the card they come from the maps kernel beside B.4.
``fast_softmax``: resolved once, here: True runs the unfolded attentions
outside the maps path in the JAX model's bf16 softmax order (B.4's fast
mode on the card); None and False keep the fp32 softmax, which is what JAX
resolves them to on every backend but the TPU, and in its Trainer.
``remat`` checkpoints every transformer block while autograd records
(``models.attention.SpatialTransformer``), as JAX's ``nn.remat`` does.

Tensor parallel (``mesh`` with a model axis M above 1): the
SpatialTransformers' blocks hold 1/M of each attention's heads and of each
FF's inner width (``models.attention``; the layout is
``parallel.mesh.param_spec``); everything else is replicated, as JAX's
patterns leave it. ``check_model_axis`` refuses a config whose heads or FF
inner width the axis does not divide.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.config import UNetConfig
from .attention import SpatialTransformer
from .ctc_head import CTCHead
from .encoders import CharacterEncoder, StyleProjection
from .layers import (
    Conv2D, Dense, Downsample, GroupNorm32, Upsample, gn_silu_conv, timestep_embedding,
)

class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv residual block with the timestep embedding
    added between the convs (reference keys ``in_layers``,
    ``emb_layers``, ``out_layers``, ``skip_connection``; the Sequentials
    hold the parameters, ``forward`` runs the fused ops on them).
    ``out_layers.2`` is the reference's Dropout slot, a no-op: JAX applies
    the UNet with ``deterministic=True`` in training and in sampling.

    ``scale_shift`` (FiLM, ``use_scale_shift_norm``): ``emb_layers.1`` is
    2 * out_ch wide, scale then shift, and the second half of the block is
    ``conv(silu(GroupNorm(h) * (1 + scale) + shift))``: the norm without
    SiLU (B.5), the modulation and SiLU in the model's dtype, then the conv
    as a stock conv (B.6 has no slot for a per-sample modulation between
    its norm and its SiLU, nor has the TPU kernel)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, scale_shift: bool = False):
        super().__init__()
        self.scale_shift = scale_shift
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(), Conv2D(in_ch, out_ch))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Dense(emb_dim, 2 * out_ch if scale_shift else out_ch))
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
        res = self.skip_connection(x)
        e = self.emb_layers(emb)[:, :, None, None]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = self.out_layers[0](h) * (1 + scale) + shift
            return res + self.out_layers[3](F.silu(h))
        return res + gn_silu_conv(self.out_layers[0], self.out_layers[3], h + e)


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


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's "SAME" padding of NCHW x for a k x k kernel at stride s (the
    extra row and column go after)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def check_model_axis(cfg: UNetConfig, model: int) -> None:
    """Raise unless a model axis of ``model`` ranks divides the heads and the
    FF inner width (4 x channels) of every level; the attention maps
    (``return_attn``, an analysis forward) are taken in one process."""
    if model <= 1:
        return
    if cfg.return_attn:
        raise ValueError(f"return_attn needs the whole model in one process, not a model axis "
                         f"of {model} (--mesh_model)")
    if cfg.num_heads % model:
        raise ValueError(f"num_heads {cfg.num_heads} is not divisible by the model axis {model} "
                         "(--mesh_model): each model rank holds num_heads / model heads")
    for mult in cfg.channel_mult:
        inner = 4 * mult * cfg.model_channels
        if inner % model:
            raise ValueError(f"the FF inner width {inner} is not divisible by the model axis "
                             f"{model} (--mesh_model)")


class UNet(nn.Module):
    """forward(x_t [B,H,W,C], t [B], context_ids [B,L], writer_id [B], ...)
    -> eps-hat [B,H,W,C] fp32, and the CTC logits [T,B,K] fp32 after it
    with ``ocr_head``. NHWC at the interface, like the JAX UNet.

    ``mesh`` (``parallel.mesh.Mesh``): with a model axis above 1, this
    rank's shard of the tensor-parallel UNet (load it with
    ``parallel.tensor.shard_state_dict`` of a full state dict)."""

    def __init__(self, cfg: UNetConfig, mesh=None):
        super().__init__()
        check_model_axis(cfg, 1 if mesh is None else mesh.model)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        # None resolves to the fp32 softmax: JAX's resolution off the TPU and in training
        fast_softmax = cfg.fast_softmax is True
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = nn.Sequential(Dense(mc, ted), nn.SiLU(), Dense(ted, ted))
        self.label_emb = nn.Embedding(cfg.num_writers, ted)
        self.word_emb = CharacterEncoder(
            cfg.vocab_size, cfg.context_dim, cfg.max_seq_len, self.dtype
        )

        self._attn_names: list[tuple[str, nn.Module]] = []  # (JAX path, attention)

        def st(ch, name):
            t = SpatialTransformer(
                ch, cfg.num_heads, ch // cfg.num_heads, cfg.transformer_depth,
                cfg.context_dim, cfg.attn1_cross, self.dtype,
                cfg.use_pallas_ffn, bool(cfg.attn_fold_context), cfg.return_attn, mesh,
                fast_softmax, cfg.remat,
            )
            for d, block in enumerate(t.transformer_blocks):
                for a in ("attn1", "attn2"):
                    self._attn_names.append((f"{name}/block_{d}/{a}/attn", getattr(block, a)))
            return t

        def res(cin, cout):
            return ResBlock(cin, cout, ted, cfg.use_scale_shift_norm)

        # reference latents join x_t on the channel axis before conv_in
        in_ch = cfg.in_channels * (2 if cfg.img_conditioned else 1)
        self.input_blocks = nn.ModuleList([TimestepBlock([Conv2D(in_ch, mc)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(st(ch, f"in_{level}_{i}_attn"))
                self.input_blocks.append(TimestepBlock(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(TimestepBlock([Downsample(ch)]))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepBlock([res(ch, ch), st(ch, "mid_attn"), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(st(ch, f"out_{level}_{i}_attn"))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepBlock(layers))

        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(), Conv2D(ch, cfg.out_channels, zero_init=True)
        )
        if cfg.style_vec_dim:
            self.wrd_proj = StyleProjection(cfg.style_vec_dim, cfg.context_dim)
        if cfg.use_char_images:
            # glyph crops [B, L, gh, gw, 1] -> one context token each
            self.glyph_conv1 = Conv2D(1, 32, 3, stride=2, padding=0)
            self.glyph_conv2 = Conv2D(32, 64, 3, stride=2, padding=0)
            self.glyph_proj = Dense(64, cfg.context_dim)
        if cfg.ocr_head:
            self.auxhead = CTCHead(cfg.out_channels, cfg.ocr_hidden, cfg.ocr_layers,
                                   cfg.ocr_classes, cfg.ocr_norm)

    def _check_conditioning(self, style_vec, writer_id2, mix_rate, cond_latents,
                            char_images) -> None:
        """A conditioning input the config does not take (the JAX UNet drops
        it silently), half of a writer mix, or a reference-latent model
        without its latents (the JAX UNet fails at conv_in's shape) raise."""
        cfg = self.cfg
        unused = [name for name, v, on in (
            ("style_vec", style_vec, cfg.style_vec_dim), ("char_images", char_images,
                                                          cfg.use_char_images),
            ("cond_latents", cond_latents, cfg.img_conditioned)) if v is not None and not on]
        if unused:
            raise ValueError(f"UNet conditioning {unused} given to a model whose config does "
                             "not take it")
        if (writer_id2 is None) != (mix_rate is None):
            raise ValueError("a writer mix needs both writer_id2 and mix_rate")
        if cfg.img_conditioned and cond_latents is None:
            raise ValueError("an img_conditioned UNet needs cond_latents (its conv_in takes "
                             f"{2 * cfg.in_channels} channels)")

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context_ids: Optional[torch.Tensor] = None,
                writer_id: Optional[torch.Tensor] = None,
                phosc_ids: Optional[torch.Tensor] = None,
                writer_mask: Optional[torch.Tensor] = None,
                *,
                style_vec: Optional[torch.Tensor] = None,
                writer_id2: Optional[torch.Tensor] = None,
                mix_rate=None,
                cond_latents: Optional[torch.Tensor] = None,
                char_images: Optional[torch.Tensor] = None):
        """-> eps [, CTC logits with ``ocr_head``] [, the maps dict with
        ``return_attn``]. ``phosc_ids`` [B, P] int: the PHOSC descriptor as token ids, read
        only with ``use_phosc``. ``writer_mask`` [B] scales each sample's
        writer embedding (0 drops it: the training's classifier-free drop).
        ``writer_id2`` [B] and ``mix_rate`` (a float or [B]) mix two writers'
        embeddings, ``(1 - r) * emb(w1) + r * emb(w2)``. ``style_vec`` [B, D]
        or [B, S, D], ``char_images`` [B, L, gh, gw, 1] and ``cond_latents``
        (x_t's shape) are the optional conditionings of their configs."""
        self._check_conditioning(style_vec, writer_id2, mix_rate, cond_latents, char_images)
        cfg, dtype = self.cfg, self.dtype
        emb = self.time_embed(timestep_embedding(t, cfg.model_channels).to(dtype))
        if writer_id is not None:
            # clamp instead of a device assert on out-of-range ids
            w_emb = self.label_emb(writer_id.clamp(0, cfg.num_writers - 1)).to(dtype)
            if writer_id2 is not None:
                w2 = self.label_emb(writer_id2.clamp(0, cfg.num_writers - 1)).to(dtype)
                r = torch.as_tensor(mix_rate, dtype=dtype, device=w_emb.device).reshape(-1, 1)
                w_emb = (1.0 - r) * w_emb + r * w2
            if writer_mask is not None:
                w_emb = w_emb * writer_mask[:, None].to(dtype)
            emb = emb + w_emb
        context = None
        if context_ids is not None:
            if style_vec is not None and cfg.style_replace_context:
                # --wrdChrWrStyl 1: the style tokens replace the characters (and
                # the PHOSC tokens), so the character encoder is not run
                context = self.wrd_proj(style_vec.to(dtype))
            else:
                context = self.word_emb(context_ids)
                if cfg.use_phosc and phosc_ids is not None:
                    # the PHOSC ids go through the same encoder and extend the
                    # sequence axis (JAX unet.py:273-276)
                    context = torch.cat([context, self.word_emb(phosc_ids)], dim=1)
                if style_vec is not None:
                    context = torch.cat([context, self.wrd_proj(style_vec.to(dtype))], dim=1)
            if char_images is not None:
                b, n, gh, gw, cc = char_images.shape
                g = char_images.reshape(b * n, gh, gw, cc).permute(0, 3, 1, 2).to(dtype)
                g = F.silu(self.glyph_conv1(_same_pad(g, 3, 2)))
                g = F.silu(self.glyph_conv2(_same_pad(g, 3, 2)))
                g = self.glyph_proj(g.mean(dim=(2, 3)))
                context = torch.cat([context, g.reshape(b, n, -1)], dim=1)

        if cond_latents is not None:
            x = torch.cat([x, cond_latents.to(x.dtype)], dim=-1)
        h = x.permute(0, 3, 1, 2).to(dtype)  # NHWC -> NCHW (channels_last memory)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        e = gn_silu_conv(self.out[0], self.out[2], h)
        eps = e.float().permute(0, 2, 3, 1)
        out = (eps, self.auxhead(e)) if cfg.ocr_head else (eps,)
        if cfg.return_attn:
            maps = {}
            for name, attn in self._attn_names:
                maps[name], attn.attn_map = attn.attn_map, None
            out = out + (maps,)
        return out if len(out) > 1 else eps
