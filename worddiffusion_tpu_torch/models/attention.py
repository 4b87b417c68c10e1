"""Cross-attention, transformer block and spatial transformer (port of
``worddiffusion_tpu/models/attention.py``).

Every attention goes through ``ops.attention.fused_attention``, the CUDA
kernel on the card, with fp32 scores and softmax (the reference numerics;
the JAX package's bf16 ``fast_softmax`` is not ported). The block's FF
sub-layer (norm3 -> GEGLU FFN -> residual) goes through
``ops.ffn.LnGegluFFN``, the CUDA kernel pair (forward and backward) on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention, ffn
from .layers import Conv2D, Dense, FeedForward, GroupNorm32


class CrossAttention(nn.Module):
    """Multi-head attention: no q/k/v biases, output projection with bias
    (reference keys ``to_q``, ``to_k``, ``to_v``, ``to_out.0``)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Dense(inner, query_dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, nq, _ = x.shape
        nk = context.shape[1]
        h, d = self.heads, self.dim_head

        def heads_first(t, n):  # [B, N, H*D] -> contiguous [B, H, N, D], the kernel's layout
            return t.reshape(b, n, h, d).transpose(1, 2).contiguous()

        q = heads_first(self.to_q(x), nq)
        k = heads_first(self.to_k(context), nk)
        v = heads_first(self.to_v(context), nk)
        out = attention.fused_attention(q, k, v, d ** -0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, nq, h * d))


class BasicTransformerBlock(nn.Module):
    """attn1 -> attn2 -> FF, each pre-norm with a residual. With
    ``attn1_cross`` (the research UNet) both attentions cross-attend to
    the context through one shared ``norm2``; otherwise attn1 is
    self-attention behind ``norm1``.

    ``use_pallas_ffn``: None and True run the FF sub-layer through the
    ``LnGegluFFN`` Function (the forward and backward kernels for a CUDA
    tensor); False forces the plain autograd version."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, dropout: float = 0.0,
                 attn1_cross: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_pallas_ffn: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.attn1_cross = attn1_cross
        self.use_pallas_ffn = use_pallas_ffn
        self.attn1 = CrossAttention(dim, context_dim if attn1_cross else None,
                                    n_heads, d_head, dropout)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dropout)
        self.ff = FeedForward(dim, dropout=dropout)
        if not attn1_cross:
            self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def _norm(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps
        ).to(self.dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.attn1_cross:
            x = x + self.attn1(self._norm(self.norm2, x), context)
            x = x + self.attn2(self._norm(self.norm2, x), context)
        else:
            x = x + self.attn1(self._norm(self.norm1, x), None)
            x = x + self.attn2(self._norm(self.norm2, x), context)
        proj, out, norm = self.ff.net[0].proj, self.ff.net[2], self.norm3
        if self.use_pallas_ffn is False:
            return ffn.ln_geglu_ffn_reference(x, norm.weight, norm.bias, proj.weight.t(),
                                              proj.bias, out.weight.t(), out.bias, norm.eps)
        # the fp32 master weights in parameter layout: the Function casts
        # them itself, so their gradients come back in fp32
        return ffn.LnGegluFFN.apply(x, norm.weight, norm.bias, proj.weight, proj.bias,
                                    out.weight, out.bias, norm.eps)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 conv in -> token transformer -> 1x1 zero conv out
    + residual. NCHW in and out; [B, H*W, C] tokens inside."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, dropout: float = 0.0,
                 attn1_cross: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_pallas_ffn: Optional[bool] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels)
        self.proj_in = Conv2D(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, dropout,
                                  attn1_cross, dtype, use_pallas_ffn)
            for _ in range(depth)
        ])
        self.proj_out = Conv2D(inner, in_channels, 1, zero_init=True)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        c = x.shape[1]
        # tokens [B, H*W, C], contiguous whatever memory format the convs chose
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
        for block in self.transformer_blocks:
            x = block(x, context)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in
