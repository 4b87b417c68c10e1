"""Cross-attention, transformer block and spatial transformer (port of
``worddiffusion_tpu/models/attention.py``).

Every attention goes through ``ops.attention.fused_attention``, the CUDA
kernel on the card, with fp32 scores and softmax (the reference numerics;
the JAX package's bf16 ``fast_softmax`` is not ported). The block's FF
sub-layer (norm3 -> GEGLU FFN -> residual) goes through
``ops.ffn.LnGegluFFN``, the CUDA kernel pair (forward and backward) on
the card. With ``fold_context`` (``UNetConfig.attn_fold_context``) a
cross-attention over a context of L tokens with ``heads * L <= dim``
folds its q projection into K and its out projection into V
(``build_folds``) and runs with its pre-norm and residual as one
``ops.fold_attention`` sub-layer, the CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention, ffn, fold_attention
from .layers import Conv2D, Dense, FeedForward, GroupNorm32


def build_folds(context, wq, wk, wv, wo, heads, dim_head, dtype):
    """Per-sample effective weights of a cross-attention in B.8's per-head
    layout (``bench_kernels/attn_fold_sublayer_pallas.py::build_folds``):
    the q projection associated into K and the out projection into V::

        wt4[b, h] = Wq_h @ K_h[b]^T * scale    # [B, H, C, L]
        vw4[b, h] = V_h[b] @ Wout_h            # [B, H, L, C]

    The k/v projections run in ``dtype``; wt4 and vw4 accumulate in fp32,
    wt4 is scaled in fp32, and both are rounded to ``dtype``. Weights are
    in parameter layout ([out, in])."""
    b, n, _ = context.shape
    ctx = context.to(dtype)
    kh = (ctx @ wk.to(dtype).t()).reshape(b, n, heads, dim_head)
    vh = (ctx @ wv.to(dtype).t()).reshape(b, n, heads, dim_head)
    wq3 = wq.to(dtype).t().reshape(-1, heads, dim_head)
    wo3 = wo.to(dtype).t().reshape(heads, dim_head, -1)
    wt4 = torch.einsum("chd,blhd->bhcl", wq3.float(), kh.float()) * dim_head ** -0.5
    vw4 = torch.einsum("blhd,hdf->bhlf", vh.float(), wo3.float())
    # einsum may return a permuted layout: the kernel reads the folds row-major
    return tuple(f.to(dtype, memory_format=torch.contiguous_format).contiguous()
                 for f in (wt4, vw4))


def fold_weights(context, wq, wk, wv, wo, heads, dim_head, dtype):
    """The same folds in B.7's layout (JAX
    ``models/attention.py::fold_weights``): wt [B, C, H*L] (scaled) and
    vw [B, H*L, C]."""
    wt4, vw4 = build_folds(context, wq, wk, wv, wo, heads, dim_head, dtype)
    b, h, c, l = wt4.shape
    return wt4.permute(0, 2, 1, 3).reshape(b, c, h * l), vw4.reshape(b, h * l, c)


class CrossAttention(nn.Module):
    """Multi-head attention: no q/k/v biases, output projection with bias
    (reference keys ``to_q``, ``to_k``, ``to_v``, ``to_out.0``; the
    reference's Dropout after ``to_out.0`` is inert in JAX, which applies it
    with ``deterministic=True``, and is left out)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Dense(inner, query_dim))

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

    def folds(self, context: torch.Tensor, dtype: torch.dtype):
        """This attention's per-sample folds for ``context``, per head:
        wt4 [B, H, C, L] and vw4 [B, H, L, C] in ``dtype``."""
        return build_folds(context, self.to_q.weight, self.to_k.weight, self.to_v.weight,
                           self.to_out[0].weight, self.heads, self.dim_head, dtype)


class BasicTransformerBlock(nn.Module):
    """attn1 -> attn2 -> FF, each pre-norm with a residual. With
    ``attn1_cross`` (the research UNet) both attentions cross-attend to
    the context through one shared ``norm2``; otherwise attn1 is
    self-attention behind ``norm1``.

    ``use_pallas_ffn``: None and True run the FF sub-layer through the
    ``LnGegluFFN`` Function (the forward and backward kernels for a CUDA
    tensor); False forces the plain autograd version.

    ``fold_context``: an attention over a context of L tokens with
    ``heads * L <= dim`` runs, with its pre-norm and residual, as one
    ``FoldAttention`` call on its folds (JAX ``CrossAttention._folded``'s
    gate); any other attention (self-attention, PHOSC's long contexts)
    takes the unfolded path."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 attn1_cross: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_pallas_ffn: Optional[bool] = None, fold_context: bool = False):
        super().__init__()
        self.dtype = dtype
        self.attn1_cross = attn1_cross
        self.use_pallas_ffn = use_pallas_ffn
        self.fold_context = fold_context
        self.attn1 = CrossAttention(dim, context_dim if attn1_cross else None,
                                    n_heads, d_head)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.ff = FeedForward(dim)
        if not attn1_cross:
            self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def _norm(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps
        ).to(self.dtype)

    def _attend(self, attn: CrossAttention, norm: nn.LayerNorm, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        """x + attn(norm(x), context), folded where the gate allows."""
        fold = self.fold_context and context is not None
        if fold and attn.heads * context.shape[1] <= x.shape[-1]:
            wt4, vw4 = attn.folds(context, self.dtype)
            return fold_attention.fold_attention_heads(x, wt4, vw4, norm.weight, norm.bias,
                                                       attn.to_out[0].bias, norm.eps)
        return x + attn(self._norm(norm, x), context)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.attn1_cross:
            x = self._attend(self.attn1, self.norm2, x, context)
            x = self._attend(self.attn2, self.norm2, x, context)
        else:
            x = self._attend(self.attn1, self.norm1, x, None)
            x = self._attend(self.attn2, self.norm2, x, context)
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
                 context_dim: Optional[int] = None,
                 attn1_cross: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_pallas_ffn: Optional[bool] = None, fold_context: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels)
        self.proj_in = Conv2D(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  attn1_cross, dtype, use_pallas_ffn, fold_context)
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
