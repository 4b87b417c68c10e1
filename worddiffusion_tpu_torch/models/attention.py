"""Cross-attention, transformer block and spatial transformer (port of
``worddiffusion_tpu/models/attention.py``).

Every attention goes through ``ops.attention.fused_attention``, the CUDA
kernel on the card, with fp32 scores and softmax (the reference numerics);
with ``fast_softmax`` (``UNetConfig.fast_softmax=True``) the attentions that
take the JAX model's ``_attend`` (unfolded, without ``sow_attn``) run its
bf16 order instead (``fast=True``: the kernel's fast mode); the fold and the
maps path ignore the switch, as JAX's ``_folded`` and sown softmax do. With
``remat`` (``UNetConfig.remat``) ``SpatialTransformer`` checkpoints each
block (``torch.utils.checkpoint``, non-reentrant) while autograd records, as
JAX wraps the block in ``nn.remat``: the backward recomputes the block's
forward, kernels included, instead of keeping its activations. The block's FF
sub-layer (norm3 -> GEGLU FFN -> residual) goes through
``ops.ffn.LnGegluFFN``, the CUDA kernel pair (forward and backward) on
the card, at every width where JAX's model takes its fused kernel
(``ops.ffn.kernel_takes(d, 4d)``: d = 64k up to 768); a wider block runs the
plain FF, as JAX runs its unfused one there (``ops.ffn.plain_calls``). With
``fold_context`` (``UNetConfig.attn_fold_context``) a
cross-attention over a context of L tokens with ``heads * L <= dim``
folds its q projection into K and its out projection into V
(``build_folds``) and runs with its pre-norm and residual as one
``ops.fold_attention`` sub-layer, the CUDA kernel on the card. With
``sow_attn`` (``UNetConfig.return_attn``) every attention also keeps its
fp32 maps ``softmax(q kᵀ · scale)`` in ``attn_map`` (``ops.attention.
attention_with_probs``: the maps kernel beside B.4 on the card), and none
folds, as in the JAX model.

Under a model axis above 1 (``mesh``, tensor parallel; ``parallel.mesh``
names the layout) each attention holds ``heads/M`` heads (its rows of
``to_q``/``to_k``/``to_v`` and its columns of ``to_out.0``) and runs B.4 on
them; its out-projection is a partial sum, which ``parallel.tensor.
reduce_from_model`` adds up before the bias; the FF sub-layer is
``ops.ffn.ffn_sublayer_tp`` (B.2 on the rank's slice of the inner width). A
folded attention gathers the four projections (``gather_from_model``) and
runs B.8 whole on every rank: B.8 adds the out bias and the residual
inside, so a partial cannot be summed after it (JAX's partitioner likewise
gathers sharded weights ahead of a Pallas call).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import attention, ffn, fold_attention
from ..parallel.tensor import copy_to_model, gather_from_model, reduce_from_model
from .layers import Conv2D, Dense, FeedForward, GroupNorm32


def _model_axis(mesh):
    """``mesh`` where its model axis is above 1, else None."""
    return mesh if mesh is not None and mesh.model > 1 else None


def build_folds(context, wq, wk, wv, wo, heads, dim_head, dtype):
    """Per-sample effective weights of a cross-attention in B.8's per-head
    layout (``bench_kernels/attn_fold_sublayer_pallas.py::build_folds``):
    the q projection associated into K and the out projection into V::

        wt4[b, h] = Wq_h @ K_h[b]^T * scale    # [B, H, C, L]
        vw4[b, h] = V_h[b] @ Wout_h            # [B, H, L, C]

    The k/v projections run in ``dtype``; wt4 and vw4 accumulate in fp32,
    wt4 is scaled in fp32, and both are rounded to ``dtype``. Weights are
    in parameter layout ([out, in]).

    vw4 is contiguous; wt4 is the ``[..., :L]`` view of an allocation whose
    L stride is L rounded up to 8 (48 for the 42 context tokens), so that
    its rows start on 16-byte boundaries, which the fold kernel's tensor
    maps need; its values are those of the contiguous layout."""
    b, n, _ = context.shape
    ctx = context.to(dtype)
    kh = (ctx @ wk.to(dtype).t()).reshape(b, n, heads, dim_head)
    vh = (ctx @ wv.to(dtype).t()).reshape(b, n, heads, dim_head)
    wq3 = wq.to(dtype).t().reshape(-1, heads, dim_head)
    wo3 = wo.to(dtype).t().reshape(heads, dim_head, -1)
    wt4 = torch.einsum("chd,blhd->bhcl", wq3.float(), kh.float()) * dim_head ** -0.5
    vw4 = torch.einsum("blhd,hdf->bhlf", vh.float(), wo3.float())
    # einsum may return a permuted layout: the kernel reads the folds row-major
    padded = wt4.new_empty((*wt4.shape[:-1], -(-n // 8) * 8), dtype=dtype)[..., :n]
    return padded.copy_(wt4), vw4.to(dtype, memory_format=torch.contiguous_format).contiguous()


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
    with ``deterministic=True``, and is left out). Under a model axis of M
    (``mesh``) it holds heads/M of ``heads`` (``self.heads``) and
    ``partial`` gives its share of the output."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, mesh=None):
        super().__init__()
        self.mesh = _model_axis(mesh)
        self.all_heads = heads  # over every model rank
        heads //= 1 if self.mesh is None else self.mesh.model
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Dense(inner, query_dim))
        self.sow_attn = False
        self.fast_softmax = False  # JAX's bf16 softmax order (not on the maps path)
        self.attn_map: Optional[torch.Tensor] = None  # [B, H, Nq, Nk] fp32 with sow_attn

    def _heads(self, x: torch.Tensor, context: Optional[torch.Tensor]) -> torch.Tensor:
        """The heads' outputs [B, Nq, H*D], before the out-projection."""
        context = x if context is None else context
        b, nq, _ = x.shape
        nk = context.shape[1]
        h, d = self.heads, self.dim_head

        def heads_first(t, n):  # [B, N, H*D] -> contiguous [B, H, N, D], the kernel's layout
            return t.reshape(b, n, h, d).transpose(1, 2).contiguous()

        q = heads_first(self.to_q(x), nq)
        k = heads_first(self.to_k(context), nk)
        v = heads_first(self.to_v(context), nk)
        if self.sow_attn:
            out, self.attn_map = attention.attention_with_probs(q, k, v, d ** -0.5)
        else:
            out = attention.fused_attention(q, k, v, d ** -0.5, self.fast_softmax)
        return out.transpose(1, 2).reshape(b, nq, h * d)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.to_out(self._heads(x, context))

    def partial(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This rank's heads through its columns of ``to_out.0``, without
        the bias: its share of the output under a model axis."""
        out = self._heads(x, context)
        return F.linear(out, self.to_out[0].weight.to(out.dtype))

    def folds(self, context: torch.Tensor, dtype: torch.dtype):
        """This attention's per-sample folds for ``context``, per head, over
        every head (the projections gathered under a model axis):
        wt4 [B, H, C, L] and vw4 [B, H, L, C] in ``dtype``."""
        ws = (self.to_q.weight, self.to_k.weight, self.to_v.weight, self.to_out[0].weight)
        if self.mesh is not None:
            ws = gather_from_model(self.mesh, ws, (0, 0, 0, 1))
        return build_folds(context, *ws, self.all_heads, self.dim_head, dtype)


class BasicTransformerBlock(nn.Module):
    """attn1 -> attn2 -> FF, each pre-norm with a residual. With
    ``attn1_cross`` (the research UNet) both attentions cross-attend to
    the context through one shared ``norm2``; otherwise attn1 is
    self-attention behind ``norm1``.

    ``use_pallas_ffn``: None and True run the FF sub-layer through
    ``ffn.ffn_sublayer`` (the ``LnGegluFFN`` Function's forward and
    backward kernels for a CUDA tensor); False forces the plain autograd
    version.

    ``fold_context``: an attention over a context of L tokens with
    ``heads * L <= dim`` runs, with its pre-norm and residual, as one
    ``FoldAttention`` call on its folds (JAX ``CrossAttention._folded``'s
    gate); any other attention (self-attention, PHOSC's long contexts)
    takes the unfolded path.

    ``mesh``: a model axis above 1 shards the attentions by heads and the FF
    by its inner width (tensor parallel; the module docstring).

    ``fast_softmax``: the unfolded attentions without ``sow_attn`` run JAX's
    fast_softmax order (``ops.attention.fused_attention(fast=True)``)."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 attn1_cross: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_pallas_ffn: Optional[bool] = None, fold_context: bool = False,
                 sow_attn: bool = False, mesh=None, fast_softmax: bool = False):
        super().__init__()
        self.mesh = _model_axis(mesh)
        self.dtype = dtype
        self.attn1_cross = attn1_cross
        self.use_pallas_ffn = use_pallas_ffn
        self.fold_context = fold_context and not sow_attn
        self.attn1 = CrossAttention(dim, context_dim if attn1_cross else None,
                                    n_heads, d_head, mesh)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, mesh)
        self.attn1.sow_attn = self.attn2.sow_attn = sow_attn
        self.attn1.fast_softmax = self.attn2.fast_softmax = fast_softmax
        self.ff = FeedForward(dim, model=1 if self.mesh is None else self.mesh.model)
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
        if fold and attn.all_heads * context.shape[1] <= x.shape[-1]:
            wt4, vw4 = attn.folds(context, self.dtype)
            return fold_attention.fold_attention_heads(x, wt4, vw4, norm.weight, norm.bias,
                                                       attn.to_out[0].bias, norm.eps)
        if self.mesh is None:
            return x + attn(self._norm(norm, x), context)
        # column-parallel q/k/v: the replicated inputs' gradients are summed
        # over the model ranks; row-parallel to_out: the partials are summed,
        # then the bias is added once
        h = self._norm(norm, x)
        if context is None:
            h = copy_to_model(self.mesh, h)
        else:
            h, context = copy_to_model(self.mesh, h, context)
        out = reduce_from_model(self.mesh, attn.partial(h, context))
        return x + (out + attn.to_out[0].bias.float()).to(x.dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.attn1_cross:
            x = self._attend(self.attn1, self.norm2, x, context)
            x = self._attend(self.attn2, self.norm2, x, context)
        else:
            x = self._attend(self.attn1, self.norm1, x, None)
            x = self._attend(self.attn2, self.norm2, x, context)
        proj, out, norm = self.ff.net[0].proj, self.ff.net[2], self.norm3
        kernel = self.use_pallas_ffn is not False
        if kernel and not ffn.kernel_takes(x.shape[-1], 4 * x.shape[-1]):
            # JAX's guard (fits_vmem) sends this width to the unfused path
            ffn.plain_calls += 1
            kernel = False
        if self.mesh is not None:
            return ffn.ffn_sublayer_tp(x, norm.weight, norm.bias, proj.weight, proj.bias,
                                       out.weight, out.bias, self.mesh, norm.eps, kernel=kernel)
        if not kernel:
            return ffn.ln_geglu_ffn_reference(x, norm.weight, norm.bias, proj.weight.t(),
                                              proj.bias, out.weight.t(), out.bias, norm.eps)
        # the fp32 master weights in parameter layout: the op casts them
        # itself, so their gradients come back in fp32
        return ffn.ffn_sublayer(x, norm.weight, norm.bias, proj.weight, proj.bias,
                                out.weight, out.bias, norm.eps)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 conv in -> token transformer -> 1x1 zero conv out
    + residual. NCHW in and out; [B, H*W, C] tokens inside. ``mesh``: the
    blocks' model axis (the convs and the norm are replicated).

    ``remat``: while autograd records, each block runs under a
    non-reentrant ``torch.utils.checkpoint``, so its activations are
    recomputed in the backward rather than kept (JAX's ``nn.remat``): the
    block's kernels and, under a model axis, its forward collectives run
    again, on every rank in the same order. The recompute takes the same
    inputs through the same deterministic kernels, so the gradients are
    bitwise those without it."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None,
                 attn1_cross: bool = True, dtype: torch.dtype = torch.bfloat16,
                 use_pallas_ffn: Optional[bool] = None, fold_context: bool = False,
                 sow_attn: bool = False, mesh=None, fast_softmax: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels)
        self.proj_in = Conv2D(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  attn1_cross, dtype, use_pallas_ffn, fold_context, sow_attn,
                                  mesh, fast_softmax)
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
        remat = self.remat and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            x = checkpoint(block, x, context, use_reentrant=False) if remat else block(x, context)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in
