"""Character conditioning encoder and the writer-style projection (port of
``worddiffusion_tpu/models/encoders.py``).

``WordAttention`` is single-head attention with no 1/sqrt(d) scaling
and biased q/k/v projections, as the reference trained it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, char_positional_encoding


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is a one-hot matmul, summed
    in a fixed order. On CUDA the stock embedding backward adds repeated
    ids with atomics, in an order that changes from run to run: on an
    H100 it was the one gradient that broke the trainer's bitwise resume
    (the char ids repeat the pad token across the whole batch)."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        onehot = F.one_hot(ids.reshape(-1), ctx.num).to(grad.dtype)
        return None, onehot.t() @ grad.reshape(-1, grad.shape[-1])


class WordAttention(nn.Module):
    """Single-head, unscaled self-attention; scores and softmax in fp32."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.linear_query = Dense(hidden_size, hidden_size)
        self.linear_key = Dense(hidden_size, hidden_size)
        self.linear_value = Dense(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.linear_query(x)
        k = self.linear_key(x)
        v = self.linear_value(x)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        p = scores.softmax(dim=-1).to(v.dtype)
        return torch.matmul(p.float(), v.float()).to(v.dtype)


class CharacterEncoder(nn.Module):
    """Char-id embedding + sinusoidal position + WordAttention. The
    positional encoding is skipped when the sequence is longer than
    ``max_seq_len``, as in the reference."""

    def __init__(self, vocab_size: int, hidden_size: int, max_seq_len: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.max_seq_len = max_seq_len
        self.embedding = nn.Embedding(vocab_size, hidden_size)
        self.attention = WordAttention(hidden_size)
        self.register_buffer(
            "pe", char_positional_encoding(max_seq_len, hidden_size), persistent=False
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, L] int -> [B, L, hidden] in ``dtype``."""
        emb = _Lookup.apply(ids, self.embedding.weight).to(self.dtype)
        L = ids.shape[1]
        if L <= self.max_seq_len:
            emb = emb + self.pe[:L].to(emb.dtype)
        return self.attention(emb)


class StyleProjection(Dense):
    """Writer-style feature vector -> context tokens (reference ``wrd_proj``,
    ``unet.py:1243``): [B, D] -> one token [B, 1, context_dim]; [B, S, D]
    -> S tokens."""

    def forward(self, style_vec: torch.Tensor) -> torch.Tensor:
        out = super().forward(style_vec)
        return out if out.dim() == 3 else out[:, None, :]
