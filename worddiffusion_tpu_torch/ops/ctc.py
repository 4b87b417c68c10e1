"""CTC loss and greedy CTC decoding (port of ``worddiffusion_tpu/ops/ctc.py``).

``ctc_loss`` is the counterpart of ``optax.ctc_loss`` as the JAX package
calls it: each sequence's negative log-likelihood of its labels under the
softmax of raw logits, [B], with no reduction (the training step takes
the mean over the batch, as JAX's ``jnp.mean(optax.ctc_loss(...))``;
``F.ctc_loss``'s default ``reduction="mean"`` would also divide by the
label lengths). It is the alpha recursion over the 2N+1 blank-extended
labels written in tensor ops: the per-frame log-probabilities of the
extended labels come from one one-hot matmul, every frame is a shift, a
masked skip and a logsumexp, and the final states are picked with a
one-hot mask. No gather, scatter or atomic add, so on a GPU the loss and
its gradient repeat bit for bit (``F.ctc_loss``'s CUDA backward is
documented as non-deterministic, and the trainer's resume is bitwise).
Like optax, "log 0" is the finite ``LOG_EPSILON``: labels that no
alignment can produce (more frames needed than there are) give a large
finite loss (about ``-LOG_EPSILON`` per impossible transition) and finite
gradients, where ``F.ctc_loss`` gives ``inf``.

The greedy decode's argmax runs on the device, the string assembly on the
host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # optax.ctc_loss's log(+0)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 1) -> torch.Tensor:
    """logits [B, T, K] (raw; log-softmax is taken here, in fp32), labels
    [B, N] int (right-padded), label_lengths [B] -> the per-sequence
    negative log-likelihood [B] fp32. Every frame of every sequence counts
    (no logit padding, as in the JAX step)."""
    b, n_frames, k = logits.shape
    n = labels.shape[1]
    dev = logits.device
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    # extended labels: blank, l1, blank, l2, ..., lN, blank
    ext = torch.full((b, 2 * n + 1), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    onehot = (ext[..., None] == torch.arange(k, device=dev)).float()         # [B, S, K]
    lp = torch.bmm(logprobs, onehot.transpose(1, 2)).transpose(0, 1)        # [T, B, S]
    # the skip s-2 -> s: only onto a label that differs from the one before it
    skip = torch.zeros_like(ext, dtype=torch.float32)
    skip[:, 3::2] = (labels[:, 1:] == labels[:, :-1]).float()
    skip[:, 0::2] = 1.0
    skip[:, 1] = 1.0
    skip = skip * LOG_EPSILON
    alpha = torch.full((b, 2 * n + 1), LOG_EPSILON, device=dev)
    alpha[:, 0] = 0.0
    for t in range(n_frames):
        one = F.pad(alpha[:, :-1], (1, 0), value=LOG_EPSILON)
        two = F.pad(alpha[:, :-2], (2, 0), value=LOG_EPSILON) + skip
        alpha = torch.logsumexp(torch.stack([alpha, one, two]), dim=0) + lp[t]
    # the last label or the blank after it
    s = torch.arange(2 * n + 1, device=dev)
    end = 2 * label_lengths.long()[:, None]
    final = ((s == end) | (s == end - 1)).float()
    return -torch.logsumexp(alpha + (1.0 - final) * LOG_EPSILON, dim=-1)


def encode_ocr_labels(
    words: Sequence[str], alphabet: str, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Words -> (ids [B, max_len], lengths [B]) for ctc_loss targets.

    Copied from ``worddiffusion_tpu/ops/ctc.py::encode_ocr_labels`` (that
    module imports jax and optax). Characters not in the alphabet are
    skipped.
    """
    index = {c: i for i, c in enumerate(alphabet)}
    ids = np.zeros((len(words), max_len), np.int32)
    lens = np.zeros((len(words),), np.int32)
    for b, w in enumerate(words):
        seq = [index[c] for c in w if c in index][:max_len]
        ids[b, : len(seq)] = seq
        lens[b] = len(seq)
    return ids, lens


def greedy_frame_ids(logits: torch.Tensor) -> torch.Tensor:
    """[B, T, K] -> [B, T] int32 argmax ids (device side)."""
    return logits.argmax(dim=-1).to(torch.int32)


def collapse_and_decode(
    frame_ids: np.ndarray, alphabet: str, blank: str = "_"
) -> list[str]:
    """Host-side: collapse adjacent repeats, map to chars, drop blanks.

    Copied from ``worddiffusion_tpu/ops/ctc.py::collapse_and_decode``
    (that module imports jax and optax). Repeats are collapsed *before*
    blank removal, as in the reference decode loop.
    """
    out = []
    for row in np.asarray(frame_ids):
        prev = None
        chars = []
        for t in row:
            t = int(t)
            if t != prev:
                chars.append(alphabet[t] if t < len(alphabet) else "")
            prev = t
        out.append("".join(chars).replace(blank, "").strip())
    return out
