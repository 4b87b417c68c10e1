#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (worddiffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: needs CUDA; prints the card's nvidia-smi name and power limit;
   TF32 off for the comparisons.
2. build: compiles the CUDA kernels from ``worddiffusion_tpu_torch/csrc``.
3. kernel vs plain: the fused LN + GEGLU FFN kernel against its plain
   PyTorch version at the main path's shapes (d=320, inner=1280,
   M = 16*256, 16*64) and a ragged M, with errors and median times.
4. whole UNet: one full-width ``iam`` UNet call with every kernel against
   the all-plain UNet (``use_pallas_ffn=False`` and the plain attention
   swapped in) on the same weights and inputs; call times with all
   kernels, with the FF kernel and the plain attention, and all plain.
5. main path: the regeneration CLI's pipeline (Regenerator + WordSampler,
   ``iam`` UNet, default VAE and CTC recognizer, seeded random weights)
   over 40 words in batches of 16, with the 600-step skip-step schedule
   and the deterministic update; checks shapes, finiteness, the PNGs and
   that every FF sub-layer and every attention went through its kernel;
   then single batches with the attention kernel and with the plain
   attention in turns, for s/batch with and without it.
6. FFN forward + backward, kernel against plain: the forward and the
   backward kernel against their plain versions at the training shapes,
   M = 128*256, 128*64 and a ragged 1000 (the output and seven
   gradients, each within its tolerance), bitwise repeatability, and the
   autograd Function (both kernels) against plain autograd at the two
   training M (output and gradients), with median times.
7. training main path: the train CLI's Trainer (``iam`` preset at full
   width, B=128, seeded random weights) on a latent cache of seeded
   latents, 2 epochs with a checkpoint and a DDIM-50 preview each; then
   a max_steps stop and a resume. Checks the loss, the update, the EMA,
   4 backward-kernel launches per step, the checkpoint round trip, that
   the EMA loads as the regeneration UNet and that the resumed run is
   bitwise the uninterrupted one; times s/step with the kernels and with
   the plain FF. Every attention runs the attention kernel forward (8 per
   step and per preview call) and its Function's plain backward (8 per
   step).
8. attention kernel vs plain: the fused attention against its plain
   version at the shapes of every path (4 heads of 80; regeneration B=16
   and training B=128; Nq 256 and 64; Nk 42 for ``iam``, Nq for the
   self-attention and 42 + 769 = 811 for the cross-attention of
   ``iam_phosc``) and a ragged case, with errors and median times; the
   Function's output and gradients against plain autograd at B=128,
   Nq=256, Nk=811.
9. ``iam_phosc`` regeneration: the regeneration CLI with ``--preset
   iam_phosc`` (self-attention, then cross-attention over the characters
   and the PHOSC tokens), seeded random weights: one UNet call all-kernel
   against all-plain, then the pipeline as in phase 5, 4 FF and 8
   attention launches per call, and single batches in turns as there.
10. ``iam_phosc`` training: the train CLI with ``--preset iam --phosc 1``
   at full width, B=128, on the seeded latent cache: 2 epochs of 10 steps
   with one checkpoint and one DDIM-50 preview at the end; checks the
   loss, that q/k/v and the PHOSC path's encoder were updated, 8
   attention backward calls and 4 FF backward launches per step; s/step.
11. fold attention kernel vs plain: the context-folded attention sub-layer
   (``ops.fold_attention``) in both entry layouts (B.7's folds [B, C, H*L],
   B.8's per-head [B, H, C, L]) against its plain version at the fold
   path's shapes (C=320, H=4, L=42; B 16 and 128; N 256 and 64) and a
   ragged one, bitwise repeatability, and the Function's gradients
   against plain autograd; kernel, plain and bound times.
12. fold regeneration: the regeneration CLI with ``--preset iam_fold``
   (``iam`` with ``attn_fold_context``, registered in the port's presets):
   one UNet call with the fold kernel against the plain fold, and against
   the unfolded ``iam`` UNet on the same weights; then the pipeline as in
   phase 5 with 8 fold, 0 attention and 4 FF launches per call; single
   batches with the fold kernel and the plain fold in turns.
13. fold training: the train CLI with ``--preset iam_fold`` at B=128 on
   the phase-7 latent corpus, 2 epochs of 10 steps, twice: 8 fold
   launches, 8 fold backward calls and 4 FF backward launches per step,
   the two runs bitwise equal; s/step and peak memory.

The second-to-last line is a JSON summary of the kernels (each with its
bound: the larger of its bytes over the card's memory rate and its
operations over its bf16 tensor rate, from the published H100 SXM
figures); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from unittest import mock

D, INNER, B = 320, 1280, 16
FFN_SHAPES = (B * 256, B * 64, 1000)   # M: full-res blocks, middle block, ragged
TRAIN_B = 128
BWD_SHAPES = (TRAIN_B * 256, TRAIN_B * 64, 1000)
TRAIN_STEPS_PER_EPOCH = 10
GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
# bf16 keeps 8 significant bits (one rounding = 0.4% of a value). The kernel
# keeps the [M, 2*inner] hidden in fp32 where the plain version rounds the
# matmul output to bf16, so the two differ by a few ulps of the output.
FFN_REL_TOL = 1e-2
# One such difference per FF sub-layer (4 per call), carried through the
# bf16 layers after it: bound the eps difference at 3% of max |eps|.
UNET_REL_TOL = 3e-2
# The plain backward rounds dact, dxn and the weight gradients to bf16 (its
# matmuls run in bf16); the kernel keeps them fp32: a few bf16 ulps of each
# gradient's max (0.6% measured), bounded at 2%.
BWD_REL_TOL = 2e-2
HEADS, D_HEAD = 4, 80
# (B, Nq, Nk) of every attention the paths run, and a ragged case
ATTN_SHAPES = (
    (B, 256, 42), (B, 64, 42),                                # iam regeneration
    (B, 256, 256), (B, 64, 64), (B, 256, 811), (B, 64, 811),  # iam_phosc regeneration
    (TRAIN_B, 256, 42), (TRAIN_B, 64, 42),                    # iam training
    (TRAIN_B, 256, 256), (TRAIN_B, 64, 64),                   # iam_phosc training
    (TRAIN_B, 256, 811), (TRAIN_B, 64, 811),
    (2, 40, 13),                                              # ragged Nq and Nk
)
# bf16 output: the kernel and the plain version differ in the order of the
# fp32 sums, which can move one bf16 rounding of p or of the output (0.4%
# of a value); bound at 1% of max |plain|.
ATTN_REL_TOL = 1e-2
# (B, N, L) of the fold path's sub-layers (C=320, H=4): regeneration B=16 and
# training B=128 at the full-resolution (N=256) and middle (N=64) blocks,
# and a ragged case (L=13 pads to 16, N=40 ends mid-tile)
FOLD_SHAPES = ((B, 256, 42), (B, 64, 42), (TRAIN_B, 256, 42), (TRAIN_B, 64, 42), (2, 40, 13))
# As for the attention: the kernel and the plain version differ in the order
# of the fp32 sums (the heads accumulate in one register tile), which can move
# one bf16 rounding of p or of the output: 1% of max |plain|.
FOLD_REL_TOL = 1e-2
# Folded vs unfolded UNet on the same weights: the same math re-associated,
# with one more bf16 rounding of the folds and of the sub-layer's output per
# attention (JAX's test_folded_matches_reference_bf16 allows 4e-2 for one
# attention); bound the eps difference at 4% of max |eps|.
FOLD_VS_UNFOLDED_TOL = 4e-2
# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms the card could take for work that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``flops`` bf16 tensor operations, and which of the two bounds it."""
    mem, ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_attention():
    """Every UNet attention, folded or not, through its plain version: the
    all-plain reference and the "before the kernel" timings."""
    from worddiffusion_tpu_torch.ops import attention, fold_attention

    with mock.patch.object(attention, "fused_attention", attention.attention_reference), \
            mock.patch.object(fold_attention, "fold_attention_heads",
                              fold_attention.fold_attention_reference):
        yield


def attn_inputs(b: int, nq: int, nk: int, seed: int):
    """Seeded bf16 q, k, v [b, 4, n, 80] with unit-scale entries, as the
    projections of LayerNormed tokens give them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, HEADS, n, D_HEAD, generator=g).bfloat16().cuda()
                 for n in (nq, nk, nk))


def phase8_attention(smi: str) -> dict:
    """The attention kernel against its plain version at every path's
    shapes, and the Function against plain autograd."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import attention

    scale = D_HEAD ** -0.5
    rows = []
    for i, (b, nq, nk) in enumerate(ATTN_SHAPES):
        q, k, v = attn_inputs(b, nq, nk, seed=30 + i)
        got = attention.fused_attention(q, k, v, scale)
        again = attention.fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        want = attention.attention_reference(q, k, v, scale)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = cuda_ms(lambda: attention.fused_attention(q, k, v, scale))
        plain_ms = cuda_ms(lambda: attention.attention_reference(q, k, v, scale))
        # the yardstick: one PyTorch call of the same function (the port never calls it)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        bound_ms, bound_by = bound(nbytes(q, k, v, got), 4 * b * HEADS * nq * nk * D_HEAD)
        log(f"attention B={b} H={HEADS} Nq={nq} Nk={nk} D={D_HEAD}: max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {ATTN_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"scaled_dot_product_attention {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite attention at {b, nq, nk}"
        assert torch.equal(got, again), f"attention differs between two runs at {b, nq, nk}"
        assert rel <= ATTN_REL_TOL, f"attention kernel disagrees at {b, nq, nk}: rel {rel}"
        rows.append(dict(b=b, nq=nq, nk=nk, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))

    # The Function (kernel forward, plain-recompute backward) against plain
    # autograd at the widest training shape: output and q, k, v gradients.
    b, nq, nk = TRAIN_B, 256, 811
    q, k, v = attn_inputs(b, nq, nk, seed=60)
    dout = (0.1 * torch.randn(b, HEADS, nq, D_HEAD, generator=torch.Generator().manual_seed(61)))
    dout = dout.bfloat16().cuda()

    def fwd_bwd(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, scale)
        out.backward(dout)
        return [out.detach()] + [t.grad for t in leaves]

    n0 = attention.bwd_calls
    got, want = fwd_bwd(attention.fused_attention), fwd_bwd(attention.attention_reference)
    torch.cuda.synchronize()
    assert attention.bwd_calls == n0 + 1
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        err = (g.float() - w.float()).abs().max().item()
        share = err / w.float().abs().max().item()
        log(f"attention Function vs plain autograd B={b} Nq={nq} Nk={nk} {name}: max_abs_err "
            f"{err:.6g} share of max |plain| {share:.6g} (tol {ATTN_REL_TOL}); "
            f"bitwise {torch.equal(g, w)}")
        assert g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all()), name
        assert share <= ATTN_REL_TOL, f"attention Function disagrees: {name} {share}"
    pair_ms = cuda_ms(lambda: fwd_bwd(attention.fused_attention), reps=10)
    plain_pair_ms = cuda_ms(lambda: fwd_bwd(attention.attention_reference), reps=10)
    log(f"attention fwd+bwd B={b} Nq={nq} Nk={nk}: Function {pair_ms:.4f} ms, plain autograd "
        f"{plain_pair_ms:.4f} ms [{smi}]")
    return dict(rows=rows, pair_ms=pair_ms, plain_pair_ms=plain_pair_ms)


def ffn_inputs(m: int, seed: int):
    """Seeded inputs scaled like the model's: a unit-scale residual stream,
    LayerNorm affine near identity, lecun-scaled weights."""
    import torch

    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(
        x=r(m, D).bfloat16(), gamma=1 + 0.1 * r(D), beta=0.1 * r(D),
        w1=(r(D, 2 * INNER) / D ** 0.5).bfloat16(), b1=0.02 * r(2 * INNER),
        w2=(r(INNER, D) / INNER ** 0.5).bfloat16(), b2=0.02 * r(D),
    )
    return {k: v.cuda() for k, v in t.items()}


def bwd_inputs(m: int, seed: int):
    """Kernel-layout inputs of the backward (bf16 x, dy and weights)."""
    import torch

    t = ffn_inputs(m, seed)
    t.pop("b2")
    g = torch.Generator().manual_seed(seed + 100)
    t["dy"] = (0.1 * torch.randn(m, D, generator=g)).bfloat16().cuda()
    return {k: t[k] for k in ("x", "dy", "gamma", "beta", "w1", "b1", "w2")}


def ffn_bound(inputs: dict, out) -> tuple[float, str]:
    """The forward's bound: its inputs and output, and the two products
    x W1 [M, d] x [d, 2 inner] and act W2 [M, inner] x [inner, d]."""
    m = inputs["x"].shape[0]
    return bound(nbytes(*inputs.values(), out), 6 * m * D * INNER)


def phase6_ffn_backward(smi: str) -> dict:
    """The forward and backward kernels against their plain versions at
    the training shapes, the backward's repeatability, and the Function
    (both kernels) against plain autograd."""
    import torch

    from worddiffusion_tpu_torch.ops import ffn

    rows, fwd_rows = [], []
    for i, m in enumerate(BWD_SHAPES):
        f = ffn_inputs(m, seed=10 + i)
        got = ffn.fused_ln_geglu_ffn(**f)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_reference(**f)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = cuda_ms(lambda: ffn.fused_ln_geglu_ffn(**f), reps=20)
        plain_ms = cuda_ms(lambda: ffn.ln_geglu_ffn_reference(**f), reps=20)
        bound_ms, bound_by = ffn_bound(f, got)
        log(f"ffn fwd M={m}: max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {FFN_REL_TOL}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
            f"[{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at M={m}"
        assert rel <= FFN_REL_TOL, f"forward kernel disagrees with plain at M={m}: rel {rel}"
        fwd_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
        del f, got, want

        a = bwd_inputs(m, seed=10 + i)
        got = ffn.ln_geglu_ffn_bwd(**a)
        again = ffn.ln_geglu_ffn_bwd(**a)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_bwd_reference(**a)
        errs = []
        for name, g, w, g2 in zip(GRADS, got, want, again):
            assert bool(torch.isfinite(g.float()).all()), f"non-finite {name} at M={m}"
            assert torch.equal(g, g2), f"{name} differs between two runs at M={m}"
            err = (g.float() - w.float()).abs().max().item()
            share = err / w.float().abs().max().item()
            errs.append(err)
            log(f"ffn bwd M={m} {name}: max_abs_err {err:.6g} share of max |plain| "
                f"{share:.6g} (tol {BWD_REL_TOL}); bitwise repeatable")
            assert share <= BWD_REL_TOL, f"backward kernel disagrees at M={m}: {name} {share}"
        ms = cuda_ms(lambda: ffn.ln_geglu_ffn_bwd(**a), reps=20)
        plain_ms = cuda_ms(lambda: ffn.ln_geglu_ffn_bwd_reference(**a), reps=20)
        # the backward recomputes h = LN(x) W1 and does four more products of
        # the same size: 16 M d inner operations in all
        bound_ms, bound_by = bound(nbytes(*a.values(), *got), 16 * m * D * INNER)
        log(f"ffn bwd M={m}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}) [{smi}]")
        rows.append(dict(m=m, err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))

    # The autograd Function (forward + backward kernels) against plain
    # autograd of the plain forward, on fp32 master weights in parameter
    # layout, as the UNet's FF sub-layer calls it; output and gradients.
    order = ("gamma", "beta", "w1", "b1", "w2", "b2")
    for m in BWD_SHAPES[:2]:
        a = ffn_inputs(m, seed=20)
        p = {k: a[k].float() for k in ("gamma", "beta", "b1", "b2")}
        p["w1"] = a["w1"].float().t().contiguous()  # proj.weight [2*inner, d]
        p["w2"] = a["w2"].float().t().contiguous()  # out.weight [d, inner]
        dy = (0.1 * torch.randn(m, D, generator=torch.Generator().manual_seed(21))).bfloat16()
        dy = dy.cuda()

        def fwd_bwd(kernel: bool):
            x = a["x"].clone().requires_grad_()
            lv = {k: p[k].clone().requires_grad_() for k in order}
            if kernel:
                out = ffn.LnGegluFFN.apply(x, lv["gamma"], lv["beta"], lv["w1"], lv["b1"],
                                           lv["w2"], lv["b2"], 1e-5)
            else:
                out = ffn.ln_geglu_ffn_reference(x, lv["gamma"], lv["beta"], lv["w1"].t(),
                                                 lv["b1"], lv["w2"].t(), lv["b2"])
            out.backward(dy)
            return [out.detach(), x.grad] + [lv[k].grad for k in order]

        (out_k, *got), (out_p, *want) = fwd_bwd(True), fwd_bwd(False)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        rel = err / out_p.float().abs().max().item()
        log(f"ffn Function vs plain autograd M={m} out: max_abs_err {err:.6g} max_rel_err "
            f"{rel:.6g} (tol {FFN_REL_TOL})")
        assert rel <= FFN_REL_TOL, f"Function output disagrees with plain at M={m}: rel {rel}"
        for name, g, w in zip(GRADS[:3] + ("dw1 [2*inner, d]", "db1", "dw2 [d, inner]", "db2"),
                              got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            err = (g.float() - w.float()).abs().max().item()
            share = err / w.float().abs().max().item()
            log(f"ffn Function vs plain autograd M={m} {name}: max_abs_err {err:.6g} share "
                f"{share:.6g} (tol {BWD_REL_TOL})")
            assert share <= BWD_REL_TOL, f"Function disagrees at M={m}: {name} {share}"
        if m == BWD_SHAPES[0]:
            pair_ms = cuda_ms(lambda: fwd_bwd(True), reps=20)
            plain_pair_ms = cuda_ms(lambda: fwd_bwd(False), reps=20)
            log(f"ffn fwd+bwd M={m}: kernel pair {pair_ms:.4f} ms, plain autograd "
                f"{plain_pair_ms:.4f} ms [{smi}]")
    return dict(rows=rows, fwd_rows=fwd_rows, pair_ms=pair_ms, plain_pair_ms=plain_pair_ms)


def write_latent_corpus(work: str, n: int) -> tuple[str, str]:
    """A gt file of n words and a latent-cache npz of seeded latents."""
    import numpy as np

    words = ("the of and to in is was that for it with as his on be at by had are "
             "but from not this have which one were all they she you her an there").split()
    rng = np.random.default_rng(0)
    gt = os.path.join(work, "train.filter27")
    latents = {}
    with open(gt, "w") as f:
        for i in range(n):
            name = f"a01-{i:04d}u-00"
            f.write(f"{i % 300:03d},{name} {words[i % len(words)]}\n")
            latents[name + ".png"] = (0.8 * rng.standard_normal((8, 32, 4))).astype(np.float32)
    cache = os.path.join(work, "latents.npz")
    np.savez(cache, **latents)
    return gt, cache


def phase7_train(smi: str, work: str, corpus: tuple[str, str]) -> dict:
    """The training main path as the train CLI builds it."""
    import dataclasses

    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import attention, ffn
    from worddiffusion_tpu_torch.train.checkpoint import CheckpointManager
    from worddiffusion_tpu_torch.train.loop import Trainer
    from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer

    gt, cache = corpus
    epochs, steps = 2, 2 * TRAIN_STEPS_PER_EPOCH

    def cli_args(save: str, *extra: str):
        return train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", gt, "--latent_cache", cache,
            "--batch_size", str(TRAIN_B), "--epochs", str(epochs), "--ckpt_every_epochs", "1",
            "--save_path", os.path.join(work, save), "--seed", "0", "--device", "cuda", *extra,
        ])

    trainer = train_cli.build(cli_args("run"))
    assert trainer.exp.train.ema_warmup_steps > steps
    assert trainer.exp.unet.use_pallas_ffn is None  # the kernels' path
    preview_launches, preview_attn, preview_fold = count_previews(trainer)
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}

    ffn.launches = ffn.bwd_launches = attention.launches = attention.bwd_calls = 0
    t0 = time.perf_counter()
    state = trainer.run(epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = ffn.launches, ffn.bwd_launches
    attn, attn_bwd = attention.launches, attention.bwd_calls

    ck = CheckpointManager(trainer.ckpt.directory)
    saved = torch.load(ck.path(steps), map_location="cpu", weights_only=True)
    loss = saved["metrics"]["loss"]
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    ff_keys = [k for k in changed if ".ff.net." in k and k.endswith("weight")]
    ema_equal = all(torch.equal(e, p) for e, p in
                    zip(state.ema.parameters(), state.model.parameters()))
    log(f"train: {state.step} steps of B={TRAIN_B} in {wall:.2f} s incl. 2 checkpoints and "
        f"2 DDIM-50 previews; epoch-1 loss {loss:.6g}; "
        f"ffn launches: {bwd} backward, {fwd - sum(preview_launches)} forward in steps, "
        f"{preview_launches} forward in previews; attention launches: "
        f"{attn - sum(preview_attn)} in steps, {preview_attn} in previews, {attn_bwd} Function "
        f"backward calls; max param change {max(changed.values()):.4g}; EMA == params: {ema_equal}")
    assert state.step == steps, state.step
    assert sorted(ck.steps()) == [TRAIN_STEPS_PER_EPOCH, steps], ck.steps()
    assert torch.isfinite(torch.tensor(loss)), loss
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert all(changed[k] > 0 for k in ff_keys) and len(ff_keys) == 8, ff_keys
    assert ema_equal, "the EMA must equal the parameters during warmup"
    assert bwd == 4 * steps, bwd
    assert preview_launches == [4 * 50] * 2, preview_launches
    assert fwd - sum(preview_launches) == 4 * steps, fwd
    assert preview_attn == [8 * 50] * 2 and preview_fold == [0, 0], (preview_attn, preview_fold)
    assert attn - sum(preview_attn) == 8 * steps and attn_bwd == 8 * steps, (attn, attn_bwd)
    pngs = sorted(os.listdir(os.path.join(work, "run", "images")))
    assert pngs == ["epoch_0000.png", "epoch_0001.png"], pngs
    assert png_size(os.path.join(work, "run", "images", pngs[0])) == (3 * 256, 64)

    # restore into a fresh state: bitwise the saved one
    fresh = UNet(trainer.exp.unet).cuda()
    restored = ck.restore(TrainState.create(fresh, make_optimizer(fresh.parameters(), 1e-4)))
    sa, sb = restored.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    assert restored.step == state.step
    assert all(torch.equal(a, b) for a, b in zip(restored.model.parameters(),
                                                 state.model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(restored.ema.parameters(),
                                                 state.ema.parameters()))
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    # the EMA loads as the regeneration CLI's --torch_ckpt
    regen_unet = UNet(trainer.exp.unet)
    regen_unet.load_state_dict(torch.load(ck.path(steps, "ema_unet.pt"), map_location="cpu",
                                          weights_only=True), strict=True)
    log("train: restored state bitwise equal to the saved one; EMA loads as the "
        "regeneration UNet")

    # the same steps with the plain FF, for s/step
    plain = Trainer(trainer.exp.replace(unet=dataclasses.replace(
        trainer.exp.unet, use_pallas_ffn=False), train=dataclasses.replace(
        trainer.exp.train, save_path=os.path.join(work, "plain"))), trainer.dataset,
        device="cuda")
    b0 = ffn.bwd_launches
    plain_state = plain.run(epochs=epochs)
    torch.cuda.synchronize()
    assert ffn.bwd_launches == b0 and plain_state.step == steps
    k_s, k_n = trainer.epoch_seconds[1]
    p_s, p_n = plain.epoch_seconds[1]
    log(f"train epoch 1 ({k_n} steps, B={TRAIN_B}): kernel FF {k_s / k_n:.4f} s/step "
        f"{k_n / k_s:.3f} steps/s; plain FF {p_s / p_n:.4f} s/step {p_n / p_s:.3f} steps/s "
        f"[{smi}]")

    # a max_steps stop, then a resume, against the uninterrupted run
    kill_at = TRAIN_STEPS_PER_EPOCH + 3
    part = train_cli.build(cli_args("resume")).run(epochs=epochs, max_steps=kill_at)
    assert part.step == kill_at, part.step
    resumed = train_cli.build(cli_args("resume", "--loadPrev", "1")).run(
        epochs=epochs, resume=True)
    assert resumed.step == steps, resumed.step
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    scale = max(p.abs().max().item() for p in state.model.parameters())
    log(f"train resume: stopped at step {kill_at}, resumed to {resumed.step}; max param diff "
        f"vs the uninterrupted run {diff:.6g} (max |param| {scale:.4g}); must be bitwise 0")
    assert diff == 0, f"the resumed run is not bitwise the uninterrupted one: {diff}"
    return dict(fwd=fwd, bwd=bwd, attn=attn, s_per_step=k_s / k_n,
                plain_s_per_step=p_s / p_n, resume_diff=diff)


def count_previews(trainer) -> tuple[list, list, list]:
    """Wrap the trainer's preview: per preview, the FF, attention and fold
    attention kernel launches it made (kept apart from the steps' own), and
    its images checked."""
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    ffn_n, attn_n, fold_n = [], [], []
    preview = trainer.preview_fn

    def counted_preview(state, epoch):
        f0, a0, d0 = ffn.launches, attention.launches, fold_attention.launches
        imgs = preview(state, epoch)
        ffn_n.append(ffn.launches - f0)
        attn_n.append(attention.launches - a0)
        fold_n.append(fold_attention.launches - d0)
        assert imgs.shape == (3, 64, 256, 3) and bool((imgs >= 0).all() & (imgs <= 1).all())
        return imgs

    trainer.preview_fn = counted_preview
    return ffn_n, attn_n, fold_n


def phase10_phosc_train(smi: str, work: str, corpus: tuple[str, str]) -> dict:
    """The PHOSC model's training as the train CLI builds it from
    ``--preset iam --phosc 1``."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.ops import attention, ffn
    from worddiffusion_tpu_torch.train.checkpoint import CheckpointManager

    gt, cache = corpus
    epochs, steps = 2, 2 * TRAIN_STEPS_PER_EPOCH
    trainer = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "iam", "--phosc", "1", "--gt_train", gt, "--latent_cache", cache,
        "--batch_size", str(TRAIN_B), "--epochs", str(epochs), "--ckpt_every_epochs", "2",
        "--save_path", os.path.join(work, "run_phosc"), "--seed", "0", "--device", "cuda",
    ]))
    cfg = trainer.exp.unet
    assert trainer.exp.name == "iam_phosc" and cfg.use_phosc and not cfg.attn1_cross
    assert cfg.model_channels == 320 and trainer.dataset[0]["phosc"].shape == (769,)
    preview_ffn, preview_attn, _ = count_previews(trainer)
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}

    ffn.launches = ffn.bwd_launches = attention.launches = attention.bwd_calls = 0
    t0 = time.perf_counter()
    state = trainer.run(epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = ffn.launches, ffn.bwd_launches
    attn, attn_bwd = attention.launches, attention.bwd_calls

    ck = CheckpointManager(trainer.ckpt.directory)
    loss = torch.load(ck.path(steps), map_location="cpu", weights_only=True)["metrics"]["loss"]
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    qkv = [k for k in changed if any(f".attn{i}.to_{w}." in k for i in (1, 2) for w in "qkv")]
    s_, n_ = trainer.epoch_seconds[1]
    log(f"train iam_phosc: {state.step} steps of B={TRAIN_B} in {wall:.2f} s incl. 1 checkpoint "
        f"and 1 DDIM-50 preview; last-epoch loss {loss:.6g}; attention launches "
        f"{attn - sum(preview_attn)} in steps, {preview_attn} in the preview, {attn_bwd} Function "
        f"backward calls; ffn launches {fwd - sum(preview_ffn)} forward and {bwd} backward in "
        f"steps; epoch 1 {s_ / n_:.4f} s/step {n_ / s_:.3f} steps/s [{smi}]")
    assert state.step == steps and ck.steps() == [steps], (state.step, ck.steps())
    assert torch.isfinite(torch.tensor(loss)), loss
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert len(qkv) == 4 * 2 * 3 and all(changed[k] > 0 for k in qkv), qkv
    assert changed["word_emb.embedding.weight"] > 0
    assert attn - sum(preview_attn) == 8 * steps and attn_bwd == 8 * steps, (attn, attn_bwd)
    assert preview_attn == [8 * 50] and preview_ffn == [4 * 50], (preview_attn, preview_ffn)
    assert fwd - sum(preview_ffn) == 4 * steps and bwd == 4 * steps, (fwd, bwd)
    return dict(fwd=fwd, bwd=bwd, attn=attn, s_per_step=s_ / n_)


def fold_inputs(b: int, n: int, l: int, seed: int) -> dict:
    """Seeded sub-layer inputs scaled like the model's: a unit-scale residual
    stream, LayerNorm affine near identity, folds that give unit-scale
    scores and outputs (B.8's per-head layout), small biases."""
    import torch

    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(x=r(b, n, D).bfloat16(), wt4=(r(b, HEADS, D, l) / D ** 0.5).bfloat16(),
             vw4=r(b, HEADS, l, D).bfloat16(), gamma=1 + 0.1 * r(D), beta=0.1 * r(D),
             b_out=0.02 * r(D))
    return {k: v.cuda() for k, v in t.items()}


def phase11_fold(smi: str) -> dict:
    """The fold attention kernel against its plain version at the fold
    path's shapes, through both entries (B.8's per-head folds and B.7's
    [B, C, H*L] folds), and the Function against plain autograd."""
    import torch

    from worddiffusion_tpu_torch.ops import fold_attention as fa

    rows = []
    for i, (b, n, l) in enumerate(FOLD_SHAPES):
        t = fold_inputs(b, n, l, seed=70 + i)
        vecs = (t["gamma"], t["beta"], t["b_out"])
        # B.7's layout of the same folds: wt [B, C, H*L] (a copy), vw [B, H*L, C] (the same memory)
        wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, D, HEADS * l).contiguous()
        vw = t["vw4"].view(b, HEADS * l, D)

        def per_head():
            return fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)

        def flat():
            return fa.fold_attention(t["x"], wt, vw, *vecs, HEADS)

        def plain():
            return fa.fold_attention_reference(t["x"], t["wt4"], t["vw4"], *vecs)

        n0 = fa.launches
        got, again, got7 = per_head(), per_head(), flat()
        torch.cuda.synchronize()
        assert fa.launches == n0 + 3, fa.launches - n0
        want = plain()
        err = max((g.float() - want.float()).abs().max().item() for g in (got, got7))
        rel = err / want.float().abs().max().item()
        ms, ms7, plain_ms = cuda_ms(per_head), cuda_ms(flat), cuda_ms(plain)
        bound_ms, bound_by = bound(nbytes(*t.values(), got), 4 * b * n * D * HEADS * l)
        log(f"fold attention B={b} N={n} C={D} H={HEADS} L={l}: max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {FOLD_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; B.7 layout == B.8 layout {torch.equal(got, got7)}; "
            f"kernel {ms:.4f} ms (B.7 layout {ms7:.4f} ms) plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite fold at {b, n, l}"
        assert torch.equal(got, again), f"fold attention differs between two runs at {b, n, l}"
        assert torch.equal(got, got7), f"the two layouts differ at {b, n, l}"
        assert rel <= FOLD_REL_TOL, f"fold attention kernel disagrees at {b, n, l}: rel {rel}"
        rows.append(dict(b=b, n=n, l=l, err=err, ms=ms, ms7=ms7, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))

    # The Function (kernel forward, plain-recompute backward) against plain
    # autograd at the training shape: the output and the six gradients.
    b, n, l = TRAIN_B, 256, 42
    t = fold_inputs(b, n, l, seed=80)
    dy = (0.1 * torch.randn(b, n, D, generator=torch.Generator().manual_seed(81))).bfloat16()
    dy = dy.cuda()
    names = ("x", "wt4", "vw4", "gamma", "beta", "b_out")

    def fwd_bwd(fn):
        leaves = [t[k].clone().requires_grad_() for k in names]
        out = fn(*leaves)
        out.backward(dy)
        return [out.detach()] + [v.grad for v in leaves]

    n0 = fa.bwd_calls
    got, want = fwd_bwd(fa.fold_attention_heads), fwd_bwd(fa.fold_attention_reference)
    torch.cuda.synchronize()
    assert fa.bwd_calls == n0 + 1
    for name, g, w in zip(("out",) + tuple("d" + k for k in names), got, want):
        err = (g.float() - w.float()).abs().max().item()
        share = err / w.float().abs().max().item()
        log(f"fold attention Function vs plain autograd B={b} N={n} L={l} {name}: max_abs_err "
            f"{err:.6g} share of max |plain| {share:.6g} (tol {FOLD_REL_TOL}); bitwise "
            f"{torch.equal(g, w)}")
        assert g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all()), name
        assert share <= FOLD_REL_TOL, f"fold attention Function disagrees: {name} {share}"
    pair_ms = cuda_ms(lambda: fwd_bwd(fa.fold_attention_heads), reps=10)
    plain_pair_ms = cuda_ms(lambda: fwd_bwd(fa.fold_attention_reference), reps=10)
    log(f"fold attention fwd+bwd B={b} N={n} L={l}: Function {pair_ms:.4f} ms, plain autograd "
        f"{plain_pair_ms:.4f} ms [{smi}]")
    return dict(rows=rows, pair_ms=pair_ms, plain_pair_ms=plain_pair_ms)


def device_profile(fn, calls: int = 5) -> dict:
    """``fn`` run ``calls`` times under ``torch.profiler``: device busy ms and
    kernels per call (kernel events only: the aten ops carry their kernels'
    time too), and the five kernels that take the most time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(busy_ms=sum(by_name.values()), kernels=len(kernels) / calls,
                top=[(k, round(v, 4)) for k, v in by_name.most_common(5)])


def register_fold_preset() -> None:
    """``iam_fold``: the ``iam`` preset at full width with the context-folded
    attention, in the port's presets, where both CLIs resolve --preset."""
    from worddiffusion_tpu_torch.configs import presets

    def iam_fold():
        exp = presets.iam()
        return exp.replace(name="iam_fold",
                           unet=dataclasses.replace(exp.unet, attn_fold_context=True))

    presets.PRESETS["iam_fold"] = iam_fold


def phase12_fold_regen(smi: str, cli, gt: str, work: str, words) -> dict:
    """The regeneration CLI on ``--preset iam_fold``: one UNet call against
    the all-plain UNet and against the unfolded iam UNet on the same
    weights, then the pipeline, then batches in turns."""
    import torch

    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet

    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_fold"),
                                              "--preset", "iam_fold"))
    sampler = regen.sampler
    cfg = sampler.model.cfg
    assert cfg.attn_fold_context and cfg.attn1_cross and cfg.model_channels == 320
    assert cfg.num_heads * cfg.max_seq_len <= cfg.model_channels  # every attention folds
    init_weights_(sampler.model, seed=0, zero_init=False)
    inputs = unet_inputs(sampler, words, phosc=False)
    unet = unet_check(smi, sampler.model, inputs, "iam_fold", launches=(4, 0, 8))

    unfolded = UNet(dataclasses.replace(cfg, attn_fold_context=None)).cuda().eval()
    unfolded.load_state_dict(sampler.model.state_dict())
    with torch.no_grad():
        eps_u = unfolded(*inputs)
        unfolded_ms = cuda_ms(lambda: unfolded(*inputs), reps=10)
    err = (unet["eps"] - eps_u).abs().max().item()
    rel = err / eps_u.abs().max().item()
    log(f"unet B={B} iam_fold vs unfolded iam on the same weights: eps max_abs_err {err:.6g} "
        f"max_rel_err {rel:.6g} (tol {FOLD_VS_UNFOLDED_TOL}); call {unet['ms']:.3f} ms folded, "
        f"{unfolded_ms:.3f} ms unfolded (all kernels) [{smi}]")
    assert rel <= FOLD_VS_UNFOLDED_TOL, f"folded vs unfolded UNet: rel {rel}"
    with torch.no_grad():
        prof = {label: device_profile(lambda: model(*inputs)) for label, model in
                (("folded", sampler.model), ("unfolded", unfolded))}
    for label, ms in (("folded", unet["ms"]), ("unfolded", unfolded_ms)):
        d = prof[label]
        log(f"unet B={B} iam {label}, profiled: device busy {d['busy_ms']:.4f} ms/call, "
            f"{d['kernels']:.0f} kernels/call, idle {1 - d['busy_ms'] / ms:.1%} of the "
            f"unprofiled call; top kernels (ms/call) {d['top']} [{smi}]")
    del unfolded

    out = drive_regen(smi, regen, samples, seed=0, label="iam_fold", per_call=(4, 0, 8))
    batch_seconds(smi, sampler, words[:B], "iam_fold")
    return dict(out, unet_ms=unet["ms"], unfolded_ms=unfolded_ms, vs_unfolded=rel)


def phase13_fold_train(smi: str, work: str, corpus: tuple[str, str]) -> dict:
    """The train CLI on ``--preset iam_fold`` at B=128, twice: the fold
    kernels and Functions on every step, and two identical runs bitwise
    equal."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    gt, cache = corpus
    epochs, steps = 2, 2 * TRAIN_STEPS_PER_EPOCH

    def run(save: str):
        trainer = train_cli.build(train_cli.build_parser().parse_args([
            "--preset", "iam_fold", "--gt_train", gt, "--latent_cache", cache,
            "--batch_size", str(TRAIN_B), "--epochs", str(epochs), "--ckpt_every_epochs", "2",
            "--save_path", os.path.join(work, save), "--seed", "0", "--device", "cuda",
        ]))
        assert trainer.exp.unet.attn_fold_context and trainer.exp.unet.model_channels == 320
        previews = count_previews(trainer)
        initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        ffn.launches = ffn.bwd_launches = attention.launches = attention.bwd_calls = 0
        fold_attention.launches = fold_attention.bwd_calls = 0
        state = trainer.run(epochs=epochs)
        torch.cuda.synchronize()
        counts = dict(ffn=ffn.launches, ffn_bwd=ffn.bwd_launches, attn=attention.launches,
                      attn_bwd=attention.bwd_calls, fold=fold_attention.launches,
                      fold_bwd=fold_attention.bwd_calls)
        return trainer, state, initial, counts, previews, torch.cuda.max_memory_allocated()

    trainer, state, initial, counts, (p_ffn, p_attn, p_fold), peak = run("run_fold")
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    proj = [k for k in changed if any(f".attn{i}.to_{w}" in k for i in (1, 2)
                                      for w in ("q", "k", "v", "out"))]
    s_, n_ = trainer.epoch_seconds[1]
    log(f"train iam_fold: {state.step} steps of B={TRAIN_B} incl. 1 checkpoint and 1 DDIM-50 "
        f"preview; launches {counts} (preview: FF {p_ffn}, attention {p_attn}, fold {p_fold}); "
        f"epoch 1 {s_ / n_:.4f} s/step {n_ / s_:.3f} steps/s; peak memory "
        f"{peak / 2 ** 30:.3f} GiB [{smi}]")
    assert state.step == steps, state.step
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert len(proj) == 4 * 2 * 5 and all(changed[k] > 0 for k in proj), proj
    assert p_fold == [8 * 50] and p_attn == [0] and p_ffn == [4 * 50], (p_fold, p_attn, p_ffn)
    assert counts == dict(ffn=4 * steps + 4 * 50, ffn_bwd=4 * steps, attn=0, attn_bwd=0,
                          fold=8 * steps + 8 * 50, fold_bwd=8 * steps), counts

    # where the step's device time goes: the UNet's forward and backward at
    # B=128 (the step without its draws and AdamW), folded and unfolded on
    # the trained weights
    g = torch.Generator().manual_seed(5)
    x = torch.randn(TRAIN_B, 8, 32, 4, generator=g).cuda()
    cond = [torch.randint(1, 600, (TRAIN_B,), generator=g),
            torch.randint(0, 53, (TRAIN_B, 42), generator=g),
            torch.randint(0, 339, (TRAIN_B,), generator=g)]
    cond = [c.cuda() for c in cond]
    unfolded = UNet(dataclasses.replace(trainer.exp.unet, attn_fold_context=None)).cuda()
    unfolded.load_state_dict(state.model.state_dict())
    for label, model in (("folded", state.model), ("unfolded", unfolded)):
        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            model(x, *cond).square().mean().backward()

        wall = cuda_ms(fwd_bwd, reps=5, warmup=2)
        d = device_profile(fwd_bwd, calls=3)
        log(f"unet fwd+bwd B={TRAIN_B} iam {label}: {wall:.3f} ms, profiled device busy "
            f"{d['busy_ms']:.3f} ms, {d['kernels']:.0f} kernels; top kernels (ms) {d['top']} "
            f"[{smi}]")
    del unfolded

    _, again, _, _, _, _ = run("run_fold_again")
    diff = max((a - b).abs().max().item() for a, b in
               zip(again.model.parameters(), state.model.parameters()))
    log(f"train iam_fold: a second identical run ends with max param diff {diff:.6g} "
        f"(must be bitwise 0)")
    assert diff == 0, f"two identical fold training runs differ: {diff}"
    return dict(counts, s_per_step=s_ / n_, peak_bytes=peak)


def png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", path
    return struct.unpack(">II", head[16:24])  # width, height


def unet_inputs(sampler, words, phosc: bool):
    """One full-width UNet call's inputs at B=16: seeded x_t, four
    timesteps, the words' char ids, writers 0..15 and, for a PHOSC model,
    the words' PHOSC ids."""
    import torch

    from worddiffusion_tpu_torch.generate.sample import phosc_ids

    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, 8, 32, 4, generator=g).cuda()
    t = torch.tensor([599, 400, 200, 10] * (B // 4)).cuda()
    ctx = torch.from_numpy(sampler.tokenizer.encode_batch(words[:B])).long().cuda()
    ph = torch.from_numpy(phosc_ids(words[:B], "eng")).cuda() if phosc else None
    return x, t, ctx, torch.arange(B).cuda(), ph


def unet_check(smi: str, unet, inputs, label: str, launches=(4, 8, 0)) -> dict:
    """One UNet call with every kernel against the all-plain UNet (plain FF,
    plain attention, plain fold) on the same weights; kernel launches per
    call (FF, attention, fold attention: ``launches``); call times
    all-kernel, FF kernel with the plain attentions, and all-plain."""
    import torch

    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    plain = UNet(dataclasses.replace(unet.cfg, use_pallas_ffn=False)).cuda().eval()
    plain.load_state_dict(unet.state_dict())
    with torch.no_grad():
        f0, a0, d0 = ffn.launches, attention.launches, fold_attention.launches
        eps_k = unet(*inputs)
        n_ff, n_attn = ffn.launches - f0, attention.launches - a0
        n_fold = fold_attention.launches - d0
        with plain_attention():
            eps_p = plain(*inputs)
            before_ms = cuda_ms(lambda: unet(*inputs), reps=10)
            plain_ms = cuda_ms(lambda: plain(*inputs), reps=10)
        err = (eps_k - eps_p).abs().max().item()
        rel = err / eps_p.abs().max().item()
        unet_ms = cuda_ms(lambda: unet(*inputs), reps=10)
    log(f"unet B={B} ({label}, {unet.cfg.model_channels} ch): eps max_abs_err {err:.6g} "
        f"max_rel_err {rel:.6g} (tol {UNET_REL_TOL}) against all-plain; launches per call: "
        f"{n_ff} FF, {n_attn} attention, {n_fold} fold attention; call {unet_ms:.3f} ms all "
        f"kernels, {before_ms:.3f} ms FF kernel + plain attention, {plain_ms:.3f} ms all plain "
        f"[{smi}]")
    assert (n_ff, n_attn, n_fold) == launches, (n_ff, n_attn, n_fold)
    assert bool(torch.isfinite(eps_k).all()), "non-finite eps"
    assert rel <= UNET_REL_TOL, f"UNet all-kernel vs all-plain: rel {rel}"
    return dict(ms=unet_ms, before_ms=before_ms, plain_ms=plain_ms, err=err, rel=rel,
                eps=eps_k)


def drive_regen(smi: str, regen, samples, seed: int, label: str, per_call=(4, 8, 0)) -> dict:
    """The regeneration main path over ``samples``: counts set to 0 just
    before the run and read just after; checks shapes, finiteness, the
    PNGs and the FF, attention and fold attention launches per denoiser
    call (``per_call``)."""
    import torch

    from worddiffusion_tpu_torch.generate.sample import phosc_ids
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    sampler = regen.sampler
    checks = []
    decode = sampler.decode

    def checked_decode(lat):
        img, ids = decode(lat)
        checks.append((torch.isfinite(lat).all(), tuple(img.shape), img.dtype,
                       tuple(ids.shape), ids.dtype))
        return img, ids

    sampler.decode = checked_decode
    calls = int(sampler.call_mask[1:].sum())
    words = [s.word for s in samples[:B]]
    ph = phosc_ids(words, "eng") if sampler.exp.unet.use_phosc else None
    warm = torch.Generator(device="cuda").manual_seed(123)
    sampler.sample_async(words, list(range(B)), warm, ph)[0].cpu()  # warm-up batch
    checks.clear()

    ffn.launches = attention.launches = fold_attention.launches = 0
    t0 = time.perf_counter()
    stats = regen.run(samples, batch_size=B, seed=seed)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_ff, n_attn, n_fold = ffn.launches, attention.launches, fold_attention.launches

    dump = regen.out_dir
    n_batches = -(-len(samples) // B)
    log(f"regen {label}: {stats.generated} generated, {stats.accepted} accepted, {n_batches} "
        f"batches of {B}, {calls} denoiser calls each; {elapsed / n_batches:.3f} s/batch, "
        f"{stats.generated / elapsed:.2f} imgs/s (incl. PNG writes) [{smi}]")
    want = tuple(k * calls * n_batches for k in per_call)
    log(f"kernel launches in the {label} main path: {n_ff} FF, {n_attn} attention, {n_fold} fold "
        f"attention (expect {per_call} x {calls} calls x {n_batches} batches = {want})")
    assert calls == 120, calls
    assert (n_ff, n_attn, n_fold) == want, (n_ff, n_attn, n_fold)
    assert stats.generated == len(samples) == 40, stats
    assert len(checks) == n_batches, len(checks)
    for finite, ishape, idt, fshape, fdt in checks:
        assert bool(finite), "non-finite latents"
        assert ishape == (B, 64, 256, 3) and idt == torch.uint8, (ishape, idt)
        assert fshape == (B, 64) and fdt == torch.int32, (fshape, fdt)
    pngs = sorted(f for f in os.listdir(dump) if f.endswith(".png"))
    rejected = os.listdir(os.path.join(dump, "rejected")) if stats.accepted < len(samples) else []
    assert len(pngs) == stats.accepted, (len(pngs), stats.accepted)
    assert len(rejected) == stats.generated - stats.accepted, len(rejected)
    first = os.path.join(dump, pngs[0]) if pngs else os.path.join(dump, "rejected", rejected[0])
    assert png_size(first) == (256, 64), png_size(first)
    sampler.decode = decode
    return dict(ffn=n_ff, attn=n_attn, fold=n_fold, s_per_batch=elapsed / n_batches,
                imgs_per_s=stats.generated / elapsed)


def batch_seconds(smi: str, sampler, words, label: str, phosc=None) -> dict:
    """Wall seconds of one queued batch (120 denoiser calls, decode, OCR)
    with the attention kernels and with the plain attentions (folded or
    not), in turns (kernel, plain, plain, kernel): the host-bound batch
    time drifts with the load on the host's shared cores."""
    import torch

    times = {"kernel": [], "plain": []}
    for r, kernel in enumerate((True, False, False, True)):
        gen = torch.Generator(device="cuda").manual_seed(200 + r)
        with contextlib.nullcontext() if kernel else plain_attention():
            t0 = time.perf_counter()
            sampler.sample_async(words, list(range(len(words))), gen, phosc)[0].cpu()
            times["kernel" if kernel else "plain"].append(time.perf_counter() - t0)
    log(f"regen {label} one batch of {len(words)} (120 calls + decode + OCR), in turns: "
        f"{times['kernel']} s with the attention kernel, {times['plain']} s with the plain "
        f"attention [{smi}]")
    return times


def regen_cli_args(cli, gt: str, dump: str, *extra: str):
    return cli.build_parser().parse_args([
        "--gt_file", gt, "--dump_path", dump, "--batch_size", str(B), "--keep_rejected", "1",
        "--seed", "0", *extra,
    ])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU", file=sys.stderr)
        return 1

    from worddiffusion_tpu_torch.cli import regenerate as cli
    from worddiffusion_tpu_torch.generate.sample import phosc_ids
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import build, ffn

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    log(f"build: {lib} in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain ------------------------------------------------
    ffn_rows = []
    for i, m in enumerate(FFN_SHAPES):
        a = ffn_inputs(m, seed=i)
        got = ffn.fused_ln_geglu_ffn(**a)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_reference(**a)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = cuda_ms(lambda: ffn.fused_ln_geglu_ffn(**a))
        plain_ms = cuda_ms(lambda: ffn.ln_geglu_ffn_reference(**a))
        bound_ms, bound_by = ffn_bound(a, got)
        log(f"ffn M={m} d={D} inner={INNER}: max_abs_err {err:.6g} max_rel_err {rel:.6g} "
            f"(tol {FFN_REL_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) [{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at M={m}"
        assert rel <= FFN_REL_TOL, f"kernel disagrees with plain at M={m}: rel {rel}"
        ffn_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))

    # The regeneration pipeline as the CLI builds it, on the card.
    work = tempfile.mkdtemp(prefix="wd_chip_smoke_")
    gt = os.path.join(work, "words.filter27")
    words = ("the of and to in is was that for it with as his on be at by had are "
             "but from not this have which one were all they she you her an there "
             "been their we him would so when more can said no").split()[:40]
    with open(gt, "w") as f:
        for i, w in enumerate(words):
            f.write(f"{i % 7:03d},a01-{i:03d}u-00 {w}\n")
    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen")))
    sampler = regen.sampler
    # every kernel random, the zero-initialised output convs too, so each FF
    # sub-layer and each attention reaches eps
    init_weights_(sampler.model, seed=0, zero_init=False)

    # -- 4. whole UNet: all kernels vs all plain ---------------------------
    unet = unet_check(smi, sampler.model, unet_inputs(sampler, words, phosc=False), "iam")

    # -- 5. main path ------------------------------------------------------
    regen_iam = drive_regen(smi, regen, samples, seed=0, label="iam")
    batch_seconds(smi, sampler, words[:B], "iam")

    # -- 6. FFN forward + backward: kernel vs plain -------------------------
    bwd = phase6_ffn_backward(smi)

    # -- 7. training main path -----------------------------------------------
    n = TRAIN_B * TRAIN_STEPS_PER_EPOCH + TRAIN_B // 2  # a half batch to drop_remainder
    corpus = write_latent_corpus(work, n)
    train = phase7_train(smi, work, corpus)

    # -- 8. attention kernel vs plain -----------------------------------------
    attn = phase8_attention(smi)

    # -- 9. iam_phosc regeneration ---------------------------------------------
    regen_p, samples_p = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_phosc"),
                                                  "--preset", "iam_phosc"))
    sampler_p = regen_p.sampler
    cfg_p = sampler_p.model.cfg
    assert cfg_p.use_phosc and not cfg_p.attn1_cross and cfg_p.model_channels == 320
    init_weights_(sampler_p.model, seed=0, zero_init=False)
    unet_p = unet_check(smi, sampler_p.model, unet_inputs(sampler_p, words, phosc=True),
                        "iam_phosc")
    regen_phosc = drive_regen(smi, regen_p, samples_p, seed=0, label="iam_phosc")
    batch_seconds(smi, sampler_p, words[:B], "iam_phosc", phosc_ids(words[:B], "eng"))
    del regen_p, sampler_p

    # -- 10. iam_phosc training --------------------------------------------------
    train_p = phase10_phosc_train(smi, work, corpus)

    # -- 11. fold attention kernel vs plain ----------------------------------------
    fold = phase11_fold(smi)

    # -- 12. iam_fold regeneration ---------------------------------------------------
    register_fold_preset()
    regen_fold = phase12_fold_regen(smi, cli, gt, work, words)

    # -- 13. iam_fold training ----------------------------------------------------------
    train_f = phase13_fold_train(smi, work, corpus)

    paths = ("regenerate", "regenerate_iam_phosc", "regenerate_iam_fold", "train",
             "train_iam_phosc", "train_iam_fold")

    def by_path(*counts):
        return dict(zip(paths, counts))

    ffn_paths = by_path(regen_iam["ffn"], regen_phosc["ffn"], regen_fold["ffn"], train["fwd"],
                        train_p["fwd"], train_f["ffn"])
    bwd_paths = by_path(0, 0, 0, train["bwd"], train_p["bwd"], train_f["ffn_bwd"])
    attn_paths = by_path(regen_iam["attn"], regen_phosc["attn"], regen_fold["attn"],
                         train["attn"], train_p["attn"], train_f["attn"])
    fold_paths = by_path(0, 0, regen_fold["fold"], 0, 0, train_f["fold"])
    main_row, bwd_row, attn_row = ffn_rows[0], bwd["rows"][0], attn["rows"][0]
    fold_row = fold["rows"][0]
    log(f"summary [{smi}]: iam UNet call {unet['ms']:.3f} ms (FF kernel + plain attention "
        f"{unet['before_ms']:.3f}); iam_phosc UNet call {unet_p['ms']:.3f} ms (FF kernel + plain "
        f"attention {unet_p['before_ms']:.3f}); iam_fold UNet call {regen_fold['unet_ms']:.3f} ms "
        f"(unfolded {regen_fold['unfolded_ms']:.3f}); regen s/batch iam "
        f"{regen_iam['s_per_batch']:.4f}, iam_phosc {regen_phosc['s_per_batch']:.4f}, iam_fold "
        f"{regen_fold['s_per_batch']:.4f}; imgs/s iam {regen_iam['imgs_per_s']:.3f}, iam_phosc "
        f"{regen_phosc['imgs_per_s']:.3f}, iam_fold {regen_fold['imgs_per_s']:.3f}; train s/step "
        f"iam {train['s_per_step']:.4f}, iam_phosc {train_p['s_per_step']:.4f}, iam_fold "
        f"{train_f['s_per_step']:.4f}")
    log(json.dumps({"kernels": [{
        "name": "ln_geglu_ffn",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
        "replaces": "worddiffusion_tpu/ops/ffn_pallas.py:48",
        "launches": sum(ffn_paths.values()),
        "launches_by_path": ffn_paths,
        "max_abs_err": max(r["err"] for r in ffn_rows + bwd["fwd_rows"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "ln_geglu_ffn_bwd",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/ln_geglu_ffn_bwd.cu",
        "replaces": "worddiffusion_tpu/ops/ffn_pallas.py:397",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": max(r["err"] for r in bwd["rows"]),
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "attention",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/attention.cu",
        "replaces": "bench_kernels/attention_pallas.py:25",
        "launches": sum(attn_paths.values()),
        "launches_by_path": attn_paths,
        "max_abs_err": max(r["err"] for r in attn["rows"]),
        "ms": attn_row["ms"],
        "plain_ms": attn_row["plain_ms"],
        "bound_ms": attn_row["bound_ms"],
        "bound_by": attn_row["bound_by"],
        "library_ms": attn_row["library_ms"],
    }, {
        "name": "fold_attention",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/fold_attention.cu",
        "replaces": "bench_kernels/attn_fold_pallas.py:36; "
                    "bench_kernels/attn_fold_sublayer_pallas.py:100",
        "launches": sum(fold_paths.values()),
        "launches_by_path": fold_paths,
        "max_abs_err": max(r["err"] for r in fold["rows"]),
        "ms": fold_row["ms"],
        "plain_ms": fold_row["plain_ms"],
        "bound_ms": fold_row["bound_ms"],
        "bound_by": fold_row["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
