"""Time the port's redesigned kernels of two source trees on one card, by
three methods: the attention kernel (B.4), GN -> SiLU -> conv3x3 (B.6),
the LN + GEGLU FFN (B.1) and its bare mode (B.2), its backward (B.3),
GroupNorm (+ SiLU) (B.5) and the context-folded attention sub-layer (B.8,
and once through B.7's layout); and read what holds B.4 back against
``scaled_dot_product_attention``.

    python3 worddiffusion_tpu_torch/kernel_times.py --other DIR [--out FILE]
        [--kinds ffn_bwd,fold]

DIR is another checkout of the repo, or just its ``worddiffusion_tpu_torch``
package, for example an earlier commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists. Each tree runs in a process of its own,
in the order other, this, this, other, so that a drift of the card shows as a
difference between the two runs of one tree; each process builds its own
tree's kernels. At every shape it times the kernel's op and its library
yardstick where one PyTorch call computes the same function (SDPA;
``F.group_norm`` -> ``F.silu`` -> cuDNN ``F.conv2d``; ``F.group_norm``
(+ ``F.silu``); none for B.1 and B.2). B.1 runs as the UNet calls it, the
``LnGegluFFN`` Function on fp32 parameter-layout weights under no_grad
(each tree casts or lays them out inside), and, in this tree only, on
bf16 parameter-layout weights (``ffn_bf16``, which the kernel reads with
no copy: the difference is the cost of the casts); B.2 through
``fused_geglu_ffn`` on bf16 weights in the JAX layout; B.3 as the
``LnGegluFFN`` Function's backward alone (``torch.autograd.grad`` of a
kept graph, fp32 parameter-layout weights), its kernel time also split by
kernel name; B.8 through ``fold_attention_heads`` on folds as
``build_folds`` lays them out and B.7 through ``fold_attention`` on its
[B, C, H*L] folds; one ``iam`` and one ``iam_fold`` training step at
B=128 (``train_step``); B.1 at the widths of ``channel_mult=(1, 2)``
(``ffn_wide``: d = 320 and 640 at its middle block's M, and d = 768) and
B.4 at its head widths (``attention_wide``: D = 80, 160 and 256 at its
middle block's shape), B.3 at every width its kernels take
(``ffn_bwd_wide``: the Function's backward alone as above, d = 64k up to
768 at M = 1024, d = 320 at M = 128*256 and d = 640 at M = 128*64, the two
(1, 2) training sites) and the fold at C = 640 (``fold_wide``: B.8's layout
at (B, N) = (16, 64) and (128, 64), L = 42, and B.7's at the second), where a
tree whose kernel refuses a width records it as not taken. ``--kinds`` keeps only the named kinds:

- ``host_ms``: the host's time to issue one call, 10 calls back to back on
  the host's clock without waiting for the card, the median of 10;
- ``single_ms``: one call between two CUDA events, the median of 30; the
  host's launch path adds to it where it is longer than the device work;
- ``launch_ms``: per call over 10 calls back to back between two events, the
  median of 10 (``chip_smoke.py``'s method): the launch path overlaps;
- ``kernel_ms``: the device time of the call's kernels alone, from
  ``torch.profiler``, per call over 10 calls.

Then, in this tree only: the registers, stack, local (spilled) and static
shared memory of each instance of the attention, FFN and GroupNorm kernels
as ``cuobjdump -res-usage`` reads them from the built library, the CTAs per
SM those and the dynamic shared memory allow, the cluster sizes B.1 and
B.5 launch with at each shape, B.5's kernel time at every route (cluster
of 1, 2, 4, 8; x kept in shared memory or read twice) and, for the route
it picks, stopped after its first pass and after its statistics
(``wd_groupnorm_routed``), B.6's time by all four methods at the UNet's
sites (C=320, and C=640 of channel_mult=(1, 2)) on every plan
(``wd_gn_silu_conv3x3_planned``), and B.4 against SDPA over Nk at B=128, Nq=256
(``kernel_ms``), fitted as a fixed cost plus a cost per key chunk of the
kernel's plan. For the attention kernel's instances it also reports the
plan's shared memory, ring depths and the registers setmaxnreg gives the
producer warp and the consumer warpgroups (cuobjdump reads the launch's).

With ``--rounds 2`` the order other, this, this, other is followed by this,
other, other, this, so that each tree runs first once. Prints one JSON
object a process and a summary (each tree's mean over its runs, and their
least and most); writes everything to FILE (default
``build/kernel_times.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HEADS, D_HEAD = 4, 80
# (B, Nq, Nk): every B=128 attention of the training step, the iam
# regeneration's widest, and pixel space's cross-attentions and
# self-attention at B=16
ATTN_SHAPES = ((128, 256, 811), (128, 64, 811), (128, 256, 256), (128, 64, 64),
               (128, 256, 42), (128, 64, 42), (16, 256, 42), (16, 16384, 42), (16, 4096, 42),
               (16, 16384, 16384))
# (B, H, W, C): every B=128 B.6 site (UNet and VAE encoder), the UNet's two
# resolutions and the decoder's widest at B=16, a pixel-space ResBlock's, and
# channel_mult=(1, 2)'s 640-wide middle sites at B=16 and 128
CONV_SHAPES = ((128, 8, 32, 320), (128, 4, 16, 320), (128, 16, 64, 512), (128, 8, 32, 512),
               (128, 32, 128, 256), (128, 64, 256, 128), (16, 8, 32, 320), (16, 4, 16, 320),
               (16, 64, 256, 128), (16, 64, 256, 320), (16, 4, 16, 640), (128, 4, 16, 640))
SWEEP_NK = (64, 256, 512, 811, 1024, 2048)
D, INNER = 320, 1280
# M of B.1: the UNet's regeneration sites (B=16 at 256 and 64 tokens), its
# training site (B=128, 256 tokens) and a ragged M; of B.2: two of them
FFN_M = (16 * 256, 16 * 64, 128 * 256, 1000)
GEGLU_M = (16 * 256, 128 * 256)
# M of B.3: the training step's sites (B=128 at 256 and 64 tokens), a ragged M
# and pixel space's two sites (B=16 at 64 x 256 and 32 x 128 tokens)
FFN_BWD_M = (128 * 256, 128 * 64, 1000, 16 * 64 * 256, 16 * 32 * 128)
# (B, N) of B.8 (C=320, H=4, L=42): regeneration (B=16) and training (B=128)
# at the full-resolution and middle blocks; B.7's layout at the first and third
FOLD_BN = ((16, 256), (16, 64), (128, 256), (128, 64))
FOLD_B7_BN = ((16, 256), (128, 256))
FOLD_L = 42
# (B, H, W, C, groups, silu) of B.5: every UNet site at B=16 and 128 (the
# 640-channel output ResBlocks with SiLU, the 320-channel transformer norms
# and the out norm), and a VAE decoder site whose per-CTA range does not fit
# in shared memory
GN_SHAPES = tuple((b, h, w, c, 32, silu) for b in (16, 128)
                  for h, w, c, silu in ((8, 32, 640, True), (4, 16, 640, True),
                                        (8, 32, 320, False), (4, 16, 320, False),
                                        (8, 32, 320, True))) + ((16, 64, 256, 256, 32, True),)
# (M, d) of B.1 at channel_mult (1, 2)'s widths: its middle block (d = 640)
# at B = 16 and 128 beside d = 320 at the same M, and the widest d it takes;
# inner = 4d. A tree whose kernel does not take a width records it as such.
FFN_WIDE = ((16 * 64, 320), (128 * 64, 320), (16 * 64, 640), (128 * 64, 640), (4096, 768))
# (B, Nq, Nk, D) of B.4 at the (1, 2) middle block's shape, D = 80 beside the
# wider heads (160: 4 heads of 640; 256 the widest the kernel takes)
ATTN_WIDE = tuple((b, 64, 42, d) for d in (80, 160, 256) for b in (16, 128))
# (M, d) of B.3 at every width its kernels take (M = 1024), and channel_mult
# (1, 2)'s training sites at B = 128: d = 320 at 256 tokens, d = 640 at 64
FFN_BWD_WIDE = tuple((1024, d) for d in range(64, 769, 64)) + ((128 * 256, 320),
                                                               (128 * 64, 640))
# (B, N) of the fold at C = 640 (the (1, 2) middle block), and B.7's layout
FOLD_WIDE_C, FOLD_WIDE_BN, FOLD_WIDE_B7_BN = 640, ((16, 64), (128, 64)), ((128, 64),)
KINDS = ("attention", "conv", "ffn", "ffn_bf16", "geglu", "ffn_bwd", "groupnorm", "fold",
         "fold_b7", "train_step", "ffn_wide", "attention_wide", "ffn_bwd_wide", "fold_wide")
TRAIN_B = 128
METHODS = ("host_ms", "single_ms", "launch_ms", "kernel_ms")


def single_ms(fn, reps: int = 30, warmup: int = 5) -> float:
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


def launch_ms(fn, calls: int = 10, reps: int = 10) -> float:
    return single_ms(lambda: [fn() for _ in range(calls)], reps=reps, warmup=1) / calls


def host_ms(fn, calls: int = 10, reps: int = 10) -> float:
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_ms(fn, calls: int = 10, per_call: int | None = None) -> tuple[float, dict]:
    """Device time per call of the kernels ``fn`` launches, and the same by
    kernel name. A trace that caught no kernel event, or (``per_call``: the
    kernels one call launches) not every launch's (both seen now and then on
    the card), is taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        # an annotation range (the optimizer's step), not a kernel
        kernels = [e for e in kernels if not e.name.startswith("Optimizer.")]
        seen.append((len(events), len(kernels)))
        if kernels and (per_call is None or len(kernels) == per_call * calls):
            split = {}
            for e in kernels:
                split[e.name[:80]] = split.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
            return sum(split.values()) / calls, {k: v / calls for k, v in sorted(split.items())}
    raise RuntimeError("torch.profiler caught no (or not every) kernel in three traces "
                       f"((events, kernel events) of each: {seen})")


def three_ways(fn, per_call: int | None = None) -> dict:
    k, split = kernel_ms(fn, per_call=per_call)
    return dict(host_ms=host_ms(fn), single_ms=single_ms(fn), launch_ms=launch_ms(fn),
                kernel_ms=k, split=split)


def attn_inputs(b: int, nq: int, nk: int, seed: int, d: int = D_HEAD):
    import torch

    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, HEADS, n, d, generator=g).bfloat16().cuda()
                 for n in (nq, nk, nk))


def takes(fn, may_refuse: bool):
    """``three_ways(fn)``; with ``may_refuse`` (the other tree, an earlier
    one, whose kernel may not take the width), None where it refuses the
    shape. This tree's refusal raises."""
    if may_refuse:
        try:
            fn()
        except ValueError:
            return None
    return three_ways(fn)


def conv_inputs(b: int, h: int, w: int, c: int, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(b, h, w, c, generator=g) + 0.5).bfloat16().cuda()
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    wt = (torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5).cuda()
    cb = (0.1 * torch.randn(c, generator=g)).cuda()
    return x, scale, bias, wt, cb


def ffn_inputs(m: int, seed: int, d: int = D, inner: int = INNER):
    """x, LayerNorm affine and biases; fp32 weights in parameter layout
    (w1 [2*inner, d], w2 [d, inner]) as the UNet holds them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(x=r(m, d).bfloat16(), gamma=1 + 0.1 * r(d), beta=0.1 * r(d),
             w1=r(2 * inner, d) / d ** 0.5, b1=0.02 * r(2 * inner), w2=r(d, inner) / inner ** 0.5,
             b2=0.02 * r(d))
    return {k: v.cuda() for k, v in t.items()}


def fold_inputs(b: int, n: int, seed: int, c: int = D):
    """x, the LayerNorm affine and out bias, and B.8's folds as
    ``models.attention.build_folds`` returns them: wt4 [B, H, C, L] as the
    [..., :L] view of an L stride rounded up to 8, vw4 [B, H, L, C]
    contiguous."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = dict(x=r(b, n, c).bfloat16(), wt4=(r(b, HEADS, c, FOLD_L) / c ** 0.5).bfloat16(),
             vw4=r(b, HEADS, FOLD_L, c).bfloat16(), gamma=1 + 0.1 * r(c), beta=0.1 * r(c),
             b_out=0.02 * r(c))
    t = {k: v.cuda() for k, v in t.items()}
    t["wt4"] = F.pad(t["wt4"], (0, -FOLD_L % 8))[..., :FOLD_L]
    return t


def norm_inputs(shape, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (2 * torch.randn(*shape, generator=g) + 0.5).bfloat16()
    scale, bias = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    return x.cuda(), scale.cuda(), bias.cuda()


def worker(tree: str, deep: bool, kinds: tuple[str, ...] = KINDS, other: bool = False) -> dict:
    """Every time of one tree's kernels of ``kinds``; with ``deep``, the
    resource use, the routes and the Nk sweep too; ``other``: the tree is
    the other one, whose kernels may refuse the wide shapes."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import attention, build, ffn, fold_attention, gn_conv, groupnorm

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    lib = build.build()
    scale = D_HEAD ** -0.5
    out = dict(tree=tree, **{k: [] for k in KINDS})
    for i, (b, nq, nk) in enumerate(ATTN_SHAPES if "attention" in kinds else ()):
        q, k, v = attn_inputs(b, nq, nk, seed=30 + i)
        out["attention"].append(dict(
            shape=[b, nq, nk], kernel=three_ways(lambda: attention.fused_attention(q, k, v, scale)),
            library=three_ways(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))))
    for i, (b, nq, nk, dh) in enumerate(ATTN_WIDE if "attention_wide" in kinds else ()):
        q, k, v = attn_inputs(b, nq, nk, seed=70 + i, d=dh)
        sc = dh ** -0.5
        out["attention_wide"].append(dict(
            shape=[b, nq, nk, dh], kernel=takes(lambda: attention.fused_attention(q, k, v, sc), other),
            library=three_ways(lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))))
    for i, (m, d) in enumerate(FFN_WIDE if "ffn_wide" in kinds else ()):
        t = ffn_inputs(m, seed=320 + i, d=d, inner=4 * d)
        a = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"], 1e-5)

        def sublayer():
            with torch.no_grad():
                return ffn.LnGegluFFN.apply(*a)

        out["ffn_wide"].append(dict(shape=[m, d], kernel=takes(sublayer, other), library=None))
        del t, a
    for i, (b, h, w, c) in enumerate(CONV_SHAPES if "conv" in kinds else ()):
        x, s, bi, wt, cb = conv_inputs(b, h, w, c, seed=120 + i)
        nchw, ws, bs = x.permute(0, 3, 1, 2), s.bfloat16(), bi.bfloat16()
        wb, cbb = wt.bfloat16().contiguous(memory_format=torch.channels_last), cb.bfloat16()
        out["conv"].append(dict(
            shape=[b, h, w, c],
            kernel=three_ways(lambda: gn_conv.fused_gn_silu_conv3x3(x, s, bi, wt, cb, 32, 1e-6)),
            library=three_ways(lambda: F.conv2d(F.silu(F.group_norm(nchw, 32, ws, bs, 1e-6)),
                                                wb, cbb, padding=1))))
        del x, nchw
    for i, m in enumerate(FFN_M if {"ffn", "geglu"} & set(kinds) else ()):
        t = ffn_inputs(m, seed=300 + i)
        a = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"], 1e-5)

        def sublayer():
            with torch.no_grad():
                return ffn.LnGegluFFN.apply(*a)

        if "ffn" in kinds:
            out["ffn"].append(dict(shape=[m], kernel=three_ways(sublayer), library=None))
        if deep and "ffn" in kinds:
            # this tree only: the same on bf16 parameter-layout weights, which
            # the kernel reads as they are; the difference is what the two
            # fp32 -> bf16 cast copies of a call cost
            b16 = (*a[:3], t["w1"].bfloat16(), t["b1"], t["w2"].bfloat16(), *a[6:])

            def sublayer_bf16():
                with torch.no_grad():
                    return ffn.LnGegluFFN.apply(*b16)

            out["ffn_bf16"].append(dict(shape=[m], kernel=three_ways(sublayer_bf16),
                                        library=None))
        if m in GEGLU_M and "geglu" in kinds:
            w1, w2 = t["w1"].t().bfloat16().contiguous(), t["w2"].t().bfloat16().contiguous()
            out["geglu"].append(dict(shape=[m], kernel=three_ways(
                lambda: ffn.fused_geglu_ffn(t["x"], w1, t["b1"], w2, t["b2"])), library=None))
    for i, m in enumerate(FFN_BWD_M if "ffn_bwd" in kinds else ()):
        # the Function's backward alone, as a training step runs it: the
        # graph of one forward kept, its gradients taken again and again
        t = ffn_inputs(m, seed=350 + i)
        leaves = [t[k].requires_grad_() for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
        y = ffn.LnGegluFFN.apply(*leaves, 1e-5)
        dy = (0.1 * torch.randn(m, D, generator=torch.Generator().manual_seed(360 + i))).bfloat16()
        dy = dy.cuda()
        out["ffn_bwd"].append(dict(shape=[m], kernel=three_ways(
            lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)), library=None))
        del t, leaves, y
    for i, (m, d) in enumerate(FFN_BWD_WIDE if "ffn_bwd_wide" in kinds else ()):
        # as ffn_bwd, at every width; a tree whose Function refuses the width
        # (its check when a gradient is wanted) records it as not taken
        t = ffn_inputs(m, seed=370 + i, d=d, inner=4 * d)
        leaves = [t[k].requires_grad_() for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
        try:
            y = ffn.LnGegluFFN.apply(*leaves, 1e-5)
        except ValueError:
            if not other:
                raise
            y = None
        dy = (0.1 * torch.randn(m, d, generator=torch.Generator().manual_seed(390 + i)))
        dy = dy.bfloat16().cuda()
        out["ffn_bwd_wide"].append(dict(shape=[m, d], library=None, kernel=None if y is None else
                                        three_ways(lambda: torch.autograd.grad(
                                            y, leaves, dy, retain_graph=True))))
        del t, leaves, y
    for i, (b, n) in enumerate(FOLD_WIDE_BN if "fold_wide" in kinds else ()):
        c = FOLD_WIDE_C
        t = fold_inputs(b, n, seed=650 + i, c=c)
        vecs = (t["gamma"], t["beta"], t["b_out"])
        out["fold_wide"].append(dict(shape=[b, n, FOLD_L, c, "b8"], library=None,
                                     kernel=takes(lambda: fold_attention.fold_attention_heads(
                                         t["x"], t["wt4"], t["vw4"], *vecs), other)))
        if (b, n) in FOLD_WIDE_B7_BN:
            wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, c, HEADS * FOLD_L).contiguous()
            vw = t["vw4"].view(b, HEADS * FOLD_L, c)
            out["fold_wide"].append(dict(shape=[b, n, FOLD_L, c, "b7"], library=None,
                                         kernel=takes(lambda: fold_attention.fold_attention(
                                             t["x"], wt, vw, *vecs, HEADS), other)))
    for i, (b, n) in enumerate(FOLD_BN if {"fold", "fold_b7"} & set(kinds) else ()):
        t = fold_inputs(b, n, seed=600 + i)
        vecs = (t["gamma"], t["beta"], t["b_out"])
        if "fold" in kinds:
            out["fold"].append(dict(shape=[b, n, FOLD_L], kernel=three_ways(
                lambda: fold_attention.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs),
                per_call=1),
                library=None))
        if (b, n) in FOLD_B7_BN and "fold_b7" in kinds:
            wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, D, HEADS * FOLD_L).contiguous()
            vw = t["vw4"].view(b, HEADS * FOLD_L, D)
            out["fold_b7"].append(dict(shape=[b, n, FOLD_L], kernel=three_ways(
                lambda: fold_attention.fold_attention(t["x"], wt, vw, *vecs, HEADS), per_call=1),
                library=None))
    for i, (b, h, w, c, g, silu) in enumerate(GN_SHAPES if "groupnorm" in kinds else ()):
        x, s_, bi = norm_inputs((b, h, w, c), seed=400 + i)
        nchw, ws, bs = x.permute(0, 3, 1, 2), s_.bfloat16(), bi.bfloat16()
        if silu:
            library = lambda: F.silu(F.group_norm(nchw, g, ws, bs, 1e-6))
        else:
            library = lambda: F.group_norm(nchw, g, ws, bs, 1e-6)
        out["groupnorm"].append(dict(
            shape=[b, h, w, c, g, silu],
            kernel=three_ways(lambda: groupnorm.fused_groupnorm(x, s_, bi, g, 1e-6, silu)),
            library=three_ways(library)))
        del x, nchw
    if deep:
        out["resources"] = resources(str(lib))
        out["clusters"] = dict(
            ffn={m: ffn.cluster_size(m, INNER) for m in FFN_M},
            groupnorm={str(s[:4]): groupnorm.route(torch.empty(s[0], s[1] * s[2], s[3],
                                                               device="meta"), s[4])
                       for s in GN_SHAPES})
        out["clusters"]["ffn_bwd"] = {m: ffn.bwd_plan(m, D, INNER) for m in FFN_BWD_M}
        out["clusters"]["ffn_bwd_wide"] = {f"{m}, {d}": ffn.bwd_plan(m, d, 4 * d)
                                           for m, d in FFN_BWD_WIDE}
        if hasattr(gn_conv, "plan"):
            out["clusters"]["conv"] = {str(s): gn_conv.plan(*s, 32) for s in CONV_SHAPES}
        out["clusters"]["fold_ctas"] = {
            str(bn): fold_attention.ctas(bn[0], bn[1], D, FOLD_L) for bn in FOLD_BN}
        out["clusters"]["fold_wide_ctas"] = {
            str(bn): fold_attention.ctas(bn[0], bn[1], FOLD_WIDE_C, FOLD_L) for bn in FOLD_WIDE_BN}
        if "groupnorm" in kinds:
            out["gn_routes"] = gn_routes(groupnorm)
        if "conv" in kinds and hasattr(gn_conv, "plan"):
            out["conv_plans"] = conv_sweep(gn_conv)
        if "attention" in kinds:
            out["sweep"] = sweep(attention, scale)
    # last: after profiling a training step's thousands of kernels, traces of
    # one-kernel calls came back short on the card
    for i, fold in enumerate((False, True) if "train_step" in kinds else ()):
        out["train_step"].append(train_step(fold, seed=800 + i))
    return out


def gn_routes(groupnorm) -> list[dict]:
    """B.5's kernel time at every route, at the UNet's B=128 sites, its
    first B=16 site and the VAE site: cluster of 1, 2, 4, 8 CTAs a sample,
    x kept in shared memory (where it fits) or read twice; and, for the
    route ``wd_groupnorm`` picks, the time to the end of pass 1 (read and
    sums) and of the statistics (group sums, cluster exchange)."""
    import ctypes

    import torch

    lib = groupnorm._lib()
    fn = lib.wd_groupnorm_routed
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 4 + [ctypes.c_float] + [i] * 4 + [p]
    fn.restype = i
    rows = []
    for k, (b, h, w, c, g, silu) in enumerate(
            [s for s in GN_SHAPES if s[0] == 128] + [GN_SHAPES[0], GN_SHAPES[-1]]):
        x, sc, bi = norm_inputs((b, h, w, c), seed=500 + k)
        out = torch.empty_like(x)

        def run(cl, keep, stop=0):
            err = fn(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), b, h * w, c, g,
                     1e-6, int(silu), cl, keep, stop, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"wd_groupnorm_routed failed ({err})")

        times = {}
        for cl in (1, 2, 4, 8):
            for keep in (1, 0):
                if keep and 16 * g + 2 * 256 * 8 * 4 + -(-h * w // cl) * c * 2 > 112 * 1024:
                    continue
                times[f"{cl}{'kept' if keep else 'reread'}"] = kernel_ms(lambda: run(cl, keep))[0]
        cl, kept = groupnorm.route(x, g)
        phases = {name: kernel_ms(lambda: run(cl, int(kept), stop))[0]
                  for name, stop in (("pass1", 1), ("stats", 2), ("whole", 0))}
        rows.append(dict(shape=[b, h, w, c, g, silu], picked=[cl, kept], routes=times,
                         phases=phases, bound_ms=4 * x.numel() / 3.35e12 * 1e3))
    return rows


def conv_sweep(gn_conv) -> list[dict]:
    """B.6's times by all four methods at the UNet's sites (8 x 32 and 4 x 16
    at C=320, 4 x 16 at C=640; B=16 and 128) on every plan (pixels x channels
    a CTA, K split) whose channels divide C, through
    ``wd_gn_silu_conv3x3_planned``; the plan the kernel picks is marked."""
    import ctypes

    import torch

    lib = gn_conv._lib()
    fn = lib.wd_gn_silu_conv3x3_planned
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float] + [i] * 3 + [p]
    fn.restype = i
    rows = []
    for k, (b, h, w, c) in enumerate(s for s in CONV_SHAPES if s[1:] in (
            (8, 32, 320), (4, 16, 320), (4, 16, 640))):
        x, sc, bi, wt, cb = conv_inputs(b, h, w, c, seed=700 + k)
        wk = gn_conv.kernel_weight(wt)
        out = torch.empty_like(x)
        stats = torch.empty(b * 32 * 2, dtype=torch.float32, device=x.device)
        picked = gn_conv.plan(b, h, w, c, 32)
        times = {}
        for px, bn, split in ((128, 160, 0), (128, 128, 0), (128, 64, 0), (64, 160, 1),
                              (64, 128, 1), (64, 64, 1)):
            if c % bn:
                continue

            def run():
                err = fn(x.data_ptr(), sc.data_ptr(), bi.data_ptr(), wk.data_ptr(), cb.data_ptr(),
                         out.data_ptr(), stats.data_ptr(), b, h, w, c, 32, 1e-6, px, bn, split,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"wd_gn_silu_conv3x3_planned failed ({err})")

            # the statistics launch first where a sample's CTAs exceed a cluster
            ctas = (-(-h // (px // (16 if w <= 16 else 32)))) * (-(-w // (16 if w <= 16 else 32)))
            per_call = 1 if ctas * -(-c // bn) <= 8 else 2
            t = three_ways(run, per_call=per_call)
            del t["split"]
            times[f"{px}px x {bn}{' split' if split else ''}"] = t
        rows.append(dict(shape=[b, h, w, c], picked=picked, times=times))
    return rows


def train_step(fold: bool, seed: int) -> dict:
    """One training step of the ``iam`` preset (``fold``: with
    ``attn_fold_context``) at full width, B=128, seeded weights and latents,
    as the Trainer runs it (forward, backward, AdamW, EMA): its device time
    by the three methods, and the kernels' time by name."""
    import dataclasses

    import torch

    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
    from worddiffusion_tpu_torch.train.step import make_train_step

    exp = presets.iam()
    exp = exp.replace(unet=dataclasses.replace(exp.unet, attn_fold_context=fold or None))
    torch.manual_seed(seed)
    model = UNet(exp.unet).cuda()
    state = TrainState.create(model, make_optimizer(model.parameters(), 1e-4))
    d = exp.diffusion
    step = make_train_step(NoiseSchedule.linear(d.num_steps, d.beta_start, d.beta_end), exp)
    g = torch.Generator().manual_seed(seed)
    batch = dict(latent=0.8 * torch.randn(TRAIN_B, 8, 32, 4, generator=g),
                 context=torch.randint(1, 53, (TRAIN_B, exp.unet.max_seq_len), generator=g),
                 writer=torch.randint(0, 339, (TRAIN_B,), generator=g))
    batch = {k: v.cuda() for k, v in batch.items()}
    return dict(shape=["iam_fold" if fold else "iam", TRAIN_B],
                kernel=three_ways(lambda: step(state, batch)), library=None)


def resources(lib: str) -> list[dict]:
    """``cuobjdump -res-usage`` of each instance of the attention kernel at
    D=80, the FFN kernel and the GroupNorm cluster kernel, and the CTAs per
    SM its registers and shared memory allow (65536 registers a SM,
    allocated per warp in units of 256; 228 KB of shared memory a SM, 1 KB
    of it reserved per CTA; at most 2048 threads). The dynamic shared memory:
    the attention kernel's from its tile, the FFN kernel's from the library
    (``wd_ln_geglu_ffn_plan``), the GroupNorm kernel's at most FIT_BYTES."""
    import ctypes

    cuobjdump = os.path.join(os.path.dirname(os.path.dirname(build_nvcc())), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True, text=True,
                          check=True).stdout
    cdll = ctypes.CDLL(lib)
    rows = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Function" not in line or i + 1 >= len(lines):
            continue
        extra = {}
        usage = dict((k, int(v)) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                        lines[i + 1]))
        m = re.search(r"attention_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", line)
        if m and (int(m.group(1)) == D_HEAD or int(m.group(1)) > 128):
            dh, kc, nwg, fast = (int(m.group(1)), int(m.group(2)), int(m.group(3)),
                                 m.group(4) == "1")
            warps = 4 * nwg + 1  # the consumer warpgroups and the producer warp
            name = f"attention<{dh}, {kc} keys, {nwg} warpgroups{', fast' if fast else ''}>"
            # the plan of a shape that takes this instance: Nk = the chunk (or
            # past it), and Nq = 64 (one warpgroup) or 128 over enough pairs to
            # fill the card (two)
            plan = (ctypes.c_int * 8)()
            for nk in (kc, 2 * kc + 1):  # one chunk, or the longer contexts' chunk
                if cdll.wd_attention_plan(1024, 64 * nwg, nk, dh, plan):
                    raise RuntimeError("wd_attention_plan refused a shape")
                if plan[1] == kc:
                    break
            dyn = plan[3]
            # setmaxnreg splits the launch's registers: the producer's and the consumers'
            extra = dict(producer_regs=plan[6], consumer_regs=plan[7], q_slots=plan[4],
                         kv_stages=plan[5])
        elif m := re.search(r"ffn_kernelILi(\d+)ELb([01])E", line):
            # B.1 (LN) / B.2 (bare) of width d: its plan's threads and shared
            # memory (wd_ln_geglu_ffn_plan)
            plan = (ctypes.c_int * 5)()
            if cdll.wd_ln_geglu_ffn_plan(int(m.group(1)), plan):
                raise RuntimeError("wd_ln_geglu_ffn_plan refused a width")
            warps, dyn = plan[1] // 32, plan[0]
            name = f"ffn<{m.group(1)}, {'LN' if m.group(2) == '1' else 'bare'}>"
            extra = dict(warpgroups=plan[2], stages=plan[3], w2_ring=plan[4])
        elif "gn_cluster_kernel" in line:
            warps, name, dyn = 8, "gn_cluster", 112 * 1024
        elif m := re.search(r"ffn_bwd_(rows|gate|dxn|weights)_kernelILi(\d+)EE", line):
            # B.3's warp-specialised kernels at width d (2 consumer warpgroups
            # and the producer): A (rows) or S1 (gate), S2 (dxn), B (weights)
            d = int(m.group(2))
            which = {"rows": 0, "gate": 0, "weights": 1, "dxn": 2}[m.group(1)]
            warps, name = 12, f"ffn_bwd_{m.group(1)}<{d}>"
            dyn = cdll.wd_ln_geglu_ffn_bwd_smem(which, d)
        elif m := re.search(r"ffn_bwd_(norm|ln)_kernelILi(\d+)EE", line):
            warps, name, dyn = 8, f"ffn_bwd_{m.group(1)}<{m.group(2)}>", 0
        elif m := re.search(r"conv_kernelILi(\d+)ELb([01])E", line):
            # B.6: two consumer warpgroups and the producer; the largest plan's
            # shared memory of its instances (the UNet's and the VAE's sites)
            warps, name = 12, f"conv<{m.group(1)}, {'K split' if m.group(2) == '1' else '128 px'}>"
            dyn = max((p["smem"] for p in conv_plans() if p["channels"] == int(m.group(1))
                       and p["k_split"] == int(m.group(2))), default=0)
        elif m := re.search(r"fold_attention_(wide_)?kernelILi(\d+)EE", line):
            lp, c = int(m.group(2)), FOLD_WIDE_C if m.group(1) else D
            warps, name = 8, f"fold_attention{'_wide' if m.group(1) else ''}<{lp}>"
            dyn = cdll.wd_fold_attention_smem(c, lp)
            extra = dict(slots=cdll.wd_fold_attention_slots(c, lp))
        else:
            continue
        per_warp = -(-usage["REG"] * 32 // 256) * 256
        ctas = min(65536 // (per_warp * warps), (228 * 1024) // (dyn + usage["SHARED"] + 1024),
                   2048 // (32 * warps), 32)
        rows.append(dict(kernel=name, warps=warps, dynamic_shared=dyn, ctas_per_sm=ctas,
                         warps_per_sm=ctas * warps, **usage, **extra, raw=lines[i + 1].strip()))
    return rows


def conv_plans() -> list[dict]:
    """B.6's plan at every shape of CONV_SHAPES."""
    from worddiffusion_tpu_torch.ops import gn_conv

    return [gn_conv.plan(*s, 32) for s in CONV_SHAPES]


def build_nvcc() -> str:
    from worddiffusion_tpu_torch.ops import build

    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    return nvcc


def sweep(attention, scale: float) -> dict:
    """B.4 and SDPA device time over Nk at B=128, Nq=256, and a least-squares
    line through each: fixed ms + ms per key chunk of the kernel's plan
    (``attention.plan``'s keys a chunk at each Nk)."""
    import torch.nn.functional as F

    rows = []
    for i, nk in enumerate(SWEEP_NK):
        q, k, v = attn_inputs(128, 256, nk, seed=200 + i)
        rows.append(dict(nk=nk, chunk_keys=attention.plan(128 * HEADS, 256, nk, D_HEAD)["keys"],
                         kernel_ms=kernel_ms(lambda: attention.fused_attention(q, k, v, scale))[0],
                         library_ms=kernel_ms(
                             lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))[0]))
    chunks = [-(-r["nk"] // r["chunk_keys"]) for r in rows]
    fit = {}
    for key in ("kernel_ms", "library_ms"):
        slope, intercept = statistics.linear_regression(chunks, [r[key] for r in rows])
        fit[key] = dict(fixed_ms=intercept, ms_per_chunk=slope)
    return dict(rows=rows, fit=fit)


def run_order(here: str, other: str | None, rounds: int = 1) -> list[tuple[str, bool]]:
    """The worker processes, (tree, deep) in turn: other, this, this, other,
    and in a second round this, other, other, this; this tree alone without
    ``other``. One of this tree's runs is the deep one."""
    if other is None:
        return [(here, True)]
    order = [(other, False), (here, True), (here, False), (other, False)]
    return order + [(here, False), (other, False), (other, False), (here, False)][:4 * (rounds - 1)]


def run_tree(tree: str, deep: bool, kinds: tuple[str, ...] = KINDS, other: bool = False) -> dict:
    """One worker process on ``tree``'s package."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", os.path.abspath(tree),
           "--kinds", ",".join(kinds)]
    if deep:
        cmd.append("--deep")
    if other:
        cmd.append("--other-tree")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"worker on {tree} failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def summary(runs: list[dict]) -> list[str]:
    """Per kind, shape and method: each tree's time (the mean of its runs),
    the library's where the kind has one, other / this, and each tree's
    least and most run."""
    lines = []
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r)
    (other, o_runs), (this, t_runs) = by_tree.items()

    def spread(tree_runs, kind, j, method):
        v = [r[kind][j]["kernel"][method] for r in tree_runs]
        return statistics.mean(v), f"{min(v):.4f}-{max(v):.4f}"

    for kind in KINDS:
        if not o_runs[0].get(kind):
            continue  # timed in this tree only
        for j, row in enumerate(t_runs[0].get(kind, [])):
            if any(r[kind][j]["kernel"] is None for r in o_runs):
                lines.append(f"{kind} {row['shape']}: " + "; ".join(
                    f"{m} this {spread(t_runs, kind, j, m)[0]:.4f}" for m in METHODS)
                    + " (other: not taken)")
                continue
            parts = []
            for method in METHODS:
                (t, t_range), (o, o_range) = (spread(t_runs, kind, j, method),
                                              spread(o_runs, kind, j, method))
                part = f"{method} this {t:.4f} other {o:.4f} ({o / t:.2f}x)"
                if row["library"] is not None:
                    lib = statistics.mean(r[kind][j]["library"][method] for r in t_runs)
                    part += f" library {lib:.4f}"
                parts.append(part + f" runs this {t_range} other {o_range}")
            lines.append(f"{kind} {row['shape']}: " + "; ".join(parts))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", help="another tree: its worddiffusion_tpu_torch is timed too")
    p.add_argument("--out", default="build/kernel_times.json")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--deep", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--other-tree", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rounds", type=int, choices=(1, 2), default=1,
                   help="2: run the trees again in the reverse order")
    p.add_argument("--kinds", default=",".join(KINDS),
                   help=f"comma-separated kinds to time (default all: {','.join(KINDS)})")
    args = p.parse_args(argv)
    kinds = tuple(k for k in args.kinds.split(",") if k)
    if unknown := set(kinds) - set(KINDS):
        p.error(f"unknown kinds {sorted(unknown)}")
    if args.worker:
        print(json.dumps(worker(args.worker, args.deep, kinds, args.other_tree)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = [run_tree(tree, deep, kinds, tree == args.other)
            for tree, deep in run_order(here, args.other, args.rounds)]
    result = dict(device=smi, runs=runs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    deep = next(r for r in runs if "resources" in r)
    for r in deep["resources"]:
        print("resources", json.dumps(r))
    print("clusters", json.dumps(deep["clusters"]))
    for r in deep.get("gn_routes", []):
        print("groupnorm routes", json.dumps(r))
    for r in deep.get("conv_plans", []):
        print("conv plans", json.dumps(r))
    for w32, w16 in zip(deep["ffn"], deep["ffn_bf16"]):
        print(f"ffn {w32['shape']} fp32 weights (two cast copies) / bf16 weights: " + "; ".join(
            f"{m} {w32['kernel'][m]:.4f} / {w16['kernel'][m]:.4f}" for m in METHODS))
    if "sweep" in deep:
        print("attention Nk sweep", json.dumps(deep["sweep"]))
    for r in runs:
        for kind in ("ffn_bwd", "conv", "fold", "fold_b7", "train_step", "ffn_bwd_wide",
                     "fold_wide"):
            for row in r.get(kind, []):
                k = row["kernel"]
                if k is None:
                    print(f"{r['tree']} {kind} {row['shape']}: not taken")
                    continue
                print(f"{r['tree']} {kind} {row['shape']}: " + "; ".join(
                    f"{m} {k[m]:.4f}" for m in METHODS)
                    + " | by kernel " + ", ".join(f"{n} {v:.4f}" for n, v in sorted(
                        k["split"].items(), key=lambda nv: -nv[1])[:12]))
    if args.other:
        for line in summary(runs):
            print(line)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        # the tree under test first on the path, in place of this file's
        # directory, so that its own package is the one imported
        sys.path[0] = sys.argv[sys.argv.index("--worker") + 1]
    sys.exit(main())
