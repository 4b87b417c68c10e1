#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (worddiffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: needs CUDA; prints the card's nvidia-smi name and power limit;
   TF32 off for the comparisons.
2. build: compiles the CUDA kernels from ``worddiffusion_tpu_torch/csrc``.
3. kernel vs plain: the fused LN + GEGLU FFN kernel (B.1, a cluster launch
   on ``wgmma``) against its plain PyTorch version at the main path's shapes
   (d=320, inner=1280, M = 16*256, 16*64), a ragged M and the small M = 64
   and 65, with errors, bitwise repeatability, the cluster size and median
   times; then
   the bare GEGLU FFN (B.2, ``ops.ffn.fused_geglu_ffn``, the same kernel
   without LayerNorm and residual; no path calls it, as in JAX) at
   M = 16*256, 128*256 and a ragged 1000: against its plain version,
   bitwise repeatability, kernel / plain / bound times, and its Function's
   output and five gradients against plain autograd at M = 128*256.
4. whole UNet: one full-width ``iam`` UNet call with every kernel against
   the all-plain UNet (``use_pallas_ffn=False``, the plain attention and
   the plain GroupNorm / GN -> SiLU -> conv swapped in) on the same weights
   and inputs; launches per call (4 FF, 8 attention, 9 B.5, 12 B.6); call
   times and profiled device busy time with all kernels, with plain B.5
   and B.6, and all plain; the profiled kernels per call by name (one B.5
   kernel and one B.1 kernel per site, B.5's old three-kernel pass gone) and
   in all (UNET_KERNELS).
5. main path: the regeneration CLI's pipeline (Regenerator + WordSampler,
   ``iam`` UNet, default VAE and CTC recognizer, seeded random weights)
   over 40 words in batches of 16, with the 600-step skip-step schedule
   and the deterministic update; checks shapes, finiteness, the PNGs and
   that every FF sub-layer, attention and GroupNorm went through its kernel
   (per batch also the VAE decode's 4 B.5 + 26 B.6 and the OCR's 10 B.5);
   then single batches with the attention kernel and with the plain
   attention in turns, for s/batch with and without it.
6. FFN forward + backward, kernel against plain: the forward and the
   backward kernel (B.3: rows, weight gradients and partial sums, on
   ``wgmma``; its cluster size printed) against their plain versions at the
   training shapes, M = 128*256, 128*64 and a ragged 1000 (the output and
   seven gradients, each within its tolerance), bitwise repeatability of
   both, each beside its bound, and the autograd Function (both kernels)
   against plain autograd at the two training M (output and gradients),
   with median times, the pair against plain autograd at M = 128*256.
7. training main path: the train CLI's Trainer (``iam`` preset at full
   width, B=128, seeded random weights) on a latent cache of seeded
   latents, 2 epochs with a checkpoint and a DDIM-50 preview each; then
   a max_steps stop and a resume. Checks the loss, the update, the EMA,
   4 backward-kernel launches per step, the checkpoint round trip, that
   the EMA loads as the regeneration UNet and that the resumed run is
   bitwise the uninterrupted one; times s/step with the kernels and with
   the plain FF. Every attention runs the attention kernel forward (8 per
   step and per preview call) and its Function's plain backward (8 per
   step). Then three steps on a fresh state under ``torch.profiler``: the
   step's device busy time, and per step 4 B.1 kernels, 4 of each of B.3's
   three and 8 attention kernels, by name.
8. attention kernel vs plain: the fused attention against its plain
   version at the shapes of every path (4 heads of 80; regeneration B=16
   and training B=128; Nq 256 and 64; Nk 42 for ``iam``, Nq for the
   self-attention and 42 + 769 = 811 for the cross-attention of
   ``iam_phosc``), a ragged case and a 2048-key context, with errors,
   bitwise repeatability, and kernel / plain / ``scaled_dot_product_attention``
   / bound times and the kernel's share of its bound; the Function's output
   and gradients against plain autograd at B=128, Nq=256, Nk=811.
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
   B.8's per-head [B, H, C, L], as ``build_folds`` lays them out and with
   the L stride padded to 8) against its plain version at the fold path's
   shapes (C=320, H=4, L=42; B 16 and 128; N 256 and 64) and a ragged one, bitwise
   repeatability and the layouts bitwise equal, its route at each shape
   (rows a tile, CTAs a cluster splitting the heads, how wt's rows are
   copied), and the Function's gradients against plain autograd; kernel,
   plain and bound times.
12. fold regeneration: the regeneration CLI with ``--preset iam_fold``
   (``iam`` with ``attn_fold_context``, registered in the port's presets):
   one UNet call with the fold kernel against the plain fold, and against
   the unfolded ``iam`` UNet on the same weights; then the pipeline as in
   phase 5 with 8 fold, 0 attention and 4 FF launches per call; single
   batches with the fold kernel and the plain fold in turns.
13. fold training: the train CLI with ``--preset iam_fold`` at B=128 on
   the phase-7 latent corpus, 2 epochs of 10 steps, twice: 8 fold
   launches, 8 fold backward calls and 4 FF backward launches per step,
   the two runs bitwise equal; s/step and peak memory; then three steps
   profiled as in phase 7 (8 fold kernels a step, no attention kernel).
14. GroupNorm (+ SiLU) (B.5, ``ops.groupnorm``) and GN -> SiLU -> conv3x3
   (B.6, ``ops.gn_conv``) against their plain versions at every site's
   shape (UNet B=16 and 128, VAE decoder B=16 and encoder B=128, ragged
   C=48 and 5x13, and both sides of the size where a CTA's range of x stops
   fitting in shared memory), B.5's route (cluster size; x kept in shared
   memory or read twice), bitwise repeatability, kernel / plain / library (stock
   ``F.group_norm`` [+ ``F.silu``]; ``F.group_norm`` -> ``F.silu`` ->
   cuDNN ``F.conv2d``) / bound times, B.6's tile and its share of its bound,
   and both Functions' gradients against plain autograd at [128, 8, 32, 320].
15. the whole SD VAE at full width on seeded weights: encode (B=128) and
   decode (B=16) all-kernel against all-plain, 18 B.6 + 4 B.5 launches per
   encode and 26 + 4 per decode, times.
16. the latent-cache CLI (``cli.build_latent_cache``) over
   N_IMAGES seeded word PNGs (grey and RGB, 30-150 x 20-600, written by the
   port's PNG writer, resized on the host) with ``--stable_dif_path`` (a
   safetensors file of the seeded VAE), B=64, ``--deterministic 1``: the npz
   against a direct posterior-mean encode, launches per batch, images/s;
   then one regeneration batch through the regeneration CLI's main with
   ``--stable_dif_path`` (that file's decode half) and ``--ddim 50``: 50 UNet
   calls.
17. training from those images through the train CLI (no
   ``--latent_cache``): B=128, 2 epochs of 3 steps, each step one encode
   (4 B.5 + 18 B.6) and the UNet's forward and plain-recompute backwards;
   launches, loss, update, EMA, a max_steps stop and a bitwise resume;
   s/step against latent-cache training on phase 16's cache; peak memory.
18. the ResBlock variants: one full-width ``iam`` UNet call at B=16 with
   FiLM ResBlocks, with the split decoder skip and with both, on seeded
   weights (the zero-initialised convs too), each all-kernel against
   all-plain as in phase 4, with its B.5 / B.6 launches per call (17 / 4,
   9 / 12, 17 / 4: FiLM's out_layers run B.5 without SiLU; the split skip
   runs the concat form, the same math) and by profiled kernel name.
19. conditioned training through the train CLI at full width, B=128, on
   the phase-7 latents, 2 epochs of 3 steps with one checkpoint and one
   DDIM-50 preview: (a) ``--ocrTraining 1 --imgConditioned 1`` (the CTC
   aux head's 4 B.5 a call, its loss finite, the head and conv_in's
   reference-latent channels trained, a max_steps stop and a resume
   bitwise the uninterrupted run); (b) ``--wrdChrWrStyl 1 --style_dict``
   (a seeded 4096-d vector per writer; the style projection trained, every
   attention at Nk = 1). Launches per step and per preview, 3 profiled
   steps each (4 B.1, 4 of each of B.3's three, 8 attention kernels),
   s/step and peak memory.
20. the sampling CLI (``cli.sample.main``) at full width with phase 16's
   VAE, 6 words, DDIM-50: seeded weights with ``--writer 3 --writer2 7
   --mix_rate 0.5 --cfg_scale 3`` (100 UNet calls); ``--imgConditioned 1
   --cond_image`` (a phase-16 PNG, encoded once) on phase 19(a)'s EMA
   checkpoint; ``--wrdChrWrStyl 1`` on 19(b)'s. Each: the PNGs under the
   JAX CLI's names, launches, s/batch.
21. the PHOSC zero-shot recognizer at full width (PHOSCNet(trunk="resnet18"):
   phos 165, phoc 604, hidden 4096, bf16, seeded weights, B=64, 50x250):
   (a) one forward all-kernel against all-plain, 16 B.5 launches (every
   GroupNorm input channels_last, so no copy), by profiled kernel name 16
   ``gn_cluster_kernel`` and no library GroupNorm, device busy time; (b)
   ``cli.train_phosc.main`` --model resnet18, 2 epochs at B=64 on 256 seeded
   word PNGs over 32 words (64 over 8 unseen words validate): 16 B.5 launches
   and 16 GroupNormFn backward calls a step, the parameters moved, log.csv,
   ``best_params.pkl`` in the JAX layout, s/step, peak memory, 3 profiled
   steps; (c) ``cli.train_charcounter.main`` (VGG, 1 epoch, no kernel), then
   ``train_phosc --mode test --len_counter``: every testresults.txt value
   finite, images/s; (d) that checkpoint in a fresh model on the card (bf16)
   against the host (fp32); (e) ``--model vgg``, 1 epoch of 2 steps.
22. the synthetic renderer and the side models at full width: (a) the
   PIL-free ``render_word`` against the committed check renders
   (``data/render_check.npz``: 6 settings x 532 words, bitwise) and its
   host ms per image at 64x256 and 50x250; (b) phase 14's rows at the
   style encoder's 11 B.5 sites at B=48 (C = 64 in groups of 2 at 16x64 to
   C = 2048 at 2x8) and the OCR's 5 at train_ocr's B=32; (c)
   ``StyleEncoder(out_dim=4096)`` at B=48 all-kernel against all-plain, 48
   B.5 launches and 48 ``gn_cluster_kernel`` a forward by profiled name; (d)
   ``cli.train_style.main --synthetic 1`` (B=16 triplets, 8 steps; 48 x 3
   GroupNormFn backwards a step), its ``style_dict.npz`` conditioning one
   ``cli.train --wrdChrWrStyl 1`` step, and ``--allow_random_style 1``; (e)
   ``cli.train_ocr.main --synthetic 1`` (B=32, 4 steps, 10 B.5 and 10
   backwards a step, the held-out exact match), its ``ocr.pt`` read by one
   regeneration batch through ``--ocr_pt``; (f) ``cli.train_vae.main
   --synthetic 1`` at SD's widths, B=16, 2 epochs of a step (8 B.5 and 44 B.6 a forward, as many
   backwards a step), its ``vae.pt`` read by ``build_latent_cache --synthetic
   1 --vae_pt``; (g) ``cli.train --synthetic 1 --charImages 1`` at ``iam``
   width, B=32, 4 steps and a DDIM-10 preview, a bitwise resume; (h)
   ``cli.evaluate.main`` over phase 16's PNGs against phase 16's regeneration
   dump with a seeded torchvision-layout Inception (first held on the card
   against the host, fp32 with TF32 off), phase 21's PHOSC checkpoint and
   (e)'s OCR, then the style-encoder fallback: every JSON key, images/s per
   featurizer; (i) ``masked_ddpm_sample`` with the ``iam``
   UNet, B=16, 599 calls.

Every training phase counts 9 B.5 and 12 B.6 launches and Function
backward calls per step (13 B.5 with the CTC aux head), and 9 * 50 + 4 and
12 * 50 + 26 per DDIM-50 preview. Phase 14 also runs B.5 at the CTC head's
[128, 8, 32, 256] and at the PHOSC trunk's four sites (B=64: 25x125 C=64,
13x63 C=128, 256 and 512), and B.5's Function at [64, 25, 125, 64]. Kernel,
plain and library times are per call over 10 calls back to back
(``launch_ms``), so that the host's launch path overlaps the device work.

The second-to-last line is a JSON summary of the kernels (each with its
bound: the larger of its bytes over the card's memory rate and its
operations over its bf16 tensor rate, from the published H100 SXM
figures); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from unittest import mock

T_START = time.perf_counter()
D, INNER, B = 320, 1280, 16
FFN_SHAPES = (B * 256, B * 64, 1000)   # M: full-res blocks, middle block, ragged
FFN_SMALL_SHAPES = (64, 65)            # one row tile, and one row past it
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
    (4, 256, 2048),                                           # a long context
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
# GroupNorm (+ SiLU), B.5, per call: 9 in a UNet call (the 4 output ResBlocks'
# 640-channel in_layers and the out norm with SiLU, the 4 SpatialTransformer
# norms), 4 in each VAE encoder or decoder call, 10 in an OCR call (2 per conv
# block). GN -> SiLU -> conv3x3, B.6, per call: 12 in a UNet call, 18 in a VAE
# encoder call, 26 in a decoder call. As (B.5, B.6):
UNET_NORMS, ENCODER_NORMS, DECODER_NORMS, OCR_NORMS = (9, 12), (4, 18), (4, 26), (10, 0)
# The ResBlock variants' UNet calls, as (B.5, B.6): FiLM moves the 8 out_layers
# from B.6 to B.5 without SiLU (a stock conv after the modulation); the split
# skip runs the concat form (the same math on the same parameters), so it
# keeps iam's counts. The CTC aux head adds 4 B.5 (32 groups, eps 1e-6, no
# SiLU) a call.
VARIANT_NORMS = {"film": (17, 4), "split_skip": (9, 12), "film_split_skip": (17, 4)}
CTC_HEAD_NORMS = (4, 0)
COND_STEPS_PER_EPOCH = 3  # phase 19's training runs: 2 epochs of 3 steps
# The PHOSC recognizer (phase 21): PHOSCNet(trunk="resnet18") at the CLI's
# widths and batch; its 16 GroupNorms (32 groups, eps 1e-6, no SiLU) run B.5
# at [64, 25, 125, 64] x4 and [64, 13, 63, 128 / 256 / 512] x4 each.
PHOSC_B, PHOSC_NORMS = 64, 16
PHOSC_TRAIN, PHOSC_VALID = 256, 64  # phase 21's word PNGs: 32 trained words, 8 unseen
# bf16 recognizer all-kernel vs all-plain: each of the 16 B.5 outputs may
# round one bf16 ulp (0.4%) away from the plain version's, carried through
# the bf16 convs after it, as in the UNet: 3% of max |plain|.
PHOSC_REL_TOL = 3e-2
# The bf16 recognizer on the card against the fp32 one on the host (the same
# carried weights): every conv, Dense and GroupNorm output rounded to bf16
# (8 significant bits) over 17 convs and 3 Dense layers: 5% of max |fp32|.
PHOSC_BF16_TOL = 5e-2
# The writer-style encoder (phase 22): StyleEncoder(out_dim=4096) at one
# triplet batch, its 48 GroupNorms (min(32, C) groups, eps 1e-6, no SiLU) B.5.
STYLE_B, STYLE_NORMS = 48, 48
# bf16 encoder all-kernel vs all-plain: 48 B.5 outputs, each one bf16 rounding
# (0.4%) away from the plain version's at most, through 53 bf16 convs and the
# global max pool: 3% of max |plain|, as the PHOSC trunk's (measured on the
# H100 at B=48: 1.2%).
STYLE_REL_TOL = 3e-2
# (H, W, C) of its B.5 sites on 64x256 crops: the stage-entry 1x1 norms at the
# stage's input resolution, the 3x3 and expansion norms at its output (C = 64
# in 32 groups of 2 at 16x64 ... C = 2048 at 2x8, B.5's widest C)
STYLE_SITES = ((16, 64, 64), (16, 64, 256), (16, 64, 128), (8, 32, 128), (8, 32, 512),
               (8, 32, 256), (4, 16, 256), (4, 16, 1024), (4, 16, 512), (2, 8, 512),
               (2, 8, 2048))
# Inception on the card (fp32, TF32 off) against the host: the same
# arithmetic in other cuDNN / oneDNN orders, through 94 convs: 1e-4 of max |host|.
INCEPTION_TOL = 1e-4
# the OCR's 10 at train_ocr's B=32 (two a conv block: 64x256, 32x128, 16x64, 8x64, 4x64)
OCR_TRAIN_B = 32
OCR_SITES = ((64, 256, 64), (32, 128, 128), (16, 64, 256), (8, 64, 256), (4, 64, 512))
# (B, H, W, C, groups, silu) of B.5's sites: UNet regeneration (B=16) and
# training (B=128) at 8x32 and 4x16 (the 640-channel output ResBlocks with
# SiLU, the 320-channel transformer norms and the out norm); the VAE decoder
# (B=16) and encoder (B=128) sites (channel-changing norm1s with SiLU, the
# mid attention's norm, conv_norm_out with SiLU); a ragged C=48 in 48 groups.
GN_SHAPES = tuple(
    (b, h, w, c, 32, silu) for b in (B, TRAIN_B)
    for h, w, c, silu in ((8, 32, 640, True), (4, 16, 640, True), (8, 32, 320, False),
                          (4, 16, 320, False), (8, 32, 320, True))
) + ((B, 32, 128, 512, 32, True), (B, 64, 256, 256, 32, True), (B, 8, 32, 512, 32, False),
     (B, 64, 256, 128, 32, True), (TRAIN_B, 32, 128, 128, 32, True),
     (TRAIN_B, 16, 64, 256, 32, True), (TRAIN_B, 8, 32, 512, 32, False),
     (TRAIN_B, 8, 32, 512, 32, True), (2, 5, 13, 48, 48, False),
     # each side of the size where a CTA's range stops fitting in shared memory
     (2, 8, 95, 512, 32, False), (2, 8, 96, 512, 32, False),
     # the CTC aux head's norms at the training batch (eps 1e-6 as every row here)
     (TRAIN_B, 8, 32, 256, 32, False)) + tuple(
    # the PHOSC recognizer's resnet18 trunk at B=64 (16 a forward, 4 at each)
    (PHOSC_B, h, w, c, 32, False) for h, w, c in ((25, 125, 64), (13, 63, 128),
                                                  (13, 63, 256), (13, 63, 512))) + tuple(
    # the writer-style encoder at one triplet batch, and the OCR in training
    (STYLE_B, h, w, c, min(32, c), False) for h, w, c in STYLE_SITES) + tuple(
    (OCR_TRAIN_B, h, w, c, 32, False) for h, w, c in OCR_SITES)
# (B, H, W, C, groups) of B.6's sites: the UNet's two resolutions at B=16 and
# 128, the decoder's levels at B=16, the encoder's at B=128, a ragged image
# (5 x 13) and a ragged width (C=48 in 48 groups).
CONV_SHAPES = ((B, 8, 32, 320, 32), (B, 4, 16, 320, 32), (TRAIN_B, 8, 32, 320, 32),
               (TRAIN_B, 4, 16, 320, 32), (B, 8, 32, 512, 32), (B, 16, 64, 512, 32),
               (B, 32, 128, 256, 32), (B, 64, 256, 128, 32), (TRAIN_B, 64, 256, 128, 32),
               (TRAIN_B, 32, 128, 256, 32), (TRAIN_B, 16, 64, 512, 32),
               (TRAIN_B, 8, 32, 512, 32), (2, 5, 13, 64, 32), (2, 5, 13, 48, 48))
# Kernels per iam UNet call at B=16 (torch.profiler), each B.5 site one.
UNET_KERNELS = 422
# bf16 output after fp32 arithmetic in another order (and, for B.6, one bf16
# rounding of the activation): 1% of max |plain|. Measured on an H100 at these
# shapes: at most 0.33% (B.5) and 0.72% (B.6).
NORM_REL_TOL = 1e-2
# Whole VAE all-kernel vs all-plain (every B.5 and B.6 of 22 or 30 per call
# rounds differently, carried through the bf16 layers after it): 3% of max
# |plain|.
VAE_REL_TOL = 3e-2
N_IMAGES = 3 * TRAIN_B + 8  # word PNGs of phases 16-17: 3 training steps an epoch
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


def stamp(phase: str) -> None:
    """The whole run's seconds so far, after ``phase``."""
    log(f"[phase {phase} done at {time.perf_counter() - T_START:.1f} s]")


def launch_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time per call of ``fn()`` in ms: the median over ``reps`` of
    ``calls`` back-to-back calls between two CUDA events, divided by
    ``calls``, so that the host's launch path (tens of microseconds a call)
    overlaps the device work instead of adding to it; a kernel shorter than
    its launch path still shows the launch path."""
    return cuda_ms(lambda: [fn() for _ in range(calls)], reps=reps, warmup=1) / calls


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


@contextlib.contextmanager
def plain_norms():
    """Every GroupNorm (+ SiLU) and GN -> SiLU -> conv3x3 through its plain
    version: the references without B.5 and B.6."""
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    with mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference), \
            mock.patch.object(gn_conv, "fused_gn_silu_conv3x3", gn_conv.gn_silu_conv3x3_reference):
        yield


@contextlib.contextmanager
def all_plain():
    """Every kernel but the FF's (a config flag: ``use_pallas_ffn=False``)
    through its plain version."""
    with plain_attention(), plain_norms():
        yield


def norm_counts() -> tuple[int, int, int, int]:
    """(B.5 launches, B.6 launches, B.5 Function backwards, B.6 Function
    backwards) so far."""
    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    return groupnorm.launches, gn_conv.launches, groupnorm.bwd_calls, gn_conv.bwd_calls


def reset_counts() -> None:
    """Every kernel's launch and backward count to 0."""
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention, gn_conv, groupnorm

    ffn.launches = ffn.bwd_launches = ffn.geglu_launches = 0
    attention.launches = attention.bwd_calls = 0
    fold_attention.launches = fold_attention.bwd_calls = fold_attention.flat_launches = 0
    groupnorm.launches = groupnorm.bwd_calls = gn_conv.launches = gn_conv.bwd_calls = 0


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
        ms = launch_ms(lambda: attention.fused_attention(q, k, v, scale))
        plain_ms = launch_ms(lambda: attention.attention_reference(q, k, v, scale))
        # the yardstick: one PyTorch call of the same function (the port never calls it)
        library_ms = launch_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        bound_ms, bound_by = bound(nbytes(q, k, v, got), 4 * b * HEADS * nq * nk * D_HEAD)
        tile = attention._lib().wd_attention_tile_rows(b * HEADS, nq)
        log(f"attention B={b} H={HEADS} Nq={nq} Nk={nk} D={D_HEAD} ({tile}-query tile): "
            f"max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {ATTN_REL_TOL}); bitwise "
            f"repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"scaled_dot_product_attention {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {bound_ms / ms:.1%} of the bound [{smi}]")
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


GEGLU_SHAPES = (B * 256, TRAIN_B * 256, 1000)  # B.2: no path calls it; B.1's sites


def phase3_geglu(smi: str) -> dict:
    """B.2, the bare GEGLU FFN launch mode, against its plain version at
    B.1's shapes, bitwise repeatability, and its Function (kernel forward,
    autograd of the unfused composition backward, as JAX's custom_vjp)
    against plain autograd of that composition: output and five gradients."""
    import torch

    from worddiffusion_tpu_torch.ops import ffn

    rows = []
    for i, m in enumerate(GEGLU_SHAPES):
        t = ffn_inputs(m, seed=40 + i)
        a = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
        n0 = ffn.geglu_launches
        got, again = ffn.fused_geglu_ffn(*a), ffn.fused_geglu_ffn(*a)
        torch.cuda.synchronize()
        assert ffn.geglu_launches == n0 + 2, ffn.geglu_launches - n0
        want = ffn.geglu_ffn_reference(*a)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: ffn.fused_geglu_ffn(*a))
        plain_ms = launch_ms(lambda: ffn.geglu_ffn_reference(*a))
        bound_ms, bound_by = bound(nbytes(*a, got), 6 * m * D * INNER)
        log(f"geglu_ffn (B.2) M={m} d={D} inner={INNER}: max_abs_err {err:.6g} max_rel_err "
            f"{rel:.6g} (tol {FFN_REL_TOL}); bitwise repeatable {torch.equal(got, again)}; kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of the bound [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite B.2 output at M={m}"
        assert torch.equal(got, again), f"B.2 differs between two runs at M={m}"
        assert rel <= FFN_REL_TOL, f"B.2 kernel disagrees with plain at M={m}: rel {rel}"
        rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        del t, a, got, again, want

    m = TRAIN_B * 256
    t = ffn_inputs(m, seed=45)
    dy = (0.1 * torch.randn(m, D, generator=torch.Generator().manual_seed(46))).bfloat16().cuda()
    names = ("x", "w1", "b1", "w2", "b2")

    def fwd_bwd(fn):
        leaves = [t[k].clone().requires_grad_() for k in names]
        out = fn(*leaves)
        out.backward(dy)
        return [out.detach()] + [v.grad for v in leaves]

    got, want = fwd_bwd(ffn.fused_geglu_ffn), fwd_bwd(ffn.geglu_ffn_xla_baseline)
    torch.cuda.synchronize()
    for name, g, w in zip(("out",) + tuple("d" + k for k in names), got, want):
        err = (g.float() - w.float()).abs().max().item()
        share = err / w.float().abs().max().item()
        log(f"geglu_ffn Function vs plain autograd M={m} {name}: max_abs_err {err:.6g} share of "
            f"max |plain| {share:.6g} (tol {FFN_REL_TOL}); bitwise {torch.equal(g, w)}")
        assert g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all()), name
        assert share <= FFN_REL_TOL, f"B.2 Function disagrees: {name} {share}"
    return dict(rows=rows)


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
        got, again = ffn.fused_ln_geglu_ffn(**f), ffn.fused_ln_geglu_ffn(**f)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_reference(**f)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: ffn.fused_ln_geglu_ffn(**f))
        plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_reference(**f))
        bound_ms, bound_by = ffn_bound(f, got)
        log(f"ffn fwd M={m} (cluster of {ffn.cluster_size(m, INNER)}): max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {FFN_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) [{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at M={m}"
        assert torch.equal(got, again), f"B.1 differs between two runs at M={m}"
        assert rel <= FFN_REL_TOL, f"forward kernel disagrees with plain at M={m}: rel {rel}"
        fwd_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
        del f, got, again, want

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
        ms = launch_ms(lambda: ffn.ln_geglu_ffn_bwd(**a))
        plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_bwd_reference(**a))
        # the backward recomputes h = LN(x) W1 and does four more products of
        # the same size: 16 M d inner operations in all
        bound_ms, bound_by = bound(nbytes(*a.values(), *got), 16 * m * D * INNER)
        log(f"ffn bwd (B.3) M={m} (cluster of {ffn.bwd_cluster_size(m, INNER)}): kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of the bound [{smi}]")
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
                f"{plain_pair_ms:.4f} ms ({plain_pair_ms / pair_ms:.2f}x) [{smi}]")
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
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention
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
    preview_launches, preview_attn, preview_fold, preview_norms = count_previews(trainer)
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    state = trainer.run(epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before  # the run's own, above what lay there
    fwd, bwd, geglu = ffn.launches, ffn.bwd_launches, ffn.geglu_launches
    fold7 = fold_attention.flat_launches
    attn, attn_bwd = attention.launches, attention.bwd_calls
    gn, conv, gn_bwd, conv_bwd = norm_counts()

    ck = CheckpointManager(trainer.ckpt.directory)
    saved =torch.load(ck.path(steps), map_location="cpu", weights_only=True)
    loss = saved["metrics"]["loss"]
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    ff_keys = [k for k in changed if ".ff.net." in k and k.endswith("weight")]
    ema_equal = all(torch.equal(e, p) for e, p in
                    zip(state.ema.parameters(), state.model.parameters()))
    log(f"train: {state.step} steps of B={TRAIN_B} in {wall:.2f} s incl. 2 checkpoints and "
        f"2 DDIM-50 previews (peak memory above the run's start {peak / 2 ** 30:.3f} GiB); "
        f"epoch-1 loss {loss:.6g}; "
        f"ffn launches: {bwd} backward, {fwd - sum(preview_launches)} forward in steps, "
        f"{preview_launches} forward in previews; attention launches: "
        f"{attn - sum(preview_attn)} in steps, {preview_attn} in previews, {attn_bwd} Function "
        f"backward calls; max param change {max(changed.values()):.4g}; EMA == params: {ema_equal}")
    log(f"train: groupnorm (B.5) / gn_silu_conv3x3 (B.6) launches {gn} / {conv} ({preview_norms} "
        f"in previews), Function backward calls {gn_bwd} / {conv_bwd}")
    assert state.step == steps, state.step
    assert preview_norms == [preview_norm_launches()] * 2, preview_norms
    assert (gn, conv) == tuple(n * steps + 2 * p for n, p in
                               zip(UNET_NORMS, preview_norm_launches())), (gn, conv)
    assert (gn_bwd, conv_bwd) == tuple(n * steps for n in UNET_NORMS), (gn_bwd, conv_bwd)
    assert sorted(ck.steps()) == [TRAIN_STEPS_PER_EPOCH, steps], ck.steps()
    assert torch.isfinite(torch.tensor(loss)), loss
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert all(changed[k] > 0 for k in ff_keys) and len(ff_keys) == 8, ff_keys
    assert ema_equal, "the EMA must equal the parameters during warmup"
    assert bwd == 4 * steps and geglu == 0 and fold7 == 0, (bwd, geglu, fold7)
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
    prof = step_profile(smi, trainer, "iam", folds=0)
    return dict(fwd=fwd, bwd=bwd, geglu=geglu, fold_b7=fold7, attn=attn, gn=gn, conv=conv,
                s_per_step=k_s / k_n, peak_bytes=peak,
                plain_s_per_step=p_s / p_n, resume_diff=diff, step_busy_ms=prof["busy_ms"])


def preview_norm_launches() -> tuple[int, int]:
    """(B.5, B.6) launches of one DDIM-50 preview: 50 UNet calls and one
    decode (no OCR)."""
    return tuple(50 * u + d for u, d in zip(UNET_NORMS, DECODER_NORMS))


def count_previews(trainer) -> tuple[list, list, list, list]:
    """Wrap the trainer's preview: per preview, the FF, attention and fold
    attention kernel launches and the (B.5, B.6) launches it made (kept apart
    from the steps' own), and its images checked."""
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    ffn_n, attn_n, fold_n, norm_n = [], [], [], []
    preview = trainer.preview_fn

    def counted_preview(state, epoch):
        f0, a0, d0 = ffn.launches, attention.launches, fold_attention.launches
        n0 = norm_counts()
        imgs = preview(state, epoch)
        ffn_n.append(ffn.launches - f0)
        attn_n.append(attention.launches - a0)
        fold_n.append(fold_attention.launches - d0)
        norm_n.append(tuple(b - a for a, b in zip(n0[:2], norm_counts()[:2])))
        assert imgs.shape == (3, 64, 256, 3) and bool((imgs >= 0).all() & (imgs <= 1).all())
        return imgs

    trainer.preview_fn = counted_preview
    return ffn_n, attn_n, fold_n, norm_n


def phase10_phosc_train(smi: str, work: str, corpus: tuple[str, str]) -> dict:
    """The PHOSC model's training as the train CLI builds it from
    ``--preset iam --phosc 1``."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention
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
    preview_ffn, preview_attn, _, preview_norms = count_previews(trainer)
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}

    reset_counts()
    t0 = time.perf_counter()
    state = trainer.run(epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, geglu = ffn.launches, ffn.bwd_launches, ffn.geglu_launches
    fold7 = fold_attention.flat_launches
    attn, attn_bwd = attention.launches, attention.bwd_calls
    gn, conv, gn_bwd, conv_bwd = norm_counts()

    ck = CheckpointManager(trainer.ckpt.directory)
    loss =torch.load(ck.path(steps), map_location="cpu", weights_only=True)["metrics"]["loss"]
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    qkv = [k for k in changed if any(f".attn{i}.to_{w}." in k for i in (1, 2) for w in "qkv")]
    s_, n_ = trainer.epoch_seconds[1]
    log(f"train iam_phosc: {state.step} steps of B={TRAIN_B} in {wall:.2f} s incl. 1 checkpoint "
        f"and 1 DDIM-50 preview; last-epoch loss {loss:.6g}; attention launches "
        f"{attn - sum(preview_attn)} in steps, {preview_attn} in the preview, {attn_bwd} Function "
        f"backward calls; ffn launches {fwd - sum(preview_ffn)} forward and {bwd} backward in "
        f"steps; B.5 / B.6 launches {gn} / {conv} ({preview_norms} in the preview), Function "
        f"backward calls {gn_bwd} / {conv_bwd}; epoch 1 {s_ / n_:.4f} s/step "
        f"{n_ / s_:.3f} steps/s [{smi}]")
    assert state.step == steps and ck.steps() == [steps], (state.step, ck.steps())
    assert preview_norms == [preview_norm_launches()], preview_norms
    assert (gn, conv) == tuple(n * steps + p for n, p in
                               zip(UNET_NORMS, preview_norm_launches())), (gn, conv)
    assert (gn_bwd, conv_bwd) == tuple(n * steps for n in UNET_NORMS), (gn_bwd, conv_bwd)
    assert torch.isfinite(torch.tensor(loss)), loss
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert len(qkv) == 4 * 2 * 3 and all(changed[k] > 0 for k in qkv), qkv
    assert changed["word_emb.embedding.weight"] > 0
    assert attn - sum(preview_attn) == 8 * steps and attn_bwd == 8 * steps, (attn, attn_bwd)
    assert preview_attn == [8 * 50] and preview_ffn == [4 * 50], (preview_attn, preview_ffn)
    assert fwd - sum(preview_ffn) == 4 * steps and bwd == 4 * steps, (fwd, bwd)
    assert geglu == 0 and fold7 == 0, (geglu, fold7)
    return dict(fwd=fwd, bwd=bwd, geglu=geglu, fold_b7=fold7, attn=attn, gn=gn, conv=conv,
                s_per_step=s_ / n_)


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
    path's shapes, through both entries (B.8's per-head folds as
    build_folds lays them out and with a padded L stride, B.7's [B, C, H*L]
    folds), its route at each shape, and the Function against plain
    autograd."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import fold_attention as fa

    rows = []
    for i, (b, n, l) in enumerate(FOLD_SHAPES):
        t = fold_inputs(b, n, l, seed=70 + i)
        vecs = (t["gamma"], t["beta"], t["b_out"])
        # B.8's folds as build_folds lays them out (contiguous), and with wt4 the
        # [..., :L] view of an L stride rounded up to 8 (16-byte row copies);
        # B.7's layout of the same folds: wt [B, C, H*L] (a copy), vw [B, H*L, C]
        # (the same memory)
        wt4p = F.pad(t["wt4"], (0, -l % 8))[..., :l]
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
        padded = fa.fold_attention_heads(t["x"], wt4p, t["vw4"], *vecs)
        torch.cuda.synchronize()
        assert fa.launches == n0 + 4, fa.launches - n0
        want = plain()
        err = max((g.float() - want.float()).abs().max().item() for g in (got, got7))
        rel = err / want.float().abs().max().item()
        ms, ms7, plain_ms = launch_ms(per_head), launch_ms(flat), launch_ms(plain)
        bound_ms, bound_by = bound(nbytes(*t.values(), got), 4 * b * n * D * HEADS * l)
        bm, cl = fa.route(b, n, HEADS)
        log(f"fold attention B={b} N={n} C={D} H={HEADS} L={l} (route: {bm}-row tiles, "
            f"{cl} CTAs a cluster of {HEADS // cl} heads each; wt rows copied "
            f"{fa.wt_route(t['wt4'])}, B.7's {fa.wt_route(wt.view(b, D, HEADS, l).transpose(1, 2))}, "
            f"L stride padded {fa.wt_route(wt4p)}): max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {FOLD_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; B.7 layout == B.8 layout {torch.equal(got, got7)}; "
            f"kernel {ms:.4f} ms (B.7 layout {ms7:.4f} ms) plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the bound [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite fold at {b, n, l}"
        assert torch.equal(got, again), f"fold attention differs between two runs at {b, n, l}"
        assert torch.equal(got, got7) and torch.equal(got, padded), \
            f"the layouts differ at {b, n, l}"
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
    # The profiler may miss the kernels launched just after it starts (on the
    # H100, now and then the first 17 or more of a PHOSC forward). So one call
    # inside the window takes that loss, and a marker kernel (torch's
    # spin_kernel) parts it from the counted calls.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # device events, less the optimizer step's annotation range (not a kernel)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not e.name.startswith("Optimizer.")), key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    assert len(marks) == 1, f"{len(marks)} marker kernels profiled"
    kernels = events[marks[0] + 1:]
    by_name, count = collections.Counter(), collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3 / calls
        count[e.name[:60]] += 1
    return dict(busy_ms=sum(by_name.values()), kernels=len(kernels) / calls,
                top=[(k, round(v, 4)) for k, v in by_name.most_common(5)],
                per_call={k: n / calls for k, n in count.items()})


# B.3's three kernels (rows, weight gradients, the partials' sum), each once
# per FF sub-layer backward
BWD_KERNELS = ("ffn_bwd_rows_kernel", "ffn_bwd_weights_kernel", "ffn_bwd_reduce_kernel")


def step_profile(smi: str, trainer, label: str, folds: int) -> dict:
    """Three training steps of ``trainer``'s step function on a fresh state
    and its first batch, profiled: the step's device busy time and kernels,
    and per step 4 B.1 kernels, 4 of each of B.3's, ``folds`` fold kernels
    and 8 - ``folds`` attention kernels, by name."""
    import torch

    from worddiffusion_tpu_torch.data.loader import epoch_batches
    from worddiffusion_tpu_torch.train.step import make_train_step

    state = trainer.init_state()
    step_fn = make_train_step(trainer.schedule, trainer.exp, trainer.encode_fn)
    batch = next(iter(epoch_batches(trainer.dataset, trainer.exp.data.batch_size, epoch=0,
                                    seed=trainer.exp.train.seed, map_fn=trainer._device_batch)))
    d = device_profile(lambda: step_fn(state, batch), calls=3)

    def per_step(name: str) -> float:
        return sum(n for k, n in d["per_call"].items() if name in k)

    counts = {k: per_step(k) for k in ("ffn_kernel", *BWD_KERNELS, "fold_attention_kernel",
                                       "attention_kernel")}
    counts["attention_kernel"] -= counts["fold_attention_kernel"]
    log(f"train step {label} B={TRAIN_B}: profiled device busy {d['busy_ms']:.3f} ms, "
        f"{d['kernels']:.0f} kernels a step; by name {counts}; top kernels (ms) {d['top']} [{smi}]")
    want = {"ffn_kernel": 4, **{k: 4 for k in BWD_KERNELS}, "fold_attention_kernel": folds,
            "attention_kernel": 8 - folds}
    assert counts == want, (counts, want)
    return dict(busy_ms=d["busy_ms"], kernels=d["kernels"])


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
    unet = unet_check(smi, sampler.model, inputs, "iam_fold", launches=(4, 0, 8, *UNET_NORMS))

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

    out = drive_regen(smi, regen, samples, seed=0, label="iam_fold",
                      per_call=(4, 0, 8, *UNET_NORMS))
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
        reset_counts()
        state = trainer.run(epochs=epochs)
        torch.cuda.synchronize()
        counts = dict(ffn=ffn.launches, ffn_bwd=ffn.bwd_launches, geglu=ffn.geglu_launches,
                      attn=attention.launches, attn_bwd=attention.bwd_calls,
                      fold=fold_attention.launches, fold_b7=fold_attention.flat_launches,
                      fold_bwd=fold_attention.bwd_calls,
                      **dict(zip(("gn", "conv", "gn_bwd", "conv_bwd"), norm_counts())))
        return trainer, state, initial, counts, previews, torch.cuda.max_memory_allocated()

    trainer, state, initial, counts, (p_ffn, p_attn, p_fold, p_norms), peak = run("run_fold")
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    proj = [k for k in changed if any(f".attn{i}.to_{w}" in k for i in (1, 2)
                                      for w in ("q", "k", "v", "out"))]
    s_, n_ = trainer.epoch_seconds[1]
    log(f"train iam_fold: {state.step} steps of B={TRAIN_B} incl. 1 checkpoint and 1 DDIM-50 "
        f"preview; launches {counts} (preview: FF {p_ffn}, attention {p_attn}, fold {p_fold}, "
        f"B.5 / B.6 {p_norms}); "
        f"epoch 1 {s_ / n_:.4f} s/step {n_ / s_:.3f} steps/s; peak memory "
        f"{peak / 2 ** 30:.3f} GiB [{smi}]")
    assert state.step == steps, state.step
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert len(proj) == 4 * 2 * 5 and all(changed[k] > 0 for k in proj), proj
    assert p_fold == [8 * 50] and p_attn == [0] and p_ffn == [4 * 50], (p_fold, p_attn, p_ffn)
    (gn_p, conv_p), (gn_u, conv_u) = preview_norm_launches(), UNET_NORMS
    assert counts == dict(ffn=4 * steps + 4 * 50, ffn_bwd=4 * steps, geglu=0, attn=0, attn_bwd=0,
                          fold=8 * steps + 8 * 50, fold_b7=0, fold_bwd=8 * steps,
                          gn=gn_u * steps + gn_p,
                          conv=conv_u * steps + conv_p, gn_bwd=gn_u * steps,
                          conv_bwd=conv_u * steps), counts

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
    prof = step_profile(smi, trainer, "iam_fold", folds=8)
    return dict(counts, s_per_step=s_ / n_, peak_bytes=peak, step_busy_ms=prof["busy_ms"])


def norm_inputs(shape, seed: int) -> dict:
    """Seeded bf16 x (channels last) with an offset and a spread, as a
    residual stream gives the norms; GroupNorm affine near identity."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    t = dict(x=(2 * torch.randn(*shape, generator=g) + 0.5).bfloat16(),
             scale=1 + 0.1 * torch.randn(c, generator=g), bias=0.1 * torch.randn(c, generator=g))
    return {k: v.cuda() for k, v in t.items()}


def phase14_norms(smi: str) -> dict:
    """B.5 and B.6 against their plain versions at every site's shape:
    errors, bitwise repeatability, kernel / plain / library / bound times;
    then both Functions' gradients against plain autograd at the UNet's
    training shape."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import gn_conv, groupnorm

    gn_rows, conv_rows = [], []
    for i, (b, h, w, c, groups, silu) in enumerate(GN_SHAPES):
        t = norm_inputs((b, h, w, c), seed=90 + i)
        args = (t["x"], t["scale"], t["bias"], groups, 1e-6, silu)
        got, again = groupnorm.fused_groupnorm(*args), groupnorm.fused_groupnorm(*args)
        torch.cuda.synchronize()
        want = groupnorm.groupnorm_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: groupnorm.fused_groupnorm(*args))
        plain_ms = launch_ms(lambda: groupnorm.groupnorm_reference(*args))
        # the yardstick (the port never calls it): F.group_norm on the NCHW
        # (channels_last) view with bf16 affine, and F.silu after it with silu
        nchw, ws, bs = t["x"].permute(0, 3, 1, 2), t["scale"].bfloat16(), t["bias"].bfloat16()
        if silu:
            library_ms = launch_ms(lambda: F.silu(F.group_norm(nchw, groups, ws, bs, 1e-6)))
        else:
            library_ms = launch_ms(lambda: F.group_norm(nchw, groups, ws, bs, 1e-6))
        bound_ms, bound_by = bound(nbytes(*t.values(), got), 0)
        cl, kept = groupnorm.route(t["x"], groups)
        log(f"groupnorm B={b} {h}x{w} C={c} G={groups} silu={silu} (clusters of {cl}, x "
            f"{'kept in shared memory' if kept else 'read twice'}): max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {NORM_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"{'F.group_norm + F.silu' if silu else 'F.group_norm'} {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite groupnorm at {b, h, w, c}"
        assert torch.equal(got, again), f"groupnorm differs between two runs at {b, h, w, c}"
        assert rel <= NORM_REL_TOL, f"groupnorm kernel disagrees at {b, h, w, c}: rel {rel}"
        gn_rows.append(dict(shape=(b, h, w, c, groups, silu), err=err, rel=rel, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, cluster=cl, kept=kept))
        del t, got, again, want

    for i, (b, h, w, c, groups) in enumerate(CONV_SHAPES):
        t = norm_inputs((b, h, w, c), seed=120 + i)
        g = torch.Generator().manual_seed(150 + i)
        wt = (torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5).cuda()
        cb = (0.1 * torch.randn(c, generator=g)).cuda()
        args = (t["x"], t["scale"], t["bias"], wt, cb, groups, 1e-6)
        got, again = gn_conv.fused_gn_silu_conv3x3(*args), gn_conv.fused_gn_silu_conv3x3(*args)
        torch.cuda.synchronize()
        want = gn_conv.gn_silu_conv3x3_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: gn_conv.fused_gn_silu_conv3x3(*args))
        plain_ms = launch_ms(lambda: gn_conv.gn_silu_conv3x3_reference(*args))
        # the TPU file's own yardstick (resblock_pallas.py:126): three stock
        # calls, F.group_norm -> F.silu -> cuDNN F.conv2d, on bf16 operands
        nchw, ws, bs = t["x"].permute(0, 3, 1, 2), t["scale"].bfloat16(), t["bias"].bfloat16()
        wb, cbb = wt.bfloat16().contiguous(memory_format=torch.channels_last), cb.bfloat16()
        library_ms = launch_ms(lambda: F.conv2d(F.silu(F.group_norm(nchw, groups, ws, bs, 1e-6)),
                                                wb, cbb, padding=1))
        bound_ms, bound_by = bound(nbytes(*t.values(), got, cb) + wt.numel() * 2,
                                   2 * 9 * c * c * b * h * w)
        tile = gn_conv._lib().wd_gn_silu_conv3x3_tile(b, h, w, c)
        log(f"gn_silu_conv3x3 B={b} {h}x{w} C={c} G={groups} ({tile >> 16} pixels x "
            f"{tile & 0xffff} channels a CTA, {'wgmma' if tile >> 16 > 64 else 'mma.sync'}): "
            f"max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {NORM_REL_TOL}); bitwise "
            f"repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"F.group_norm + F.silu + F.conv2d (3 calls) {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / ms:.1%} of the bound, "
            f"{2 * 9 * c * c * b * h * w / ms / 1e9:.0f} TFLOP/s [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite conv at {b, h, w, c}"
        assert torch.equal(got, again), f"gn_silu_conv3x3 differs between two runs at {b, h, w, c}"
        assert rel <= NORM_REL_TOL, f"gn_silu_conv3x3 kernel disagrees at {b, h, w, c}: rel {rel}"
        conv_rows.append(dict(shape=(b, h, w, c, groups), err=err, rel=rel, ms=ms,
                              plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by))
        del t, got, again, want

    # The Functions (kernel forward, plain-recompute backward) against plain
    # autograd at the UNet's training shape: output and every gradient.
    t = norm_inputs((TRAIN_B, 8, 32, D), seed=180)
    g = torch.Generator().manual_seed(181)
    t["w"] = (torch.randn(D, D, 3, 3, generator=g) / (9 * D) ** 0.5).cuda()
    t["b"] = (0.1 * torch.randn(D, generator=g)).cuda()
    dy = (0.1 * torch.randn(TRAIN_B, 8, 32, D, generator=g)).bfloat16().cuda()
    pairs = {
        "groupnorm": (lambda x, s, b_: groupnorm.fused_groupnorm(x, s, b_, 32, 1e-5, True),
                      lambda x, s, b_: groupnorm.groupnorm_reference(x, s, b_, 32, 1e-5, True),
                      ("x", "scale", "bias")),
        "gn_silu_conv3x3": (lambda *a: gn_conv.fused_gn_silu_conv3x3(*a, 32, 1e-5),
                            lambda *a: gn_conv.gn_silu_conv3x3_reference(*a, 32, 1e-5),
                            ("x", "scale", "bias", "w", "b")),
    }
    pair_ms = {}
    for name, (fused, plain, keys) in pairs.items():
        def fwd_bwd(fn):
            leaves = [t[k].clone().requires_grad_() for k in keys]
            out = fn(*leaves)
            out.backward(dy)
            return [out.detach()] + [v.grad for v in leaves]

        got, want = fwd_bwd(fused), fwd_bwd(plain)
        torch.cuda.synchronize()
        for gname, a, w_ in zip(("out",) + tuple("d" + k for k in keys), got, want):
            err = (a.float() - w_.float()).abs().max().item()
            share = err / w_.float().abs().max().item()
            log(f"{name} Function vs plain autograd B={TRAIN_B} 8x32 C={D} {gname}: max_abs_err "
                f"{err:.6g} share of max |plain| {share:.6g} (tol {NORM_REL_TOL}); bitwise "
                f"{torch.equal(a, w_)}")
            assert a.shape == w_.shape and a.dtype == w_.dtype and bool(torch.isfinite(a).all())
            assert share <= NORM_REL_TOL, f"{name} Function disagrees: {gname} {share}"
        pair_ms[name] = (cuda_ms(lambda: fwd_bwd(fused), reps=10),
                         cuda_ms(lambda: fwd_bwd(plain), reps=10))
        log(f"{name} fwd+bwd B={TRAIN_B} 8x32 C={D}: Function {pair_ms[name][0]:.4f} ms, plain "
            f"autograd {pair_ms[name][1]:.4f} ms [{smi}]")

    # B.5's Function at the recognizer's widest site (64 channels in 32 groups
    # of 2, no SiLU, eps 1e-6), as the PHOSC train step calls it
    t = norm_inputs((PHOSC_B, 25, 125, 64), seed=182)
    dy = (0.1 * torch.randn(PHOSC_B, 25, 125, 64, generator=g)).bfloat16().cuda()

    def gn_fwd_bwd(fn):
        leaves = [t[k].clone().requires_grad_() for k in ("x", "scale", "bias")]
        out = fn(*leaves, 32, 1e-6, False)
        out.backward(dy)
        return [out.detach()] + [v.grad for v in leaves]

    got = gn_fwd_bwd(groupnorm.fused_groupnorm)
    want = gn_fwd_bwd(groupnorm.groupnorm_reference)
    for gname, a, w_ in zip(("out", "dx", "dscale", "dbias"), got, want):
        share = (a.float() - w_.float()).abs().max().item() / w_.float().abs().max().item()
        log(f"groupnorm Function vs plain autograd B={PHOSC_B} 25x125 C=64 G=32 {gname}: share "
            f"of max |plain| {share:.6g} (tol {NORM_REL_TOL}); bitwise {torch.equal(a, w_)}")
        assert a.shape == w_.shape and a.dtype == w_.dtype and bool(torch.isfinite(a).all())
        assert share <= NORM_REL_TOL, f"groupnorm Function disagrees at the PHOSC site: {gname}"
    pair_ms["groupnorm_phosc"] = (cuda_ms(lambda: gn_fwd_bwd(groupnorm.fused_groupnorm), reps=10),
                                  cuda_ms(lambda: gn_fwd_bwd(groupnorm.groupnorm_reference),
                                          reps=10))
    log(f"groupnorm fwd+bwd B={PHOSC_B} 25x125 C=64: Function "
        f"{pair_ms['groupnorm_phosc'][0]:.4f} ms, plain autograd "
        f"{pair_ms['groupnorm_phosc'][1]:.4f} ms [{smi}]")
    return dict(gn_rows=gn_rows, conv_rows=conv_rows, pair_ms=pair_ms)


def seeded_vae():
    """The full SD VAE (encoder and decoder, VAEConfig's widths) with seeded
    random weights, on the card."""
    from worddiffusion_tpu_torch.configs.config import VAEConfig
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.vae import AutoencoderKL

    vae = AutoencoderKL(VAEConfig(), with_encoder=True)
    return init_weights_(vae, seed=0).cuda().eval().requires_grad_(False)


def word_images(n: int, seed: int):
    """n word-like uint8 crops: white paper with a faint ramp, dark strokes
    of random widths; heights 30-150 and widths 20-600; even ones grey
    [H, W], odd ones RGB."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(rng.integers(30, 151)), int(rng.integers(20, 601))
        img = np.tile(np.linspace(235, 255, w).astype(np.uint8)[None, :, None], (h, 1, 3))
        for _ in range(max(2, w // 12)):
            y, x = int(rng.integers(h // 5, 4 * h // 5)), int(rng.integers(0, w))
            img[y:y + int(rng.integers(2, h // 4 + 3)), x:x + int(rng.integers(1, 6))] = \
                rng.integers(0, 70, 3)
        out.append(img[..., 0] if i % 2 == 0 else img)
    return out


def phase15_vae(smi: str) -> dict:
    """The whole SD VAE at full width on seeded weights: encode and decode
    all-kernel against all-plain, launches per call, and times (encode at
    the training batch, decode at the regeneration batch)."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.models.vae import decode_from_latent, encode_to_latent
    from worddiffusion_tpu_torch.utils.images import normalize_to_unit, resize_and_pad

    vae = seeded_vae()
    rgb = [np.dstack([im] * 3) if im.ndim == 2 else im for im in word_images(TRAIN_B, seed=7)]
    imgs = np.stack([normalize_to_unit(resize_and_pad(im)) for im in rgb])
    x = torch.from_numpy(imgs).cuda()
    with torch.no_grad():
        n0 = norm_counts()
        lat = encode_to_latent(vae, x, sample=False)
        n1 = norm_counts()
        img = decode_from_latent(vae, lat[:B])
        n2 = norm_counts()
        with plain_norms():
            lat_p = encode_to_latent(vae, x, sample=False)
            img_p = decode_from_latent(vae, lat[:B])
            enc_plain_ms = cuda_ms(lambda: encode_to_latent(vae, x, sample=False), reps=5,
                                   warmup=1)
            dec_plain_ms = cuda_ms(lambda: decode_from_latent(vae, lat[:B]), reps=5, warmup=1)
        enc_ms = cuda_ms(lambda: encode_to_latent(vae, x, sample=False), reps=5, warmup=1)
        dec_ms = cuda_ms(lambda: decode_from_latent(vae, lat[:B]), reps=5, warmup=1)
        prof = device_profile(lambda: encode_to_latent(vae, x, sample=False), calls=2)
    enc_launches = tuple(b - a for a, b in zip(n0[:2], n1[:2]))
    dec_launches = tuple(b - a for a, b in zip(n1[:2], n2[:2]))
    lat_rel = (lat - lat_p).abs().max().item() / lat_p.abs().max().item()
    img_rel = (img - img_p).abs().max().item() / img_p.abs().max().item()
    log(f"vae: encode B={TRAIN_B} 64x256 -> {tuple(lat.shape)}, (B.5, B.6) launches "
        f"{enc_launches}; decode B={B} -> {tuple(img.shape)}, launches {dec_launches}; all-kernel "
        f"vs all-plain: latents max_rel_err {lat_rel:.6g}, images max_rel_err {img_rel:.6g} (tol "
        f"{VAE_REL_TOL}); encode {enc_ms:.3f} ms (plain B.5/B.6 {enc_plain_ms:.3f}), decode "
        f"{dec_ms:.3f} ms (plain {dec_plain_ms:.3f}); encode profiled: device busy "
        f"{prof['busy_ms']:.3f} ms, {prof['kernels']:.0f} kernels; top (ms) {prof['top']} [{smi}]")
    assert enc_launches == ENCODER_NORMS and dec_launches == DECODER_NORMS
    assert lat.shape == (TRAIN_B, 8, 32, 4) and img.shape == (B, 64, 256, 3)
    assert bool(torch.isfinite(lat).all() & torch.isfinite(img).all())
    assert lat_rel <= VAE_REL_TOL, f"encoder all-kernel vs all-plain: rel {lat_rel}"
    assert img_rel <= VAE_REL_TOL, f"decoder all-kernel vs all-plain: rel {img_rel}"
    return dict(enc_ms=enc_ms, enc_plain_ms=enc_plain_ms, dec_ms=dec_ms, dec_plain_ms=dec_plain_ms,
                lat_rel=lat_rel, img_rel=img_rel, enc_busy_ms=prof["busy_ms"])


def write_image_corpus(work: str) -> tuple[str, str, str]:
    """N_IMAGES word PNGs (written by the port's PNG writer), a gt file naming
    them, and a diffusers-keyed safetensors file of the seeded VAE."""
    from worddiffusion_tpu_torch.utils.images import encode_png
    from worddiffusion_tpu_torch.utils.safetensors import save_file

    crops = os.path.join(work, "crops")
    os.makedirs(crops)
    words = ("the of and to in is was that for it with as his on be at by had are "
             "but from not this have which one were all they she you her an there").split()
    gt = os.path.join(work, "crops.filter27")
    with open(gt, "w") as f:
        for i, img in enumerate(word_images(N_IMAGES, seed=3)):
            with open(os.path.join(crops, f"c01-{i:04d}u-00.png"), "wb") as png:
                png.write(encode_png(img))
            f.write(f"{i % 300:03d},c01-{i:04d}u-00 {words[i % len(words)]}\n")
    vae_file = os.path.join(work, "vae.safetensors")
    save_file(seeded_vae().state_dict(), vae_file)
    return crops, gt, vae_file


def phase16_cache(smi: str, work: str, corpus) -> dict:
    """The latent-cache CLI over the word PNGs (resized on the
    host), with --stable_dif_path, B=64, --deterministic 1: the npz against a
    direct posterior-mean encode, launches per batch, images/s."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
    from worddiffusion_tpu_torch.data.dataset import LatentLookup
    from worddiffusion_tpu_torch.data.loader import batches
    from worddiffusion_tpu_torch.models.vae import encode_to_latent
    from worddiffusion_tpu_torch.ops import ffn, fold_attention

    crops, gt, vae_file = corpus
    out = os.path.join(work, "built.npz")
    argv = ["--preset", "iam", "--gt_train", gt, "--iam_path", crops, "--stable_dif_path",
            vae_file, "--batch_size", "64", "--deterministic", "1", "--device", "cuda"]
    reset_counts()
    t0 = time.perf_counter()
    cache_cli.main(argv + ["--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gn, conv = norm_counts()[:2]
    geglu, fold7 = ffn.geglu_launches, fold_attention.flat_launches
    lookup = LatentLookup.load(out)
    n_batches = -(-N_IMAGES // 64)

    ds, vae = cache_cli.build(cache_cli.build_parser().parse_args(argv + ["--out", out]))
    diff, scale = 0.0, 0.0
    with torch.no_grad():
        for batch in batches(ds, 64, shuffle=False, drop_remainder=False):
            direct = encode_to_latent(vae, torch.from_numpy(batch["image"]).cuda(),
                                      sample=False).cpu().numpy()
            for name, lat in zip(batch["image_name"], direct):
                diff = max(diff, float(np.abs(lookup[name] - lat).max()))
                scale = max(scale, float(np.abs(lat).max()))
    names = sorted(f"c01-{i:04d}u-00.png" for i in range(N_IMAGES))
    log(f"build_latent_cache: {len(lookup)} latents from {N_IMAGES} PNGs (30-150 x 20-600, "
        f"resized) in {n_batches} batches of 64 in {wall:.2f} s incl. VAE load, "
        f"{N_IMAGES / wall:.2f} images/s; (B.5, B.6) launches {(gn, conv)}; max |cache - direct "
        f"posterior-mean encode| {diff:.6g} (max |latent| {scale:.4g}) [{smi}]")
    assert sorted(lookup._arrays) == names
    assert all(lookup[n].shape == (8, 32, 4) and np.isfinite(lookup[n]).all() for n in names)
    assert (gn, conv) == tuple(k * n_batches for k in ENCODER_NORMS), (gn, conv)
    assert diff <= 1e-6 * scale, f"cache differs from the direct encode: {diff}"
    assert geglu == 0 and fold7 == 0, (geglu, fold7)
    return dict(gn=gn, conv=conv, geglu=geglu, fold_b7=fold7, imgs_per_s=N_IMAGES / wall,
                cache=out)


def phase16_ddim_regen(smi: str, cli, gt: str, work: str, vae_file: str) -> dict:
    """One regeneration batch through the regeneration CLI's main with
    ``--stable_dif_path`` (phase 16's safetensors VAE, its decode half) and
    ``--ddim 50``: 50 UNet calls (4 FF, 8 attention, 9 B.5, 12 B.6 launches
    each), one decode and one OCR call."""
    import torch

    from worddiffusion_tpu_torch.models.vae import load_diffusers_vae
    from worddiffusion_tpu_torch.ops import attention, ffn
    from worddiffusion_tpu_torch.utils.safetensors import load_file

    argv = ["--gt_file", gt, "--dump_path", os.path.join(work, "regen_ddim"), "--batch_size",
            str(B), "--max_batches", "1", "--keep_rejected", "1", "--seed", "0",
            "--stable_dif_path", vae_file, "--ddim", "50"]
    regen, _ = cli.build(cli.build_parser().parse_args(argv))
    want = load_diffusers_vae(load_file(vae_file), regen.sampler.exp.vae, False).state_dict()
    got = regen.sampler.vae.state_dict()
    assert regen.sampler.ddim_steps == 50 and not regen.sampler.vae.with_encoder
    assert got.keys() == want.keys() and all(torch.equal(got[k].cpu(), want[k]) for k in got)
    del regen
    reset_counts()
    t0 = time.perf_counter()
    stats = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (ffn.launches, attention.launches, *norm_counts()[:2])
    calls = ffn.launches // 4
    want_counts = (4 * 50, 8 * 50, 50 * UNET_NORMS[0] + DECODER_NORMS[0] + OCR_NORMS[0],
                   50 * UNET_NORMS[1] + DECODER_NORMS[1] + OCR_NORMS[1])
    log(f"regen CLI --ddim 50 --stable_dif_path: {stats.generated} generated in one batch of {B}, "
        f"{calls} UNet calls; launches (FF, attention, B.5, B.6) {counts} (expect {want_counts}); "
        f"{wall:.3f} s incl. the CLI's set-up [{smi}]")
    assert stats.generated == B and calls == 50 and counts == want_counts, (stats, counts)
    return dict(calls=calls, wall=wall)


def phase17_train_images(smi: str, work: str, corpus, cache: str) -> dict:
    """The train CLI from the word PNGs (no --latent_cache): each step
    encodes its batch on the card, B=128, 2 epochs of 3 steps and one
    DDIM-50 preview; a max_steps stop and a resume bitwise the uninterrupted
    run; s/step against latent-cache training on phase 16's cache."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    crops, gt, vae_file = corpus
    epochs, spe = 2, N_IMAGES // TRAIN_B
    steps = epochs * spe

    def args(save: str, *extra: str):
        return train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", gt, "--batch_size", str(TRAIN_B), "--epochs",
            str(epochs), "--ckpt_every_epochs", "2", "--save_path", os.path.join(work, save),
            "--seed", "0", "--device", "cuda", *extra])

    trainer = train_cli.build(args("run_img", "--iam_path", crops, "--stable_dif_path",
                                   vae_file))
    assert trainer.encode_fn is not None and trainer.dataset.latent_cache is None
    p_ffn, p_attn, _, p_norms = count_previews(trainer)
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = trainer.run(epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = dict(ffn=ffn.launches, ffn_bwd=ffn.bwd_launches, geglu=ffn.geglu_launches,
                  fold_b7=fold_attention.flat_launches,
                  attn=attention.launches, attn_bwd=attention.bwd_calls,
                  **dict(zip(("gn", "conv", "gn_bwd", "conv_bwd"), norm_counts())))
    changed = {k: (v - initial[k]).abs().max().item()
               for k, v in state.model.state_dict().items()}
    ema_equal = all(torch.equal(e, p) for e, p in
                    zip(state.ema.parameters(), state.model.parameters()))
    s_, n_ = trainer.epoch_seconds[1]
    loss = torch.load(trainer.ckpt.path(steps), map_location="cpu",
                      weights_only=True)["metrics"]["loss"]

    cached = train_cli.build(args("run_cached", "--latent_cache", cache))
    cached.preview_fn = None
    cached.run(epochs=epochs)
    torch.cuda.synchronize()
    c_s, c_n = cached.epoch_seconds[1]
    log(f"train from images: {state.step} steps of B={TRAIN_B} ({spe} an epoch) in {wall:.2f} s "
        f"incl. 1 checkpoint and 1 DDIM-50 preview; last-epoch loss {loss:.6g}; launches "
        f"{counts} (preview: FF {p_ffn}, attention {p_attn}, B.5 / B.6 {p_norms}); max param "
        f"change {max(changed.values()):.4g}; EMA == params {ema_equal}; epoch 1 {s_ / n_:.4f} "
        f"s/step from images vs {c_s / c_n:.4f} s/step from the cache of the same images; peak "
        f"memory {peak / 2 ** 30:.3f} GiB [{smi}]")
    (gn_p, conv_p), (gn_u, conv_u) = preview_norm_launches(), UNET_NORMS
    assert state.step == steps and torch.isfinite(torch.tensor(loss)), (state.step, loss)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert max(changed.values()) > 0 and ema_equal
    assert p_norms == [(gn_p, conv_p)] and p_ffn == [4 * 50] and p_attn == [8 * 50]
    assert counts == dict(
        ffn=4 * steps + 4 * 50, ffn_bwd=4 * steps, geglu=0, fold_b7=0,
        attn=8 * steps + 8 * 50, attn_bwd=8 * steps,
        gn=(gn_u + ENCODER_NORMS[0]) * steps + gn_p, conv=(conv_u + ENCODER_NORMS[1]) * steps
        + conv_p, gn_bwd=gn_u * steps, conv_bwd=conv_u * steps), counts

    kill_at = spe + 1
    part = train_cli.build(args("resume_img", "--iam_path", crops, "--stable_dif_path",
                                vae_file)).run(epochs=epochs, max_steps=kill_at)
    assert part.step == kill_at, part.step
    resumed = train_cli.build(args("resume_img", "--iam_path", crops, "--stable_dif_path",
                                   vae_file, "--loadPrev", "1")).run(epochs=epochs, resume=True)
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    log(f"train from images resume: stopped at step {kill_at}, resumed to {resumed.step}; max "
        f"param diff vs the uninterrupted run {diff:.6g}; must be bitwise 0")
    assert resumed.step == steps and diff == 0, (resumed.step, diff)
    return dict(counts, s_per_step=s_ / n_, cached_s_per_step=c_s / c_n, peak_bytes=peak)


def phase18_variants(smi: str, sampler, words) -> dict:
    """The ResBlock variants' full-width ``iam`` UNet calls at B=16 (FiLM, the
    split skip, both) on seeded weights, the zero-initialised convs too:
    each all-kernel against all-plain within UNET_REL_TOL, with its B.5 / B.6
    launches per call (VARIANT_NORMS) and by profiled kernel name."""
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet

    flags = {"film": dict(use_scale_shift_norm=True), "split_skip": dict(split_skip_conv=True),
             "film_split_skip": dict(use_scale_shift_norm=True, split_skip_conv=True)}
    inputs = unet_inputs(sampler, words, phosc=False)
    out = {}
    for label, kw in flags.items():
        unet = UNet(dataclasses.replace(sampler.model.cfg, **kw))
        unet = init_weights_(unet, seed=0, zero_init=False).cuda().eval()
        r = unet_check(smi, unet, inputs, f"iam {label}",
                       launches=(4, 8, 0, *VARIANT_NORMS[label]))
        out[label] = dict(ms=r["ms"], rel=r["rel"], busy_ms=r["busy_ms"],
                          counts=(4, 8, 0, *VARIANT_NORMS[label]))
        del unet
    return out


def cond_corpus(work: str, corpus: tuple[str, str]) -> tuple[str, str, str]:
    """Phase 19's corpus: the first 2 * COND_STEPS_PER_EPOCH + 1 batches' worth
    of the phase-7 gt file over its latent cache (a half batch to drop), and
    a seeded style dict (4096-d per writer id of the corpus)."""
    import numpy as np

    gt, cache = corpus
    n = COND_STEPS_PER_EPOCH * TRAIN_B + TRAIN_B // 2
    with open(gt) as f:
        lines = f.readlines()[:n]
    sub = os.path.join(work, "cond.filter27")
    with open(sub, "w") as f:
        f.writelines(lines)
    writers = sorted({line.split(",")[0] for line in lines})
    rng = np.random.default_rng(19)
    styles = os.path.join(work, "styles.npz")
    np.savez(styles, **{w: rng.standard_normal(4096).astype(np.float32) for w in writers})
    return sub, cache, styles


def phase19_cond_train(smi: str, work: str, corpus: tuple[str, str, str]) -> dict:
    """The train CLI at full width, B=128, 2 epochs of COND_STEPS_PER_EPOCH
    steps with one checkpoint and one DDIM-50 preview: (a) ``--ocrTraining 1
    --imgConditioned 1``: finite loss and ctc, the aux head and conv_in's
    reference-latent channels trained, launches per step, a max_steps stop
    and a resume bitwise the uninterrupted run (the CTC loss's determinism);
    (b) ``--wrdChrWrStyl 1 --style_dict``: the style projection trained and
    every attention at Nk = 1 (the style token replaces the context). Both:
    3 profiled steps (4 B.1, 4 of each of B.3's three, 8 attention kernels a
    step), s/step and peak memory."""
    from unittest import mock

    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.data.loader import epoch_batches
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention
    from worddiffusion_tpu_torch.train.step import make_train_step

    gt, cache, styles = corpus
    epochs, steps = 2, 2 * COND_STEPS_PER_EPOCH

    def build(save: str, *flags: str):
        return train_cli.build(train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", gt, "--latent_cache", cache, "--batch_size",
            str(TRAIN_B), "--epochs", str(epochs), "--ckpt_every_epochs", "2", "--save_path",
            os.path.join(work, save), "--seed", "0", "--device", "cuda", *flags]))

    def run(save: str, *flags: str):
        trainer = build(save, *flags)
        previews = count_previews(trainer)
        initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
        gc.collect()  # the earlier runs' states
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        state = trainer.run(epochs=epochs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before  # the run's own
        counts = dict(ffn=ffn.launches, ffn_bwd=ffn.bwd_launches, geglu=ffn.geglu_launches,
                      attn=attention.launches, attn_bwd=attention.bwd_calls,
                      fold=fold_attention.launches, fold_b7=fold_attention.flat_launches,
                      **dict(zip(("gn", "conv", "gn_bwd", "conv_bwd"), norm_counts())))
        changed = {k: (v - initial[k]).abs() for k, v in state.model.state_dict().items()}
        # the parameters the run ended with (init_state below re-initialises
        # the trainer's one model in place)
        final = [p.detach().clone() for p in state.model.parameters()]
        s_, n_ = trainer.epoch_seconds[1]
        loss = torch.load(trainer.ckpt.path(steps), map_location="cpu",
                          weights_only=True)["metrics"]["loss"]
        # one more step on a fresh state for its metrics (ctc), and the
        # attention's key lengths
        nks = []
        fused = attention.fused_attention

        def recorded(q, k, v, scale):
            nks.append(k.shape[2])
            return fused(q, k, v, scale)

        step_fn = make_train_step(trainer.schedule, trainer.exp, trainer.encode_fn)
        batch = next(iter(epoch_batches(trainer.dataset, TRAIN_B, epoch=0, seed=0,
                                        map_fn=trainer._device_batch)))
        with mock.patch.object(attention, "fused_attention", recorded):
            metrics = {k: v.item() for k, v in step_fn(trainer.init_state(), batch).items()}
        return dict(trainer=trainer, state=state, final=final, counts=counts, previews=previews,
                    changed=changed, s_per_step=s_ / n_, peak=peak, loss=loss, metrics=metrics,
                    nks=nks)

    out = {}
    for label, flags in (("ocr_img", ("--ocrTraining", "1", "--imgConditioned", "1")),
                         ("style", ("--wrdChrWrStyl", "1", "--style_dict", styles))):
        r = run(f"run_{label}", *flags)
        trainer, counts, changed = r["trainer"], r["counts"], r["changed"]
        p_ffn, p_attn, _, p_norms = r["previews"]
        cfg = trainer.exp.unet
        head = CTC_HEAD_NORMS if cfg.ocr_head else (0, 0)
        per_call = tuple(u + h for u, h in zip(UNET_NORMS, head))
        log(f"train {label} ({' '.join(flags[::2])}): {r['state'].step} steps of B={TRAIN_B} "
            f"incl. 1 checkpoint and 1 DDIM-50 preview; last-epoch loss {r['loss']:.6g}; a fresh "
            f"step's metrics {r['metrics']}; launches {counts} (preview: FF {p_ffn}, attention "
            f"{p_attn}, B.5 / B.6 {p_norms}); attention key lengths in a step "
            f"{sorted(set(r['nks']))}; epoch 1 {r['s_per_step']:.4f} s/step; peak memory above "
            f"the run's start {r['peak'] / 2 ** 30:.3f} GiB [{smi}]")
        assert r["state"].step == steps, r["state"].step
        assert all(torch.isfinite(torch.tensor(v)) for v in r["metrics"].values()), r["metrics"]
        assert torch.isfinite(torch.tensor(r["loss"])), r["loss"]
        assert all(torch.isfinite(p).all() for p in r["final"])
        assert p_ffn == [4 * 50] and p_attn == [8 * 50], (p_ffn, p_attn)
        preview = tuple(50 * n + d for n, d in zip(per_call, DECODER_NORMS))
        assert p_norms == [preview], (p_norms, preview)
        assert counts == dict(
            ffn=4 * steps + 4 * 50, ffn_bwd=4 * steps, geglu=0, attn=8 * steps + 8 * 50,
            attn_bwd=8 * steps, fold=0, fold_b7=0, gn=per_call[0] * steps + preview[0],
            conv=per_call[1] * steps + preview[1], gn_bwd=per_call[0] * steps,
            conv_bwd=per_call[1] * steps), counts
        assert len(r["nks"]) == 8, r["nks"]
        if label == "ocr_img":
            assert cfg.ocr_head and cfg.img_conditioned and "ctc" in r["metrics"]
            assert changed["auxhead.lin2.weight"].max() > 0
            assert changed["auxhead.temporal_i.1.weight"].max() > 0
            assert changed["input_blocks.0.0.weight"][:, 4:].max() > 0
            assert set(r["nks"]) == {42}, r["nks"]
        else:
            assert cfg.style_vec_dim == 4096 and cfg.style_replace_context
            assert changed["wrd_proj.weight"].max() > 0
            assert set(r["nks"]) == {1}, r["nks"]
        prof = step_profile(smi, trainer, f"iam {label}", folds=0)
        out[label] = dict(counts, s_per_step=r["s_per_step"], peak_bytes=r["peak"],
                          step_busy_ms=prof["busy_ms"], ckpt=trainer.ckpt.path(
                              steps, "ema_unet.pt"), save=os.path.join(work, f"run_{label}"))
        if label == "ocr_img":
            # a max_steps stop, then a resume, against the uninterrupted run
            kill_at = COND_STEPS_PER_EPOCH + 1
            part = build("resume_ocr_img", *flags).run(epochs=epochs, max_steps=kill_at)
            assert part.step == kill_at, part.step
            resumed = build("resume_ocr_img", *flags, "--loadPrev", "1").run(epochs=epochs,
                                                                             resume=True)
            diff = max((a - b).abs().max().item() for a, b in
                       zip(resumed.model.parameters(), r["final"]))
            log(f"train ocr_img resume: stopped at step {kill_at}, resumed to {resumed.step}; "
                f"max param diff vs the uninterrupted run {diff:.6g}; must be bitwise 0 (the "
                f"CTC loss and its gradient repeat bit for bit)")
            assert resumed.step == steps and diff == 0, (resumed.step, diff)
            out[label]["resume_diff"] = diff
            del part, resumed
        del r, trainer, changed
    return out


def phase20_sample(smi: str, work: str, vae_file: str, cond_image: str, trained: dict,
                   style_dict: str) -> dict:
    """The sampling CLI (``cli.sample.main``) at full width on the card:
    (1) seeded weights, a few words with ``--writer 3 --writer2 7 --mix_rate
    0.5 --cfg_scale 3 --ddim 50``: 100 UNet calls, the PNGs under the JAX
    CLI's names; (2) ``--imgConditioned 1 --cond_image`` against phase 19(a)'s
    EMA checkpoint (its aux head left unread); (3) ``--wrdChrWrStyl 1
    --style_dict`` against phase 19(b)'s. Counts set to 0 before each run
    and read after it; s/batch of each (one batch, the CLI's set-up apart)."""
    import torch

    from worddiffusion_tpu_torch.cli import sample as sample_cli
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    words = "the,of,and,to,in,is"
    runs = {
        "sample_cfg_mix": (["--writer", "3", "--writer2", "7", "--mix_rate", "0.5",
                            "--cfg_scale", "3"], 100, (0, 0)),
        "sample_img": (["--writer", "3", "--imgConditioned", "1", "--cond_image", cond_image,
                        "--torch_ckpt", trained["ocr_img"]["ckpt"]], 50, ENCODER_NORMS),
        "sample_style": (["--writer", "3", "--wrdChrWrStyl", "1", "--style_dict", style_dict,
                          "--torch_ckpt", trained["style"]["ckpt"], "--writers_dict",
                          os.path.join(trained["style"]["save"], "writers_dict_train.json")],
                         50, (0, 0)),
    }
    out = {}
    for label, (flags, calls, encode) in runs.items():
        argv = ["--words", words, "--ddim", "50", "--stable_dif_path", vae_file, "--seed", "0",
                "--save_path", os.path.join(work, label), "--device", "cuda", *flags]
        reset_counts()
        t0 = time.perf_counter()
        names = sample_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ffn=ffn.launches, attn=attention.launches, fold=fold_attention.launches,
                      geglu=ffn.geglu_launches, fold_b7=fold_attention.flat_launches,
                      **dict(zip(("gn", "conv"), norm_counts()[:2])))
        want = dict(ffn=4 * calls, attn=8 * calls, fold=0, geglu=0, fold_b7=0,
                    gn=UNET_NORMS[0] * calls + DECODER_NORMS[0] + encode[0],
                    conv=UNET_NORMS[1] * calls + DECODER_NORMS[1] + encode[1])
        mix = "_mix0.500" if "--writer2" in flags else ""
        want_names = [f"{i:05d}_3_{w}{mix}.png" for i, w in enumerate(words.split(","))]
        sampler, pairs, style, cond, _ = sample_cli.build(sample_cli.build_parser().parse_args(
            argv))
        cond_kw = {}
        if style is not None:
            cond_kw["style_vec"] = [style[raw] for _, _, raw in pairs]
        if cond is not None:
            cond_kw["cond_latents"] = cond.repeat(len(pairs), 0)
        if "--writer2" in flags:
            cond_kw.update(writer_ids2=[7] * len(pairs), mix_rate=0.5)
        w_, i_ = [p[0] for p in pairs], [p[1] for p in pairs]
        secs = []
        for r in range(2):
            gen = torch.Generator(device="cuda").manual_seed(r)
            t1 = time.perf_counter()
            sampler.sample_async(w_, i_, gen, **cond_kw).cpu()
            secs.append(time.perf_counter() - t1)
        log(f"sample CLI {label}: {len(names)} PNGs {names[:2]}...; {counts['ffn'] // 4} UNet "
            f"calls; launches {counts} (expect {want}); {wall:.3f} s incl. the CLI's set-up; one "
            f"batch of {len(w_)}: {secs} s/batch [{smi}]")
        assert names == want_names, names
        assert all(png_size(os.path.join(work, label, n)) == (256, 64) for n in names)
        assert counts == want, (counts, want)
        out[label] = dict(counts, s_per_batch=min(secs), wall=wall)
        del sampler
    return out


def all_counts() -> dict:
    """Every kernel's launches so far, under the kernels' JSON keys."""
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    gn, conv = norm_counts()[:2]
    return dict(ffn=ffn.launches, ffn_bwd=ffn.bwd_launches, attn=attention.launches,
                fold=fold_attention.launches, fold_b7=fold_attention.flat_launches, gn=gn,
                conv=conv, geglu=ffn.geglu_launches)


def only_groupnorm(gn: int) -> dict:
    """The counts of a path that launches B.5 ``gn`` times and no other kernel."""
    return dict(ffn=0, ffn_bwd=0, attn=0, fold=0, fold_b7=0, gn=gn, conv=0, geglu=0)


@contextlib.contextmanager
def count_forwards(cls):
    """Records the batch of every ``cls.forward`` call (of the models the CLIs
    build inside)."""
    batches = []
    forward = cls.forward

    def counted(self, x, *a, **k):
        batches.append(x.shape[0])
        return forward(self, x, *a, **k)

    with mock.patch.object(cls, "forward", counted):
        yield batches


def phosc_images(n: int, seed: int):
    """n seeded word crops resized to the recognizer's uint8 [n, 50, 250, 3]."""
    import numpy as np

    from worddiffusion_tpu_torch.utils.images import resize_and_pad

    rgb = [np.dstack([im] * 3) if im.ndim == 2 else im for im in word_images(n, seed)]
    return np.stack([resize_and_pad(im, 50, 250) for im in rgb])


def write_phosc_corpus(work: str) -> tuple[str, str, str, str]:
    """PHOSC_TRAIN word PNGs over 32 words (the training gt file), PHOSC_VALID
    over 8 words never trained (validation, and the zero-shot test split), and
    a gt file of the first 2 * PHOSC_B training PNGs."""
    from worddiffusion_tpu_torch.utils.images import encode_png

    crops = os.path.join(work, "phosc_crops")
    os.makedirs(crops)
    words = ("the of and to in is was that for it with as his on be at by had are but from "
             "not this have which one were all they she you her an there been their we").split()
    files = {}
    for split, n, vocab, seed in (("train", PHOSC_TRAIN, words[:32], 31),
                                  ("valid", PHOSC_VALID, words[32:40], 32)):
        files[split] = os.path.join(work, f"phosc_{split}.filter27")
        with open(files[split], "w") as f:
            for i, img in enumerate(word_images(n, seed)):
                name = f"p{split[0]}1-{i:04d}u-00"
                with open(os.path.join(crops, name + ".png"), "wb") as png:
                    png.write(encode_png(img))
                f.write(f"{i % 50:03d},{name} {vocab[i % len(vocab)]}\n")
    small = os.path.join(work, "phosc_small.filter27")
    with open(files["train"]) as f, open(small, "w") as g:
        g.writelines(f.readlines()[:2 * PHOSC_B])
    return crops, files["train"], files["valid"], small


def phase21_phosc(smi: str, work: str) -> dict:
    """The PHOSC recognizer at full width on the card (seeded weights, bf16):
    (a) one PHOSCNet(trunk="resnet18") forward at B=64 all-kernel against
    all-plain, 16 B.5 launches, by profiled kernel name; (b) the train_phosc
    CLI, --model resnet18, 2 epochs at B=64 on seeded word PNGs: 16 B.5
    launches and 16 GroupNormFn backward calls a step, the JAX-layout
    checkpoint, s/step, peak memory, 3 profiled steps; (c) train_charcounter
    (1 epoch), then train_phosc --mode test on (b)'s checkpoint with
    --len_counter on its params.pkl: every result finite, images/s; (d) (b)'s
    checkpoint read into a fresh model on the card (bf16) and on the host
    (fp32); (e) --model vgg (the CLI's default), 1 epoch of 2 steps. Counts
    set to 0 before each run and read after it."""
    import ast

    import numpy as np
    import torch

    from worddiffusion_tpu_torch.cli import train_charcounter, train_phosc
    from worddiffusion_tpu_torch.data.phoc import phoc_labels
    from worddiffusion_tpu_torch.data.phos import phos_labels
    from worddiffusion_tpu_torch.models.charcounter import CharacterCounterNet
    from worddiffusion_tpu_torch.models.convert import (jax_phoscnet_to_torch,
                                                        read_params_pickle, state_dict_to_torch)
    from worddiffusion_tpu_torch.models.layers import GroupNorm32, init_weights_
    from worddiffusion_tpu_torch.models.phoscnet import PHOSCNet
    from worddiffusion_tpu_torch.train.plateau import ReduceOnPlateau
    from worddiffusion_tpu_torch.train.state import make_optimizer

    cl = torch.channels_last
    paths = {}
    # (a) one forward, all-kernel against all-plain
    model = init_weights_(PHOSCNet(trunk="resnet18"), seed=0).cuda().to(memory_format=cl)
    model.eval().requires_grad_(False)
    x = train_phosc.dev_norm(phosc_images(PHOSC_B, seed=21), "cuda")
    layouts = []
    hooks = [m.register_forward_pre_hook(lambda m, a: layouts.append(
        a[0].is_contiguous(memory_format=cl))) for m in model.modules()
        if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        reset_counts()
        out = model(x, return_features=True)
        paths["phosc_forward"] = all_counts()
        for h in hooks:
            h.remove()
        with plain_norms():
            ref = model(x, return_features=True)
            plain_ms = cuda_ms(lambda: model(x), reps=10)
        ms = cuda_ms(lambda: model(x), reps=10)
        prof = device_profile(lambda: model(x), calls=3)
    rels = {k: ((out[k] - ref[k]).abs().max() / ref[k].abs().max()).item() for k in ref}
    gn_kernels = sum(n for k, n in prof["per_call"].items() if "gn_cluster_kernel" in k)
    library_gn = [k for k in prof["per_call"] if "rowwisemoments" in k.lower()
                  or "groupnorm" in k.lower().replace("_", "")]
    log(f"phosc forward resnet18 B={PHOSC_B} 50x250: phos {tuple(out['phos'].shape)} phoc "
        f"{tuple(out['phoc'].shape)} features {tuple(out['features'].shape)}; launches "
        f"{paths['phosc_forward']}; all-kernel vs all-plain max_rel_err {rels} (tol "
        f"{PHOSC_REL_TOL}); GroupNorm inputs channels_last {sum(layouts)}/{len(layouts)}; "
        f"{ms:.3f} ms a forward (plain B.5 {plain_ms:.3f}); profiled: device busy "
        f"{prof['busy_ms']:.3f} ms, {prof['kernels']:.0f} kernels, {gn_kernels:.0f} "
        f"gn_cluster_kernel a forward, library GroupNorm kernels {library_gn}; top (ms) "
        f"{prof['top']} [{smi}]")
    assert paths["phosc_forward"] == only_groupnorm(PHOSC_NORMS), paths["phosc_forward"]
    assert out["phos"].shape == (PHOSC_B, 165) and out["phoc"].shape == (PHOSC_B, 604)
    assert out["features"].shape == (PHOSC_B, 4096)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert max(rels.values()) <= PHOSC_REL_TOL, rels
    assert len(layouts) == PHOSC_NORMS and all(layouts), layouts
    assert gn_kernels == PHOSC_NORMS and not library_gn, (gn_kernels, library_gn)
    del model, x, out, ref

    # (b) the train CLI, --model resnet18, 2 epochs at B=64
    crops, train_gt, valid_gt, small_gt = write_phosc_corpus(work)
    save = os.path.join(work, "phosc_resnet18")
    common = ["--image_dir", crops, "--batch_size", str(PHOSC_B), "--device", "cuda"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_forwards(PHOSCNet) as fwd:
        t0 = time.perf_counter()
        run = train_phosc.main(["--train_csv", train_gt, "--valid_csv", valid_gt, "--model",
                                "resnet18", "--epochs", "2", "--save_dir", save, *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    paths["train_phosc"] = all_counts()
    gn_bwd = norm_counts()[2]
    peak = torch.cuda.max_memory_allocated() - base
    hist = run["history"]
    steps = sum(h["steps"] for h in hist)
    s_per_step = hist[1]["train_seconds"] / hist[1]["steps"]
    fresh = init_weights_(PHOSCNet(trunk="resnet18"), seed=0)
    moved = sum(not torch.equal(p.detach().cpu(), q) for p, q in
                zip(run["model"].parameters(), fresh.parameters()))
    with open(os.path.join(save, "log.csv")) as f:
        rows = f.read().splitlines()
    best = read_params_pickle(os.path.join(save, "best_params.pkl"))
    stem = best["params"]["trunk"]["stem"]["kernel"]
    log(f"train_phosc resnet18 B={PHOSC_B}: {steps} steps in 2 epochs, {len(fwd)} forwards "
        f"(steps + validation); launches {paths['train_phosc']}, GroupNormFn backward calls "
        f"{gn_bwd}; history {hist}; {moved} of {len(fresh.state_dict())} parameter tensors "
        f"moved; log.csv {rows}; best_params.pkl keys {sorted(best['params'])[:4]}..., stem "
        f"kernel {type(stem).__name__} {stem.dtype} {stem.shape}; epoch 2 {s_per_step:.4f} "
        f"s/step (host batches from the crop cache included); {wall:.2f} s in all; peak memory "
        f"above the phase's start {peak / 2 ** 30:.3f} GiB [{smi}]")
    assert steps == 2 * (PHOSC_TRAIN // PHOSC_B), steps
    assert len(fwd) == steps + 2 * -(-PHOSC_VALID // PHOSC_B), fwd
    assert paths["train_phosc"] == only_groupnorm(PHOSC_NORMS * len(fwd)), paths["train_phosc"]
    assert gn_bwd == PHOSC_NORMS * steps, gn_bwd
    assert all(np.isfinite(h["loss"]) for h in hist) and moved == len(fresh.state_dict())
    assert len(rows) == 3 and rows[0] == "epoch,loss,zsl_acc,lr", rows
    assert set(best) == {"params"} and {"trunk", "phos_fc0", "phos_fc1", "phos_out", "phoc_fc0",
                                        "phoc_fc1", "phoc_out"} == set(best["params"])
    assert isinstance(stem, np.ndarray) and stem.dtype == np.float32 and stem.shape == (7, 7, 3, 64)

    # three profiled steps of the CLI's train step on the trained model
    trained = run["model"]
    optimizer = make_optimizer(trained.parameters(), 1e-4, weight_decay=5e-5)
    plateau = ReduceOnPlateau(factor=0.25, patience=20, cooldown=8, atol=1e-4)
    vocab = ("the of and to in is was that for it with as his on be at by had are but from not "
             "this have which one were all they she you her an").split()
    batch_words = [vocab[i % len(vocab)] for i in range(PHOSC_B)]
    phos_map, phoc_map = phos_labels(vocab, "eng"), phoc_labels(vocab, "eng")
    tp = torch.from_numpy(np.stack([phos_map[w] for w in batch_words])).float().cuda()
    tc = torch.from_numpy(np.stack([phoc_map[w] for w in batch_words])).float().cuda()
    imgs = train_phosc.dev_norm(phosc_images(PHOSC_B, seed=22), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sprof = device_profile(lambda: train_phosc.train_step(trained, optimizer, imgs, tp, tc, gen,
                                                          plateau, 1e-4, 1e9), calls=3)
    step_gn = sum(n for k, n in sprof["per_call"].items() if "gn_cluster_kernel" in k)
    # the same steps with the plain GroupNorm forward (the backward is the
    # same plain recompute in both): what B.5 saves a step
    with plain_norms():
        pprof = device_profile(lambda: train_phosc.train_step(trained, optimizer, imgs, tp, tc,
                                                              gen, plateau, 1e-4, 1e9), calls=3)
    log(f"train_phosc step resnet18 B={PHOSC_B}: profiled device busy {sprof['busy_ms']:.3f} ms, "
        f"{sprof['kernels']:.0f} kernels, {step_gn:.0f} gn_cluster_kernel a step; top (ms) "
        f"{sprof['top']}; with the plain GroupNorm forward {pprof['busy_ms']:.3f} ms, "
        f"{pprof['kernels']:.0f} kernels; top (ms) {pprof['top']} [{smi}]")
    assert step_gn == PHOSC_NORMS, step_gn
    del trained, optimizer, run, imgs

    # (c) the character counter, then test mode with --len_counter
    counter_dir = os.path.join(work, "charcounter")
    reset_counts()
    with count_forwards(CharacterCounterNet) as cfwd:
        t0 = time.perf_counter()
        train_charcounter.main(["--gt_train", train_gt, "--epochs", "1", "--save_dir",
                                counter_dir, *common])
        torch.cuda.synchronize()
        counter_wall = time.perf_counter() - t0
    paths["train_charcounter"] = all_counts()
    assert paths["train_charcounter"] == only_groupnorm(0), paths["train_charcounter"]
    assert len(cfwd) == 2 * (PHOSC_TRAIN // PHOSC_B), cfwd  # a step's forward and its accuracy
    reset_counts()
    with count_forwards(PHOSCNet) as tfwd:
        t0 = time.perf_counter()
        res = train_phosc.main(["--mode", "test", "--train_csv", train_gt, "--test_csv", valid_gt,
                                "--model", "resnet18", "--save_dir", save, "--len_counter",
                                os.path.join(counter_dir, "params.pkl"), *common])
        torch.cuda.synchronize()
        test_wall = time.perf_counter() - t0
    paths["train_phosc_test"] = all_counts()
    with open(os.path.join(save, "testresults.txt")) as f:
        results = dict(line.split("=", 1) for line in f.read().splitlines())
    keys = ["zsl", "by_len", "gzsl_seen", "gzsl_unseen", "gzsl_harmonic", "gzsl_calibrated_gamma",
            "gzsl_calibrated_seen", "gzsl_calibrated_unseen", "gzsl_calibrated_harmonic",
            "gzsl_valmargin_gamma", "gzsl_valmargin_seen", "gzsl_valmargin_unseen",
            "gzsl_valmargin_harmonic", "len_zsl", "len_gzsl", "length_accuracy",
            "length_fuzzy_accuracy"]
    values = [float(results[k]) for k in keys if k != "by_len"]
    values += list(ast.literal_eval(results["by_len"]).values())
    log(f"train_charcounter VGG B={PHOSC_B}: 1 epoch of {PHOSC_TRAIN // PHOSC_B} steps in "
        f"{counter_wall:.2f} s, launches {paths['train_charcounter']}; train_phosc --mode test "
        f"--len_counter: {sum(tfwd)} images through the recognizer in {len(tfwd)} forwards, "
        f"launches {paths['train_phosc_test']}, {test_wall:.2f} s, "
        f"{sum(tfwd) / test_wall:.1f} images/s (the counter's forwards and host batches "
        f"included); results {res} [{smi}]")
    assert paths["train_phosc_test"] == only_groupnorm(PHOSC_NORMS * len(tfwd))
    assert list(results) == keys and all(np.isfinite(v) for v in values), results

    # (d) the checkpoint carried into a fresh model on the card and on the host
    sd = state_dict_to_torch(jax_phoscnet_to_torch(best))
    card, host = PHOSCNet(trunk="resnet18"), PHOSCNet(trunk="resnet18", dtype=torch.float32)
    card.load_state_dict(sd)
    host.load_state_dict(sd)
    card = card.cuda().to(memory_format=cl).eval()
    imgs = phosc_images(8, seed=23)
    with torch.no_grad():
        reset_counts()
        a = card(train_phosc.dev_norm(imgs, "cuda"), return_features=True)
        carried = all_counts()
        b = host(train_phosc.dev_norm(imgs, "cpu"), return_features=True)
    carried_rel = {k: ((a[k].cpu() - b[k]).abs().max() / b[k].abs().max()).item() for k in b}
    log(f"best_params.pkl on the card (bf16, B.5) vs on the host (fp32): max_rel_err "
        f"{carried_rel} (tol {PHOSC_BF16_TOL}); launches {carried} [{smi}]")
    assert carried == only_groupnorm(PHOSC_NORMS), carried
    assert max(carried_rel.values()) <= PHOSC_BF16_TOL, carried_rel

    # (e) the CLI's default trunk, 1 epoch of 2 steps
    vgg_dir = os.path.join(work, "phosc_vgg")
    reset_counts()
    t0 = time.perf_counter()
    vrun = train_phosc.main(["--train_csv", small_gt, "--valid_csv", valid_gt, "--epochs", "1",
                             "--save_dir", vgg_dir, *common])
    torch.cuda.synchronize()
    paths["train_phosc_vgg"] = all_counts()
    vgg_best = read_params_pickle(os.path.join(vgg_dir, "best_params.pkl"))
    log(f"train_phosc --model vgg B={PHOSC_B}: history {vrun['history']}, launches "
        f"{paths['train_phosc_vgg']}, {time.perf_counter() - t0:.2f} s [{smi}]")
    assert vrun["history"][0]["steps"] == 2 and np.isfinite(vrun["history"][0]["loss"])
    assert paths["train_phosc_vgg"] == only_groupnorm(0), paths["train_phosc_vgg"]
    assert sorted(vgg_best["params"]["trunk"]) == sorted(f"conv{i}" for i in range(13))
    return dict(paths=paths, fwd_ms=ms, fwd_plain_ms=plain_ms, busy_ms=prof["busy_ms"],
                kernels=prof["kernels"], s_per_step=s_per_step, peak_bytes=peak,
                step_busy_ms=sprof["busy_ms"], step_kernels=sprof["kernels"],
                step_plain_busy_ms=pprof["busy_ms"],
                test_imgs_per_s=sum(tfwd) / test_wall)


def phase22a_renderer(smi: str) -> dict:
    """(a) The PIL-free renderer: every committed check render (6 settings x
    532 words, ``data/render_check.npz``) bitwise, then host ms per image
    at 64x256 and 50x250 (writer-styled, jittered: the training renders)."""
    import hashlib

    import numpy as np

    from worddiffusion_tpu_torch.data import make_glyph_table as mgt
    from worddiffusion_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    ours = mgt.check_renders(synthetic.render_word)
    wall = time.perf_counter() - t0
    with np.load(mgt.CHECK_FILE) as z:
        want = {k: z[k] for k in z.files}
    equal = [str(a) == str(b) for a, b in zip(ours["sha256"], want["sha256"])]
    bitmaps = {k: bool(np.array_equal(ours[k], want[k])) for k in want if k.startswith("bitmap_")}
    words = mgt.WORD_LISTS[:200]
    ms = {}
    for h, w in ((64, 256), (50, 250)):
        t0 = time.perf_counter()
        for i, word in enumerate(words):
            synthetic.render_word(word, h, w, seed=i, style=synthetic.writer_style(str(i % 16)))
        ms[f"{h}x{w}"] = (time.perf_counter() - t0) / len(words) * 1e3
    digest = hashlib.sha256(synthetic.render_word("affine", 64, 256).tobytes()).hexdigest()[:16]
    log(f"renderer: {len(ours['sha256'])} settings x {len(mgt.WORD_LISTS)} words drawn in "
        f"{wall:.2f} s, per setting bitwise the committed renders {equal}, bitmaps {bitmaps}; "
        f"PIL loaded {'PIL' in sys.modules}; host ms per image (styled, jittered) "
        f"{ {k: round(v, 4) for k, v in ms.items()} }; 'affine' sha256 {digest}")
    assert all(equal) and len(equal) == len(mgt.CHECK_SETTINGS) and all(bitmaps.values())
    return dict(ms=ms)


def style_batch(n: int, h: int = 64, w: int = 256):
    """n writer-styled renders in [-1, 1], NHWC float32 on the card."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.data import synthetic
    from worddiffusion_tpu_torch.utils.images import normalize_to_unit

    words = synthetic.word_list(n)
    imgs = [synthetic.render_word(words[i], h, w, seed=i, style=synthetic.writer_style(str(i % 16)))
            for i in range(n)]
    return torch.from_numpy(normalize_to_unit(np.stack(imgs))).cuda()


def phase22c_style_forward(smi: str) -> dict:
    """(c) StyleEncoder(out_dim=4096) at B=48 (one triplet batch), seeded,
    bf16: all-kernel against all-plain, 48 B.5 launches, every GroupNorm
    input channels_last, 48 ``gn_cluster_kernel`` a forward by profiled
    name and no library GroupNorm, device busy ms."""
    import torch

    from worddiffusion_tpu_torch.models.layers import GroupNorm32, init_weights_
    from worddiffusion_tpu_torch.models.style import StyleEncoder

    cl = torch.channels_last
    enc = init_weights_(StyleEncoder(out_dim=4096), seed=0).cuda().to(memory_format=cl)
    enc.eval().requires_grad_(False)
    x = style_batch(STYLE_B)
    layouts = []
    hooks = [m.register_forward_pre_hook(lambda m, a: layouts.append(
        a[0].is_contiguous(memory_format=cl))) for m in enc.modules()
        if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        reset_counts()
        out = enc(x)
        counts = all_counts()
        for h in hooks:
            h.remove()
        with plain_norms():
            ref = enc(x)
            plain_ms = cuda_ms(lambda: enc(x), reps=10)
        ms = cuda_ms(lambda: enc(x), reps=10)
        prof = device_profile(lambda: enc(x), calls=3)
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    gn_kernels = sum(n for k, n in prof["per_call"].items() if "gn_cluster_kernel" in k)
    library_gn = [k for k in prof["per_call"] if "rowwisemoments" in k.lower()
                  or "groupnorm" in k.lower().replace("_", "")]
    log(f"style encoder B={STYLE_B} 64x256 out 4096: {tuple(out.shape)}; launches {counts}; "
        f"all-kernel vs all-plain max_rel_err {rel:.6g} (tol {STYLE_REL_TOL}); GroupNorm inputs "
        f"channels_last {sum(layouts)}/{len(layouts)}; {ms:.3f} ms a forward (plain B.5 "
        f"{plain_ms:.3f}); profiled: device busy {prof['busy_ms']:.3f} ms, "
        f"{prof['kernels']:.0f} kernels, {gn_kernels:.0f} gn_cluster_kernel a forward, library "
        f"GroupNorm kernels {library_gn}; top (ms) {prof['top']} [{smi}]")
    assert counts == only_groupnorm(STYLE_NORMS), counts
    assert out.shape == (STYLE_B, 4096) and bool(torch.isfinite(out).all())
    assert rel <= STYLE_REL_TOL, rel
    assert len(layouts) == STYLE_NORMS and all(layouts), layouts
    assert gn_kernels == STYLE_NORMS and not library_gn, (gn_kernels, library_gn)
    return dict(paths={"style_forward": counts}, ms=ms, plain_ms=plain_ms,
                busy_ms=prof["busy_ms"], kernels=prof["kernels"], rel=rel)


def phase22d_train_style(smi: str, work: str) -> dict:
    """(d) ``cli.train_style.main --synthetic 1`` at out_dim 4096, B=16
    triplets, 2 epochs of 4 steps: 48 B.5 launches a forward (3 a step and
    the corpus encodes) and 48 x 3 GroupNormFn backwards a step, s/step,
    peak memory; its ``style_dict.npz`` conditions one ``cli.train
    --wrdChrWrStyl 1 --style_dict`` step, and ``--allow_random_style 1`` one
    more (a random StyleEncoder encodes up to 4 renders a writer)."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.cli import train_style
    from worddiffusion_tpu_torch.models.style import StyleEncoder

    save = os.path.join(work, "style")
    writers, per_writer = 16, 4
    paths = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_forwards(StyleEncoder) as fwd:
        run = train_style.main(["--synthetic", "1", "--writers", str(writers),
                                "--samples_per_writer", str(per_writer), "--epochs", "2",
                                "--batch_size", "16", "--out_dim", "4096", "--save_dir", save,
                                "--device", "cuda"])
        torch.cuda.synchronize()
    paths["train_style_cli"] = all_counts()
    gn_bwd = norm_counts()[2]
    peak = torch.cuda.max_memory_allocated() - base
    hist = run["history"][1]
    steps = sum(h["steps"] for h in run["history"])
    with np.load(os.path.join(save, "style_dict.npz")) as z:
        styles = {k: z[k] for k in z.files}
    log(f"train_style B=16 triplets, out 4096: {steps} steps, epoch 2 "
        f"{hist['train_seconds'] / hist['steps']:.4f} s/step (host triplet assembly included), "
        f"{len(fwd)} forwards, launches {paths['train_style_cli']}, GroupNormFn backward "
        f"calls {gn_bwd}; history {run['history']}; style_dict {len(styles)} writers x "
        f"{next(iter(styles.values())).shape}; peak memory above the phase's start "
        f"{peak / 2 ** 30:.3f} GiB [{smi}]")
    # three forwards a step; each epoch's retrieval and the final dict encode
    # every writer's stack once
    assert steps == 2 * writers * per_writer // 16 and len(fwd) == 3 * steps + 3 * writers, fwd
    assert paths["train_style_cli"] == only_groupnorm(STYLE_NORMS * len(fwd)), paths
    assert gn_bwd == STYLE_NORMS * 3 * steps, gn_bwd
    assert sorted(styles) == sorted(str(i) for i in range(writers))
    assert all(v.shape == (4096,) and np.isfinite(v).all() for v in styles.values())

    def one_step(label, *extra):
        reset_counts()
        trainer = train_cli.build(train_cli.build_parser().parse_args([
            "--preset", "iam", "--synthetic", "1", "--vocab_size", "8", "--samples_per_word",
            "2", "--batch_size", "16", "--epochs", "1", "--wrdChrWrStyl", "1", "--save_path",
            os.path.join(work, label), "--seed", "0", "--device", "cuda", *extra]))
        built = all_counts()
        reset_counts()
        state = trainer.run(epochs=1)
        torch.cuda.synchronize()
        paths[label] = all_counts()
        loss = torch.load(trainer.ckpt.path(1), map_location="cpu",
                          weights_only=True)["metrics"]["loss"]
        log(f"train --wrdChrWrStyl 1 {' '.join(extra)}: {state.step} step of B=16, loss "
            f"{loss:.6g}; launches while building {built}, in the step {paths[label]} [{smi}]")
        assert state.step == 1 and np.isfinite(loss)
        step_norms = tuple(u + e for u, e in zip(UNET_NORMS, ENCODER_NORMS))
        assert (paths[label]["gn"], paths[label]["conv"]) == step_norms, paths[label]
        return trainer, built

    trainer, _ = one_step("train_style_dict", "--style_dict",
                          os.path.join(save, "style_dict.npz"))
    assert all(np.array_equal(trainer.dataset.style_lookup[k], styles[k]) for k in styles)
    _, built = one_step("train_random_style", "--allow_random_style", "1")
    # 8 writers, 2 renders each, one random-encoder forward a writer
    assert built == only_groupnorm(STYLE_NORMS * 8), built
    paths["train_random_style"] = {k: v + built[k]
                                   for k, v in paths["train_random_style"].items()}
    return dict(paths=paths, s_per_step=hist["train_seconds"] / hist["steps"], peak_bytes=peak)


def phase22e_train_ocr(smi: str, work: str, cli, gt: str) -> dict:
    """(e) ``cli.train_ocr.main --synthetic 1``: 2 epochs of 2 steps at
    B=32 (16 words x 4 renders), 10 B.5 launches a forward and 10
    GroupNormFn backwards a step, the held-out exact match; its ``ocr.pt``
    read by one regeneration batch through ``--ocr_pt`` (10 B.5 more for
    the filter)."""
    import torch

    from worddiffusion_tpu_torch.cli import train_ocr
    from worddiffusion_tpu_torch.models.ocr import CTCRecognizer

    save = os.path.join(work, "ocr")
    reset_counts()
    with count_forwards(CTCRecognizer) as fwd:
        run = train_ocr.main(["--synthetic", "1", "--vocab_size", "16", "--samples_per_word", "4",
                              "--batch_size", "32", "--epochs", "2", "--eval_renders", "2",
                              "--save_dir", save, "--device", "cuda"])
        torch.cuda.synchronize()
    paths = {"train_ocr_cli": all_counts()}
    gn_bwd = norm_counts()[2]
    steps = sum(h["steps"] for h in run["history"])
    s_per_step = run["history"][1]["train_seconds"] / run["history"][1]["steps"]
    log(f"train_ocr B=32: {steps} steps, {s_per_step:.4f} s/step (epoch 2, host renders "
        f"included), {len(fwd)} forwards, launches {paths['train_ocr_cli']}, GroupNormFn backward "
        f"calls {gn_bwd}; held-out exact match {run['metrics']['heldout_exact_match']} over "
        f"{run['metrics']['eval_images']} images; metrics {run['metrics']} [{smi}]")
    assert steps == 4 and len(fwd) == steps + 2, fwd
    assert paths["train_ocr_cli"] == only_groupnorm(OCR_NORMS[0] * len(fwd)), paths["train_ocr_cli"]
    assert gn_bwd == OCR_NORMS[0] * steps, gn_bwd

    pt = os.path.join(save, "ocr.pt")
    argv = ["--gt_file", gt, "--dump_path", os.path.join(work, "regen_ocr"), "--batch_size",
            str(B), "--max_batches", "1", "--keep_rejected", "1", "--seed", "0", "--ddim", "10",
            "--ocr_pt", pt]
    regen, _ = cli.build(cli.build_parser().parse_args(argv))
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    assert all(torch.equal(v.cpu(), sd[k]) for k, v in regen.sampler.ocr_apply.state_dict().items())
    del regen
    reset_counts()
    stats = cli.main(argv)
    torch.cuda.synchronize()
    paths["regen_ocr_pt"] = all_counts()
    log(f"regen CLI --ocr_pt (train_ocr's) --ddim 10: {stats.generated} generated, "
        f"{stats.accepted} accepted by the trained filter; launches {paths['regen_ocr_pt']} "
        f"[{smi}]")
    assert stats.generated == B
    assert paths["regen_ocr_pt"]["gn"] == 10 * UNET_NORMS[0] + DECODER_NORMS[0] + OCR_NORMS[0]
    return dict(paths=paths, s_per_step=s_per_step,
                exact=run["metrics"]["heldout_exact_match"], pt=pt)


def phase22f_train_vae(smi: str, work: str) -> dict:
    """(f) ``cli.train_vae.main --synthetic 1`` at full width (SD's VAE),
    B=16, 2 epochs of one step: 8 B.5 and 44 B.6 launches a forward (encode
    4 + 18, decode 4 + 26) and as many Function backwards a step, s/step,
    peak memory; its ``vae.pt`` read by ``build_latent_cache --synthetic 1
    --vae_pt``."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
    from worddiffusion_tpu_torch.cli import train_vae

    save = os.path.join(work, "vae_trained")
    per_fwd = tuple(e + d for e, d in zip(ENCODER_NORMS, DECODER_NORMS))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_vae.main(["--synthetic", "1", "--vocab_size", "8", "--samples_per_word", "2",
                          "--batch_size", "16", "--epochs", "2", "--log_every", "1", "--save_dir",
                          save, "--device", "cuda"])
    torch.cuda.synchronize()
    paths = {"train_vae_cli": all_counts()}
    gn_bwd, conv_bwd = norm_counts()[2:]
    peak = torch.cuda.max_memory_allocated() - base
    steps = run["metrics"]["steps"]
    s_per_step = run["epoch_seconds"][1]  # epoch 2: one step of B=16
    log(f"train_vae B=16 full width: {steps} steps, epoch 2 {s_per_step:.4f} s/step, launches "
        f"{paths['train_vae_cli']}, Function backward calls "
        f"B.5 {gn_bwd} B.6 {conv_bwd}; metrics {run['metrics']}; peak memory above the phase's "
        f"start {peak / 2 ** 30:.3f} GiB [{smi}]")
    assert steps == 2 and np.isfinite(run["metrics"]["heldout_mse"])
    # the steps' forwards and the held-out probe's
    assert (paths["train_vae_cli"]["gn"], paths["train_vae_cli"]["conv"]) == tuple(
        n * (steps + 1) for n in per_fwd), paths["train_vae_cli"]
    assert (gn_bwd, conv_bwd) == tuple(n * steps for n in per_fwd), (gn_bwd, conv_bwd)

    pt = os.path.join(save, "vae.pt")
    argv = ["--preset", "iam", "--synthetic", "1", "--vocab_size", "4", "--samples_per_word",
            "4", "--vae_pt", pt, "--batch_size", "16", "--deterministic", "1", "--out",
            os.path.join(work, "vae_trained_cache.npz"), "--device", "cuda"]
    _, vae = cache_cli.build(cache_cli.build_parser().parse_args(argv))
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    assert sd.keys() == vae.state_dict().keys()
    assert all(torch.equal(v.cpu(), sd[k]) for k, v in vae.state_dict().items())
    del vae
    reset_counts()
    cache = cache_cli.main(argv)
    torch.cuda.synchronize()
    paths["cache_vae_pt"] = all_counts()
    log(f"build_latent_cache --synthetic 1 --vae_pt (train_vae's): {len(cache)} latents, "
        f"launches {paths['cache_vae_pt']} [{smi}]")
    assert len(cache) == 16
    assert (paths["cache_vae_pt"]["gn"], paths["cache_vae_pt"]["conv"]) == ENCODER_NORMS
    return dict(paths=paths, s_per_step=s_per_step, peak_bytes=peak)


def phase22g_train_glyphs(smi: str, work: str) -> dict:
    """(g) ``cli.train --synthetic 1 --charImages 1`` at ``iam`` width
    (glyph crops as 10 more context tokens), B=32 from rendered words
    encoded each step, 2 epochs of 2 steps and a DDIM-10 preview; a
    max_steps stop and a resume bitwise the uninterrupted run."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli

    def args(save: str, *extra: str):
        return train_cli.build_parser().parse_args([
            "--preset", "iam", "--synthetic", "1", "--vocab_size", "8", "--samples_per_word",
            "8", "--charImages", "1", "--batch_size", "32", "--epochs", "2",
            "--ckpt_every_epochs", "2", "--preview_ddim", "10", "--save_path",
            os.path.join(work, save), "--seed", "0", "--device", "cuda", *extra])

    trainer = train_cli.build(args("glyph"))
    assert trainer.exp.unet.use_char_images and trainer.dataset.char_images
    glyph0 = trainer.init_state().model.glyph_conv1.weight.detach().cpu().clone()
    reset_counts()
    state = trainer.run(epochs=2)
    torch.cuda.synchronize()
    counts = all_counts()
    gn_bwd, conv_bwd = norm_counts()[2:]
    steps = state.step
    k_s, k_n = trainer.epoch_seconds[1]
    step_norms = [u + e for u, e in zip(UNET_NORMS, ENCODER_NORMS)]
    preview = [10 * u + d for u, d in zip(UNET_NORMS, DECODER_NORMS)]
    log(f"train --synthetic 1 --charImages 1 B=32: {steps} steps, {k_s / k_n:.4f} s/step "
        f"(epoch 2, renders and encodes included); launches {counts}, Function backward calls "
        f"B.5 {gn_bwd} B.6 {conv_bwd} [{smi}]")
    assert steps == 4 and (counts["gn"], counts["conv"]) == tuple(
        n * steps + p for n, p in zip(step_norms, preview)), counts
    assert (gn_bwd, conv_bwd) == tuple(n * steps for n in UNET_NORMS), (gn_bwd, conv_bwd)
    assert counts["ffn_bwd"] == 4 * steps and counts["attn"] == 8 * steps + 8 * 10, counts

    part = train_cli.build(args("glyph_resume")).run(epochs=2, max_steps=3)
    assert part.step == 3, part.step
    resumed = train_cli.build(args("glyph_resume", "--loadPrev", "1")).run(epochs=2, resume=True)
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    moved = not torch.equal(state.model.glyph_conv1.weight.detach().cpu(), glyph0)
    log(f"train --charImages 1 resume: stopped at 3, resumed to {resumed.step}; max param diff "
        f"vs the uninterrupted run {diff:.6g} (must be bitwise 0); glyph_conv1 weight moved "
        f"{moved}")
    assert resumed.step == steps and diff == 0 and moved, (diff, moved)
    return dict(paths={"train_char_images": counts}, s_per_step=k_s / k_n)


def phase22h_evaluate(smi: str, work: str, real_dir: str, phosc_pkl: str, ocr_pt: str) -> dict:
    """(h) ``cli.evaluate.main`` over phase 16's word PNGs (real) against
    phase 16's regeneration dump (``{img}_{writer}_{word}.png``), with a
    seeded torchvision-layout Inception ``.pt``, phase 21's PHOSC checkpoint
    and 22(e)'s OCR; then the style-encoder fallback. Every JSON key, images/s
    per featurizer, B.5 launches (16 a PHOSC batch, 10 an OCR batch, 48 a
    style-encoder batch); and the Inception featurizer on the card against
    the host."""
    import logging
    import shutil

    import torch

    from worddiffusion_tpu_torch.cli import evaluate
    from worddiffusion_tpu_torch.eval.inception import (load_inception_featurizer,
                                                        seeded_torchvision_state_dict)

    fake = os.path.join(work, "eval_fake")
    os.makedirs(fake)
    dump = os.path.join(work, "regen_ddim")
    for d in (dump, os.path.join(dump, "rejected")):
        for n in os.listdir(d):
            if n.endswith(".png"):
                shutil.copy(os.path.join(d, n), fake)
    inc = os.path.join(work, "inception.pt")
    torch.save(seeded_torchvision_state_dict(0), inc)
    # the featurizer on the card (fp32, TF32 off) against the host
    x = evaluate._load_dir(real_dir, 64, 256, limit=8)[0]
    on_card = load_inception_featurizer(inc, "cuda")(x)
    on_host = load_inception_featurizer(inc, "cpu")(x)
    inc_rel = float(abs(on_card - on_host).max() / abs(on_host).max())
    log(f"inception features of 8 real crops, card vs host: max_rel_err {inc_rel:.6g} (tol "
        f"{INCEPTION_TOL}) [{smi}]")
    assert inc_rel <= INCEPTION_TOL, inc_rel
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("featurizer "):
                lines.append(record.getMessage())

    handler, root = Grab(), logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        base = ["--real_dir", real_dir, "--fake_dir", fake, "--device", "cuda"]
        reset_counts()
        full = evaluate.main(base + ["--inception_weights", inc, "--phosc_params", phosc_pkl,
                                     "--phosc_trunk", "resnet18", "--ocr_pt", ocr_pt])
        torch.cuda.synchronize()
        paths = {"evaluate": all_counts()}
        reset_counts()
        fallback = evaluate.main(base)
        torch.cuda.synchronize()
        paths["evaluate_style"] = all_counts()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    n_real, n_fake = (sum(n.endswith(".png") for n in os.listdir(d)) for d in (real_dir, fake))
    bs = 32
    phosc_batches = -(-n_real // bs) + -(-n_fake // bs) + -(-full.get("phosc_zsl_n", n_fake) // bs)
    log(f"evaluate: {n_real} real, {n_fake} generated; JSON {full}; fallback JSON {fallback}; "
        f"{lines}; launches {paths} [{smi}]")
    assert set(full) >= {"fid_inception", "fid_phosc", "ocr_exact_match", "phosc_zsl_accuracy"}
    assert set(full) <= {"fid_inception", "fid_phosc", "ocr_exact_match", "phosc_zsl_accuracy",
                         "phosc_zsl_n", "phosc_zsl_note"}
    assert list(fallback) == ["fid_style_encoder"] and len(lines) == 7, lines
    assert all(v == v for v in list(full.values()) + list(fallback.values()))  # no NaN
    assert paths["evaluate"]["gn"] == PHOSC_NORMS * phosc_batches + OCR_NORMS[0] * -(-n_fake // bs)
    assert paths["evaluate_style"]["gn"] == STYLE_NORMS * (-(-n_real // bs) + -(-n_fake // bs))
    return dict(paths=paths, json=full, fallback=fallback, rates=lines)


def phase22i_masked(smi: str, unet, sampler, words) -> dict:
    """(i) ``diffusion.masking.masked_ddpm_sample`` with the ``iam`` UNet
    (seeded, B=16) over the preset's 600 steps: 599 UNet calls, kernels per
    call, time."""
    import torch

    from worddiffusion_tpu_torch.diffusion.masking import masked_ddpm_sample

    x, _, ctx, wid, _ = unet_inputs(sampler, words, phosc=False)
    g = torch.Generator(device="cuda").manual_seed(5)
    ref = torch.randn(x.shape, generator=g, device="cuda") * 0.5 + 0.3
    schedule = sampler.schedule
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = masked_ddpm_sample(schedule, lambda xx, tt: unet(xx, tt, ctx, wid).float(), ref,
                                    generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = all_counts()
    calls = schedule.num_steps - 1
    per_call = {k: v / calls for k, v in counts.items()}
    log(f"masked_ddpm_sample iam B={B}: {calls} UNet calls in {wall:.3f} s "
        f"({wall / calls * 1e3:.3f} ms a call); launches {counts}, per call {per_call}; output "
        f"finite {bool(torch.isfinite(out).all())} [{smi}]")
    assert calls == 599 and bool(torch.isfinite(out).all())
    assert counts == dict(ffn=4 * calls, ffn_bwd=0, attn=8 * calls, fold=0, fold_b7=0,
                          gn=UNET_NORMS[0] * calls, conv=UNET_NORMS[1] * calls, geglu=0), counts
    return dict(paths={"masked_sample": counts}, s=wall, ms_per_call=wall / calls * 1e3)


def phase22_side(smi: str, work: str, cli, gt: str, sampler, words, real_dir: str) -> dict:
    """Phase 22: the synthetic renderer, the writer-style encoder, the OCR,
    VAE and style trainers, the evaluation CLI and the masked sampler."""
    out = dict(renderer=phase22a_renderer(smi))
    out["style"] = phase22c_style_forward(smi)
    out["train_style"] = phase22d_train_style(smi, work)
    out["train_ocr"] = phase22e_train_ocr(smi, work, cli, gt)
    out["train_vae"] = phase22f_train_vae(smi, work)
    out["glyphs"] = phase22g_train_glyphs(smi, work)
    out["evaluate"] = phase22h_evaluate(smi, work, real_dir,
                                        os.path.join(work, "phosc_resnet18", "best_params.pkl"),
                                        out["train_ocr"]["pt"])
    out["masked"] = phase22i_masked(smi, sampler.model, sampler, words)
    out["paths"] = {k: v for part in out.values() if "paths" in part
                    for k, v in part["paths"].items()}
    return out


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


def unet_check(smi: str, unet, inputs, label: str, launches=(4, 8, 0, *UNET_NORMS)) -> dict:
    """One UNet call with every kernel against the all-plain UNet (plain FF,
    plain attention, plain fold, plain B.5 and B.6) on the same weights;
    kernel launches per call (FF, attention, fold attention, B.5, B.6:
    ``launches``); call times all-kernel, without B.5 and B.6 (their plain
    versions, the other kernels on), and all-plain; device busy time and
    kernels per call, with and without B.5 and B.6."""
    import torch

    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

    plain = UNet(dataclasses.replace(unet.cfg, use_pallas_ffn=False)).cuda().eval()
    plain.load_state_dict(unet.state_dict())
    with torch.no_grad():
        f0, a0, d0 = ffn.launches, attention.launches, fold_attention.launches
        n0 = norm_counts()
        eps_k = unet(*inputs)
        n_ff, n_attn = ffn.launches - f0, attention.launches - a0
        n_fold = fold_attention.launches - d0
        n_gn, n_conv = (b - a for a, b in zip(n0[:2], norm_counts()[:2]))
        with plain_norms():
            before_ms = cuda_ms(lambda: unet(*inputs), reps=10)
            prof_before = device_profile(lambda: unet(*inputs))
        with all_plain():
            eps_p = plain(*inputs)
            plain_ms = cuda_ms(lambda: plain(*inputs), reps=10)
        err = (eps_k - eps_p).abs().max().item()
        rel = err / eps_p.abs().max().item()
        unet_ms = cuda_ms(lambda: unet(*inputs), reps=10)
        prof = device_profile(lambda: unet(*inputs))
    got = (n_ff, n_attn, n_fold, n_gn, n_conv)
    by_name = {k: sum(n for name, n in prof["per_call"].items() if k in name)
               for k in ("ffn_kernel<", "gn_cluster_kernel", "gn_partial_kernel",
                         "gn_finalize_kernel")}
    log(f"unet B={B} ({label}, {unet.cfg.model_channels} ch): eps max_abs_err {err:.6g} "
        f"max_rel_err {rel:.6g} (tol {UNET_REL_TOL}) against all-plain; launches per call: "
        f"{n_ff} FF, {n_attn} attention, {n_fold} fold attention, {n_gn} groupnorm, {n_conv} "
        f"gn_silu_conv3x3; call {unet_ms:.3f} ms all kernels, {before_ms:.3f} ms with plain "
        f"B.5/B.6, {plain_ms:.3f} ms all plain; profiled device busy {prof['busy_ms']:.4f} ms "
        f"and {prof['kernels']:.0f} kernels per call ({prof_before['busy_ms']:.4f} ms and "
        f"{prof_before['kernels']:.0f} with plain B.5/B.6); profiled kernels per call by name "
        f"{by_name}; top kernels (ms/call) {prof['top']} [{smi}]")
    assert got == tuple(launches), got
    # one B.1 kernel per FF sub-layer and one B.5 kernel per GroupNorm; the
    # statistics pass's two kernels only behind B.6
    assert by_name == {"ffn_kernel<": n_ff, "gn_cluster_kernel": n_gn,
                       "gn_partial_kernel": n_conv, "gn_finalize_kernel": n_conv}, by_name
    assert bool(torch.isfinite(eps_k).all()), "non-finite eps"
    assert rel <= UNET_REL_TOL, f"UNet all-kernel vs all-plain: rel {rel}"
    return dict(ms=unet_ms, before_ms=before_ms, plain_ms=plain_ms, err=err, rel=rel,
                eps=eps_k, busy_ms=prof["busy_ms"], kernels=prof["kernels"], top=prof["top"],
                busy_before_ms=prof_before["busy_ms"], kernels_before=prof_before["kernels"])


def drive_regen(smi: str, regen, samples, seed: int, label: str,
                per_call=(4, 8, 0, *UNET_NORMS)) -> dict:
    """The regeneration main path over ``samples``: counts set to 0 just
    before the run and read just after; checks shapes, finiteness, the
    PNGs and the FF, attention, fold attention, B.5 and B.6 launches per
    denoiser call (``per_call``) plus, per batch, one VAE decode and one
    OCR call's B.5 and B.6."""
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

    reset_counts()
    t0 = time.perf_counter()
    stats = regen.run(samples, batch_size=B, seed=seed)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    got = (ffn.launches, attention.launches, fold_attention.launches, *norm_counts()[:2])
    geglu, fold7 = ffn.geglu_launches, fold_attention.flat_launches

    dump = regen.out_dir
    n_batches = -(-len(samples) // B)
    log(f"regen {label}: {stats.generated} generated, {stats.accepted} accepted, {n_batches} "
        f"batches of {B}, {calls} denoiser calls each; {elapsed / n_batches:.3f} s/batch, "
        f"{stats.generated / elapsed:.2f} imgs/s (incl. PNG writes) [{smi}]")
    per_batch = (0, 0, 0, DECODER_NORMS[0] + OCR_NORMS[0], DECODER_NORMS[1] + OCR_NORMS[1])
    want = tuple((k * calls + p) * n_batches for k, p in zip(per_call, per_batch))
    log(f"kernel launches in the {label} main path (FF, attention, fold attention, groupnorm, "
        f"gn_silu_conv3x3): {got} (expect ({per_call} x {calls} calls + {per_batch}) x "
        f"{n_batches} batches = {want})")
    assert calls == 120, calls
    assert got == want and geglu == 0 and fold7 == 0, (got, want, geglu, fold7)
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
    return dict(zip(("ffn", "attn", "fold", "gn", "conv"), got), geglu=geglu, fold_b7=fold7,
                s_per_batch=elapsed / n_batches, imgs_per_s=stats.generated / elapsed)


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

    stamp("1")
    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    log(f"build: {lib} in {time.perf_counter() - t0:.2f} s")

    stamp("2")
    # -- 3. kernel vs plain ------------------------------------------------
    ffn_rows = []
    for i, m in enumerate(FFN_SHAPES + FFN_SMALL_SHAPES):
        a = ffn_inputs(m, seed=i)
        got, again = ffn.fused_ln_geglu_ffn(**a), ffn.fused_ln_geglu_ffn(**a)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_reference(**a)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: ffn.fused_ln_geglu_ffn(**a))
        plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_reference(**a))
        bound_ms, bound_by = ffn_bound(a, got)
        log(f"ffn M={m} d={D} inner={INNER} (cluster of {ffn.cluster_size(m, INNER)}): "
            f"max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {FFN_REL_TOL}); bitwise "
            f"repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"bound {bound_ms:.4f} ms ({bound_by}) [{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at M={m}"
        assert torch.equal(got, again), f"B.1 differs between two runs at M={m}"
        assert rel <= FFN_REL_TOL, f"kernel disagrees with plain at M={m}: rel {rel}"
        ffn_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))

    geglu = phase3_geglu(smi)

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

    stamp("3")
    # -- 4. whole UNet: all kernels vs all plain ---------------------------
    unet = unet_check(smi, sampler.model, unet_inputs(sampler, words, phosc=False), "iam")
    assert unet["kernels"] == UNET_KERNELS, (unet["kernels"], UNET_KERNELS)

    stamp("4")
    # -- 5. main path ------------------------------------------------------
    regen_iam = drive_regen(smi, regen, samples, seed=0, label="iam")
    batch_seconds(smi, sampler, words[:B], "iam")

    stamp("5")
    # -- 6. FFN forward + backward: kernel vs plain -------------------------
    bwd = phase6_ffn_backward(smi)

    stamp("6")
    # -- 7. training main path -----------------------------------------------
    n = TRAIN_B * TRAIN_STEPS_PER_EPOCH + TRAIN_B // 2  # a half batch to drop_remainder
    corpus = write_latent_corpus(work, n)
    train = phase7_train(smi, work, corpus)

    stamp("7")
    # -- 8. attention kernel vs plain -----------------------------------------
    attn = phase8_attention(smi)

    stamp("8")
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

    stamp("9")
    # -- 10. iam_phosc training --------------------------------------------------
    train_p = phase10_phosc_train(smi, work, corpus)

    stamp("10")
    # -- 11. fold attention kernel vs plain ----------------------------------------
    fold = phase11_fold(smi)

    stamp("11")
    # -- 12. iam_fold regeneration ---------------------------------------------------
    register_fold_preset()
    regen_fold = phase12_fold_regen(smi, cli, gt, work, words)

    stamp("12")
    # -- 13. iam_fold training ----------------------------------------------------------
    train_f = phase13_fold_train(smi, work, corpus)

    stamp("13")
    # -- 14. GroupNorm (B.5) and GN -> SiLU -> conv3x3 (B.6) kernels vs plain ---------------
    norms = phase14_norms(smi)

    # the redesigned kernels against their targets: B.5 at the UNet's B=16
    # sites against one library call, B.1 at the main path's M and at the
    # training M, B.2 against B.1 at the training M
    gns = [r for r in norms["gn_rows"] if r["shape"][0] == B][:5]
    f_train = next(r for r in bwd["fwd_rows"] if r["m"] == TRAIN_B * 256)
    g_train = next(r for r in geglu["rows"] if r["m"] == TRAIN_B * 256)
    b3 = next(r for r in bwd["rows"] if r["m"] == TRAIN_B * 256)
    f8 = {(r["b"], r["n"]): r for r in fold["rows"]}
    log(f"redesign targets [{smi}]: ln_geglu_ffn_bwd M={TRAIN_B * 256} {b3['ms']:.4f} ms "
        f"(target 1.75, parent 3.5062); fwd+bwd pair {bwd['pair_ms']:.4f} ms vs plain autograd "
        f"{bwd['plain_pair_ms']:.4f} ms; fold B={TRAIN_B} N=256 {f8[TRAIN_B, 256]['ms']:.4f} ms "
        f"(target 0.10, parent 0.3084); fold B={B} N=256 / 64 {f8[B, 256]['ms']:.4f} / "
        f"{f8[B, 64]['ms']:.4f} ms")
    log(f"redesign targets [{smi}]: groupnorm B={B} "
        + "; ".join(f"{h}x{w} C={c} {r['ms']:.4f} ms vs {r['library_ms']:.4f} ms"
                    for (_, h, w, c, _, _), r in ((r["shape"], r) for r in gns))
        + f"; ln_geglu_ffn M={B * 256} {ffn_rows[0]['ms']:.4f} ms (target 0.10, plain "
        f"{ffn_rows[0]['plain_ms']:.4f}), M={TRAIN_B * 256} {f_train['ms']:.4f} ms (target 0.50); "
        f"geglu_ffn M={TRAIN_B * 256} {g_train['ms']:.4f} ms")

    stamp("14")
    # -- 15. the whole VAE, all kernels vs all plain -------------------------------------
    vae = phase15_vae(smi)

    stamp("15")
    # -- 16. building the latent cache through its CLI ---------------------------------
    images = write_image_corpus(work)
    built = phase16_cache(smi, work, images)
    phase16_ddim_regen(smi, cli, gt, work, images[2])

    stamp("16")
    # -- 17. training from word images through the train CLI ------------------------------
    train_i = phase17_train_images(smi, work, images, built["cache"])

    stamp("17")
    # -- 18. the ResBlock variants' UNet calls, all kernels vs all plain ---------------------
    variants = phase18_variants(smi, sampler, words)

    stamp("18")
    # -- 19. conditioned training through the train CLI -----------------------------------
    cond = cond_corpus(work, corpus)
    cond_train = phase19_cond_train(smi, work, cond)

    stamp("19")
    # -- 20. the sampling CLI --------------------------------------------------------------
    sampled = phase20_sample(smi, work, images[2], os.path.join(images[0], "c01-0000u-00.png"),
                             cond_train, cond[2])

    stamp("20")
    # -- 21. the PHOSC recognizer: forward, train_phosc, train_charcounter, test mode ------------
    phosc = phase21_phosc(smi, work)

    stamp("21")
    # -- 22. renderer, style encoder, side-model trainers, evaluation, masked sampling ---------
    side = phase22_side(smi, work, cli, gt, sampler, words, images[0])

    stamp("22")
    paths = ("regenerate", "regenerate_iam_phosc", "regenerate_iam_fold", "train",
             "train_iam_phosc", "train_iam_fold", "build_latent_cache", "train_from_images")
    # the paths of phases 18-20, each with its counts under chip_smoke's keys
    new_paths = {**{f"unet_{k}": dict(zip(("ffn", "attn", "fold", "gn", "conv"), v["counts"]),
                                      ffn_bwd=0, fold_b7=0, geglu=0) for k, v in variants.items()},
                 **{f"train_{k}": v for k, v in cond_train.items()},
                 **{k: dict(v, ffn_bwd=0) for k, v in sampled.items()},
                 **phosc["paths"], **side["paths"]}

    def by_path(*counts, key=None):
        """The earlier paths' counts in order, then the new paths' ``key``."""
        return {**dict(zip(paths, counts)), **{p: c[key] for p, c in new_paths.items()}}

    ffn_paths = by_path(regen_iam["ffn"], regen_phosc["ffn"], regen_fold["ffn"], train["fwd"],
                        train_p["fwd"], train_f["ffn"], 0, train_i["ffn"], key="ffn")
    bwd_paths = by_path(0, 0, 0, train["bwd"], train_p["bwd"], train_f["ffn_bwd"], 0,
                        train_i["ffn_bwd"], key="ffn_bwd")
    attn_paths = by_path(regen_iam["attn"], regen_phosc["attn"], regen_fold["attn"],
                         train["attn"], train_p["attn"], train_f["attn"], 0, train_i["attn"],
                         key="attn")
    fold_paths = by_path(0, 0, regen_fold["fold"], 0, 0, train_f["fold"], 0, 0, key="fold")
    fold7_paths = by_path(regen_iam["fold_b7"], regen_phosc["fold_b7"], regen_fold["fold_b7"],
                          train["fold_b7"], train_p["fold_b7"], train_f["fold_b7"],
                          built["fold_b7"], train_i["fold_b7"], key="fold_b7")
    gn_paths = by_path(regen_iam["gn"], regen_phosc["gn"], regen_fold["gn"], train["gn"],
                       train_p["gn"], train_f["gn"], built["gn"], train_i["gn"], key="gn")
    conv_paths = by_path(regen_iam["conv"], regen_phosc["conv"], regen_fold["conv"],
                         train["conv"], train_p["conv"], train_f["conv"], built["conv"],
                         train_i["conv"], key="conv")
    geglu_paths = by_path(regen_iam["geglu"], regen_phosc["geglu"], regen_fold["geglu"],
                          train["geglu"], train_p["geglu"], train_f["geglu"], built["geglu"],
                          train_i["geglu"], key="geglu")
    main_row, bwd_row, attn_row = ffn_rows[0], bwd["rows"][0], attn["rows"][0]
    fold_row = fold["rows"][0]
    # B.5's and B.6's rows: the UNet regeneration call's first site (B=16, 8x32)
    gn_row, conv_row = norms["gn_rows"][0], norms["conv_rows"][0]
    log(f"summary [{smi}]: iam UNet call {unet['ms']:.3f} ms (plain B.5/B.6 "
        f"{unet['before_ms']:.3f}), device busy {unet['busy_ms']:.4f} ms and "
        f"{unet['kernels']:.0f} kernels per call (plain B.5/B.6 {unet['busy_before_ms']:.4f} ms, "
        f"{unet['kernels_before']:.0f}); iam_phosc UNet call {unet_p['ms']:.3f} ms (plain B.5/B.6 "
        f"{unet_p['before_ms']:.3f}); iam_fold UNet call {regen_fold['unet_ms']:.3f} ms "
        f"(unfolded {regen_fold['unfolded_ms']:.3f}); regen s/batch iam "
        f"{regen_iam['s_per_batch']:.4f}, iam_phosc {regen_phosc['s_per_batch']:.4f}, iam_fold "
        f"{regen_fold['s_per_batch']:.4f}; imgs/s iam {regen_iam['imgs_per_s']:.3f}, iam_phosc "
        f"{regen_phosc['imgs_per_s']:.3f}, iam_fold {regen_fold['imgs_per_s']:.3f}; train s/step "
        f"iam {train['s_per_step']:.4f} (peak above start "
        f"{train['peak_bytes'] / 2 ** 30:.3f} GiB), iam_phosc {train_p['s_per_step']:.4f}, "
        f"iam_fold {train_f['s_per_step']:.4f}, from images {train_i['s_per_step']:.4f} (from "
        f"their cache {train_i['cached_s_per_step']:.4f}, peak "
        f"{train_i['peak_bytes'] / 2 ** 30:.3f} GiB); "
        f"VAE encode B={TRAIN_B} {vae['enc_ms']:.3f} ms (plain B.5/B.6 {vae['enc_plain_ms']:.3f}), "
        f"decode B={B} {vae['dec_ms']:.3f} ms (plain {vae['dec_plain_ms']:.3f}); cache build "
        f"{built['imgs_per_s']:.2f} images/s; UNet call "
        + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in variants.items())
        + "; train s/step " + ", ".join(f"{k} {v['s_per_step']:.4f} (peak above start "
                                        f"{v['peak_bytes'] / 2 ** 30:.3f} GiB)"
                                        for k, v in cond_train.items())
        + "; sample s/batch " + ", ".join(f"{k} {v['s_per_batch']:.3f}"
                                          for k, v in sampled.items())
        + f"; PHOSCNet resnet18 B={PHOSC_B} forward {phosc['fwd_ms']:.3f} ms (plain B.5 "
        f"{phosc['fwd_plain_ms']:.3f}), busy {phosc['busy_ms']:.3f} ms, {phosc['kernels']:.0f} "
        f"kernels; train_phosc {phosc['s_per_step']:.4f} s/step (step busy "
        f"{phosc['step_busy_ms']:.3f} ms, plain B.5 forward {phosc['step_plain_busy_ms']:.3f}, "
        f"{phosc['step_kernels']:.0f} kernels; peak above start "
        f"{phosc['peak_bytes'] / 2 ** 30:.3f} GiB), test mode {phosc['test_imgs_per_s']:.1f} "
        f"images/s; renderer ms/image "
        + ", ".join(f"{k} {v:.4f}" for k, v in side["renderer"]["ms"].items())
        + f"; StyleEncoder B={STYLE_B} forward {side['style']['ms']:.3f} ms (plain B.5 "
        f"{side['style']['plain_ms']:.3f}), busy {side['style']['busy_ms']:.3f} ms; s/step "
        f"train_style {side['train_style']['s_per_step']:.4f} (peak "
        f"{side['train_style']['peak_bytes'] / 2 ** 30:.3f} GiB), train_ocr "
        f"{side['train_ocr']['s_per_step']:.4f}, train_vae {side['train_vae']['s_per_step']:.4f} "
        f"(peak {side['train_vae']['peak_bytes'] / 2 ** 30:.3f} GiB), --charImages "
        f"{side['glyphs']['s_per_step']:.4f}; masked_ddpm_sample {side['masked']['s']:.3f} s "
        f"({side['masked']['ms_per_call']:.3f} ms a UNet call)"
        + f"; whole run {time.perf_counter() - T_START:.1f} s")

    def entry(name, source, replaces, paths_, rows, row, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(paths_.values()), "launches_by_path": paths_,
                "max_abs_err": max(r["err"] for r in rows), "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": library_ms}

    log(json.dumps({"kernels": [
        entry("ln_geglu_ffn", "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
              "worddiffusion_tpu/ops/ffn_pallas.py:48", ffn_paths, ffn_rows + bwd["fwd_rows"],
              main_row, None),
        entry("ln_geglu_ffn_bwd", "worddiffusion_tpu_torch/csrc/ln_geglu_ffn_bwd.cu",
              "worddiffusion_tpu/ops/ffn_pallas.py:397", bwd_paths, bwd["rows"], bwd_row, None),
        entry("attention", "worddiffusion_tpu_torch/csrc/attention.cu",
              "bench_kernels/attention_pallas.py:25", attn_paths, attn["rows"], attn_row,
              attn_row["library_ms"]),
        entry("fold_attention", "worddiffusion_tpu_torch/csrc/fold_attention.cu",
              "bench_kernels/attn_fold_sublayer_pallas.py:100", fold_paths, fold["rows"],
              fold_row, None),
        # B.7: the same kernel through B.7's [B, C, H*L] folds; no path of the
        # port (or of the JAX package) calls that entry, as each path's count shows
        entry("fold_attention_flat", "worddiffusion_tpu_torch/csrc/fold_attention.cu",
              "bench_kernels/attn_fold_pallas.py:36", fold7_paths, fold["rows"],
              dict(fold_row, ms=fold_row["ms7"]), None),
        entry("groupnorm", "worddiffusion_tpu_torch/csrc/groupnorm.cu",
              "bench_kernels/groupnorm_pallas.py:26", gn_paths, norms["gn_rows"], gn_row,
              gn_row["library_ms"]),
        entry("gn_silu_conv3x3", "worddiffusion_tpu_torch/csrc/gn_silu_conv3x3.cu",
              "bench_kernels/resblock_pallas.py:39", conv_paths, norms["conv_rows"], conv_row,
              conv_row["library_ms"]),
        # B.2: no path of the port (or of the JAX package) calls it; each
        # path's run read its count and asserted 0
        entry("geglu_ffn", "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
              "worddiffusion_tpu/ops/ffn_pallas.py:41", geglu_paths,
              geglu["rows"], geglu["rows"][0], None),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
