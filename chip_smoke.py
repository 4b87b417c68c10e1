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
   B.1 above the presets' width (FFN_WIDE_SHAPES: d = 640 at M = 16*64 and
   128*64, channel_mult (1, 2)'s middle block, and d = 768 at M = 4096, the
   widest the kernel takes; inner = 4d; each with its plan); then
   the bare GEGLU FFN (B.2, ``ops.ffn.fused_geglu_ffn``, the same kernel
   without LayerNorm and residual; the tensor-parallel FF's local FFN) at
   its tensor-parallel caller's M = 128*256 and 128*64 with the local inner
   widths 640 and 320 (a model axis of 2 and 4) and at the preview's 3*256
   and 3*64 with 640, then at M = 16*256, 128*256 and a
   ragged 1000 at the full 1280, and at d = 640 (M = 128*64, inner 2560):
   against its plain version, bitwise
   repeatability, its cluster size, kernel / plain / bound times, and its
   Function's output and five gradients against plain autograd at
   M = 128*256.
4. whole UNet: one full-width ``iam`` UNet call with every kernel against
   the all-plain UNet (``use_pallas_ffn=False``, the plain attention and
   the plain GroupNorm / GN -> SiLU -> conv swapped in) on the same weights
   and inputs; launches per call (4 FF, 8 attention, 9 B.5, 12 B.6); call
   times and profiled device busy time with all kernels, with plain B.5
   and B.6, and all plain; the profiled kernels per call by name (one B.5
   kernel, one B.1 kernel and one B.6 kernel per site: the conv sites take
   their GroupNorm statistics in the kernel) and in all (UNET_KERNELS).
5. main path: the regeneration CLI's pipeline (Regenerator + WordSampler,
   ``iam`` UNet, default VAE and CTC recognizer, seeded random weights)
   over 24 words in batches of 16 (a full one and a ragged one), with the
   600-step skip-step schedule and the deterministic update; checks shapes,
   finiteness, the PNGs and that every FF sub-layer, attention and
   GroupNorm went through its kernel (per batch also the VAE decode's 4 B.5
   + 26 B.6 and the OCR's 10 B.5); then one batch with the attention kernel
   and one with the plain attention, for s/batch with and without it.
6. FFN forward + backward, kernel against plain: the forward and the
   backward kernel (B.3: rows, weight gradients and partial sums, on
   ``wgmma`` fed by TMA; its plan printed) against their plain versions at the
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
   ``iam_phosc``), a ragged case and a 2048-key context, and the
   tensor-parallel path's local heads (2 at training B=128 and at the
   preview's B=3, 1 at B=128; Nq 256 and 64, Nk 42) and the heads above 128
   (ATTN_WIDE_SHAPES: 4 heads of 160 at B=16 and 128, Nq 64, Nk 42, channel_mult
   (1, 2)'s middle block; one row at D = 256), with errors,
   bitwise repeatability, and kernel / plain / ``scaled_dot_product_attention``
   / bound times and the kernel's share of its bound; the Function's output
   and gradients against plain autograd at B=128, Nq=256, Nk=811. At every
   one of these shapes also B.4's fast mode (``fast=True``,
   ``UNetConfig.fast_softmax=True``): the fast kernel against the plain fast
   version (JAX's ``_attend(fast_softmax=True)`` order) within ATTN_REL_TOL,
   the max and mean relative error of both kernel modes against that plain
   fast version, bitwise repeatability, ms per call of the fast kernel and
   of the plain fast version beside the default kernel's.
9. ``iam_phosc`` regeneration: the regeneration CLI with ``--preset
   iam_phosc`` (self-attention, then cross-attention over the characters
   and the PHOSC tokens), seeded random weights: one UNet call all-kernel
   against all-plain, then the pipeline as in phase 5, 4 FF and 8
   attention launches per call, and single batches in turns as there.
10. ``iam_phosc`` training: the train CLI with ``--preset iam --phosc 1``
   at full width, B=128, on the seeded latent cache: 2 epochs of 5 steps
   with one checkpoint and one DDIM-50 preview at the end; checks the
   loss, that q/k/v and the PHOSC path's encoder were updated, 8
   attention backward calls and 4 FF backward launches per step; s/step.
11. fold attention kernel vs plain: the context-folded attention sub-layer
   (``ops.fold_attention``) in both entry layouts (B.7's folds [B, C, H*L],
   B.8's per-head [B, H, C, L], as ``build_folds`` lays them out, with the
   L stride padded to 8, and contiguous) against its plain version at the
   fold path's shapes (C=320, H=4, L=42; B 16 and 128; N 256 and 64) and a
   ragged one, bitwise repeatability and the layouts bitwise equal, its
   route at each shape (the persistent CTAs launched, no cluster; how wt
   reaches shared memory), and the
   Function's gradients against plain autograd; kernel, plain and bound
   times.
12. fold regeneration: the regeneration CLI with ``--preset iam_fold``
   (``iam`` with ``attn_fold_context``, registered in the port's presets):
   one UNet call with the fold kernel against the plain fold, and against
   the unfolded ``iam`` UNet on the same weights; then the pipeline as in
   phase 5 with 8 fold, 0 attention and 4 FF launches per call; single
   batches with the fold kernel and the plain fold in turns.
13. fold training: the train CLI with ``--preset iam_fold`` at B=128 on
   the phase-7 latent corpus, 2 epochs of 5 steps, twice: 8 fold
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
   cuDNN ``F.conv2d``) / bound times, B.6's plan (tile, ring stages, CTAs,
   the cluster that takes the statistics) and its share of its bound,
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
   UNet, B=16, over a 120-step linear schedule (119 calls).
23. pixel space (``--latent 0``, the ``iam`` UNet at full width on 64x256x3
   images): (a) B.5 at its 5 site shapes ([16, 64, 256, 640] down to [16,
   32, 128, 320]; the route printed), B.6 at [16, 64, 256, 320] and [16, 32,
   128, 320], B.4 at Nq 16384 and 4096 over the 42-token context and at
   iam_phosc's self-attention (Nq = Nk = 16384; its plain version in query
   chunks of SELF_ATTN_CHUNK), B.1 and B.3 at M = 16 * 16384 and 16 * 4096,
   each against its plain version, beside its bound and its library call;
   B.4's fast mode at the two cross-attention shapes, as in phase 8 (not at
   the self-attention, whose plain version alone takes 364 ms);
   (b) one UNet call all-kernel vs all-plain (4 / 8 / 9 / 12 launches, by
   profiled name); (c) the regeneration CLI with ``--latent 0`` over one batch
   of 16 words (no VAE: the OCR's launches only per batch), peak memory; (d) the train CLI with
   ``--latent 0`` at the largest B of PIXEL_TRAIN_BS that fits (2 epochs of
   2 steps on seeded 64x256 PNGs, a DDIM-10 preview; launches and Function
   backwards a step; a max_steps stop and a bitwise resume; s/step, peak);
   (e) the sampling CLI with ``--latent 0`` on its EMA weights (DDIM-10,
   6 words, no decoder).
24. the HiGAN+ denoiser (``--hiGanArch 1``) at ``iam`` width: a call at B=16
   in latent and in pixel space all-kernel vs plain B.5 (13 B.5 launches, no
   other kernel); the train CLI on the latent cache (B=128, 2 epochs of 3
   steps; 13 B.5 and 13 GroupNormFn backwards a step; a bitwise resume), the
   regeneration CLI (one batch of 16, 120 calls) and the sampling CLI
   (DDIM-50) on its EMA weights.
25. data parallel: the train CLI with ``--mesh_data 1`` in a process started
   with torchrun's environment (world size 1, NCCL): the model under
   ``DistributedDataParallel``, launches and Function backwards a step under
   its hooks, a bitwise resume, and its parameters bitwise those of the same
   run without a process group. It runs last, beside phase 28's ranks,
   while this process runs the one-process run both are held against and
   then phase 32 (their s/step are taken with all of it on the card).
26. ``return_attn``: the maps kernel (``attention_probs_kernel`` beside B.4,
   from B.4's log-sum-exp) against the plain softmax at ``iam``'s shapes in
   latent and pixel space, beside its bound; one ``return_attn`` UNet call in
   each space: 8 maps from the kernel (8 B.4 and 8 maps launches) against
   the plain maps of the same q and k.
27. host data on this machine's CPU: each augmentation op's and
   ``resize_dataset``'s ms per 64x256 image, the PNG reader's; whether
   ``torchvision.io`` (a JPEG decoder) is present.
28. tensor parallel: ``torchrun --nproc_per_node 2`` of this script
   (``--tp-worker``) on the one card with ``WD_TORCH_SHARE_CARD=1`` (gloo on
   CUDA tensors), each rank the train CLI at ``--preset iam --mesh_data 1
   --mesh_model 2``, B=128 on phase 25's short corpus: 2 epochs of 3 steps
   and a DDIM-2 preview, per rank 4 B.2 (inner 640) and 8 B.4 (2 heads)
   launches a step and a preview call, no B.1 or B.3, B.5 / B.6 and the
   Function backwards as one process; every replicated parameter (and the
   EMA's) bitwise equal across the ranks; a max_steps stop after 3 steps
   and a bitwise resume; 3 profiled steps (4 ``ffn_kernel``, 8
   ``attention_kernel``, no B.3 kernel by name); ``iam_fold`` for an epoch
   (8 B.8 launches a step on the gathered projections); then the same
   ``iam`` run in this process: the gathered parameters against it, each
   tensor on its own (TP_KEY_REL; TP_ZERO_GRAD_DIFF for the tensors whose
   gradient is 0 in exact arithmetic) and every entry (TP_P99_DIFF), and its
   s/step. Every B.2 and B.4 shape a rank launched must be one that phases
   3 and 8 held against plain. Any rank's failure fails the phase. It runs
   beside phase 25 (see there).
29. checkpoints without the JAX package, and JPEG crops: (a) seeded
   full-width ``iam`` weights written in the reference layout
   (``middle_block1``, the research UNetModel's dead ``to_kv`` / ``attnc`` /
   ``norm1`` tensors, a ``{"state_dict": ...}`` wrapper) and in the port's
   keys, 16 words regenerated through the regeneration CLI's
   ``--torch_ckpt`` from each: every PNG and the UNet's eps on a fixed input
   bitwise equal, 4 B.1, 8 B.4, 9 B.5 and 12 B.6 launches a UNet call,
   s/batch of both in turns; (b) ``--ckpt_dir`` on phase 7's checkpoint
   directory with ``--use_ema 0``: the trained weights bitwise, one batch,
   its launches; (c) ``cli.export_reference --middle_block1 1`` of it,
   reloaded bitwise; (d) ``data/jpeg_check.npz`` decoded bitwise (no
   Pillow here), the JPEG decoder's and the PNG reader's host ms per 64x256
   crop; (e) ``cli.evaluate`` with ``--ocr_ckpt`` (phase 22(e)'s directory)
   over a directory of 256 JPEG crops (32 renders by the check set's numpy
   encoder, each under 8 names), then the same crops as PNGs: the
   JSON keys, B.5 launches (48 a style-encoder batch, 10 an OCR batch),
   images/s of the whole call and the loading's ms per image apart.
30. the JAX package's orbax checkpoints, read without JAX, orbax or
   zstandard (``train/orbax_check.npz``): (a) its four sets (a narrow random
   TrainState, the full-width ``iam`` TrainState, the VAE and the OCR as
   their JAX trainers write them) decoded bitwise, the zstd decoder's MB/s
   on random (Huffman-coded) and tiled (match) chunks, the whole ``iam``
   TrainState's read time; (b) ``cli.regenerate --ckpt_dir --vae_ckpt
   --ocr_ckpt`` on the orbax directories, 16 words, against the same
   weights in the port's keys: every PNG and eps on a fixed input bitwise,
   4 / 8 / 9 / 12 B.1 / B.4 / B.5 / B.6 launches a UNet call, s/batch in
   turns; (c) ``cli.export_reference`` of the orbax directory, reloaded
   bitwise; (d) ``cli.train --loadPrev 1`` resuming the ``iam`` TrainState
   (step 8) for 2 steps on phase 7's corpus: restored step, parameters and
   moments, 4 B.1 and 4 B.3 launches a step.
34. (after phase 12) channel_mult (1, 2): the regeneration CLI with
   ``--preset iam_wide`` (``iam`` with ``channel_mult=(1, 2)``, registered
   here): one UNet call at B=16 all-kernel against all-plain within
   UNET_REL_TOL (4 B.1, 8 B.4, 10 B.5, 11 B.6 a call, by profiled name too,
   B.6's statistics in the kernel at the 640-wide 4 x 16 sites), the kernels
   by width in a profile (3 B.1 at d = 320 and 1 at 640, 6 B.4 at D = 80 and
   2 at 160), no plain FF sub-layer (``ops.ffn.plain_calls``) and the device's
   idle share; then one batch of 16 through the pipeline (120 calls, decode,
   OCR, PNGs). The kernels line counts it as ``regenerate_iam_wide``.
35. (after phase 34) channel_mult (1, 2) training and the fold at C = 640:
   B.3 against its plain version at every width it takes (d = 64k from 64 to
   768, M = 1024: the fused route up to 320, the split one above) and at the
   (1, 2) training sites (d = 320 at M = 128*256, 640 at 128*64), each with
   its plan, bitwise repeatability and kernel / plain / bound times; the fold
   at C = 640 (4 heads, L = 42; B = 16 and 128 at N = 64) in both layouts;
   (a) the train CLI's Trainer on ``--preset iam_wide`` at B=128 for 3 steps
   (a max_steps stop and a checkpoint; 4 B.1 and 4 B.3 launches a step, no
   plain FF sub-layer), one step profiled by kernel name and width (B.1 3 at
   d = 320 and 1 at 640; B.3's fused kernels 3 at 320 and its split ones 1 at
   640; B.4 6 at D = 80 and 2 at 160) with the device's idle share, one step
   against the all-plain step on the same weights and draws (loss and every
   gradient within WIDE_LOSS_TOL / WIDE_GRAD_TOL) and repeated bitwise; (b)
   ``--preset iam_wide_fold`` (``iam_wide`` with ``attn_fold_context``): one
   UNet call against all-plain with 8 fold launches (6 of the narrow kernel
   at C = 320 and 2 of the wide one at 640, by profiled name), one
   regeneration batch of 16 through the CLI, then 2 training steps (8 fold
   launches and 8 plain-recompute fold backwards a step). The kernels line counts them as ``train_iam_wide``,
   ``regenerate_iam_wide_fold`` and ``train_iam_wide_fold``.
31. the UNet's last two switches, set through ``UNetConfig`` as in JAX:
   (b) ``fast_softmax=True`` (``--preset iam_fast``, registered here): one
   full-width ``iam`` UNet call at B=16 with 8 B.4 launches, all in the fast
   mode, against phase 4's default-mode eps on the same weights and inputs
   (they must differ) and, through ``unet_check``, against its all-plain
   fast version (4 / 8 / 9 / 12 launches, by profiled name); the regeneration
   pipeline over one batch of 16 words (960 B.4 launches, all fast); one
   Trainer step at B=128 (4 B.1, 4 B.3, 8 fast B.4 and 8 Function backwards
   through the plain fast recompute); (c) ``remat=True``: latent ``iam``
   training at B=128 and pixel training (phase 23's batch) for 2 steps each,
   against the same 2 steps without it, from the same seed with every layer
   random: parameters and loss bitwise equal, B.1 and B.4 forward launches
   doubled (8 and 16 a step: the backward recomputes each block), B.3, B.5,
   B.6 and the Function backwards unchanged, peak memory lower; s/step and
   peak memory of both. The kernels line counts these paths' launches, B.4's
   fast mode apart (``attention_fast``).
32. (run while phases 25 and 28's processes run) the iam chain (``python -m
   worddiffusion_tpu_torch.chains iam --smoke --device cuda``, the JAX
   repo's ``scripts/iam_chain.sh``) from an empty
   runs directory at full width (the ``iam`` preset, the SD-shape VAE, the
   CTC OCR, the VGG PHOSC trunk; epochs and corpus sizes cut by
   ``chains.run.SMOKE``): every stage runs; its artifacts are there (the
   OCR, VAE and UNet checkpoints, the 128-entry latent cache, three
   regeneration dumps, the ddim dump's 128 crops accepted or rejected, the
   five subsets, the PHOSC pickle, five ``evaluate`` JSONs); B.1, B.3, B.4,
   B.5 and B.6 each launched; each stage's seconds, peak memory and
   launches; then a second run skips every stage and launches nothing. The
   untrained smoke filter accepts none of the 128 crops, so its subsets are
   empty and the JSONs hold no FID: a third run stands in for a trained
   filter (every other rejected crop, in name order, moved to the accepted
   dump; the markers of ``subsets`` and the five ``eval_*`` stages deleted)
   and reruns those six stages alone, which must fill every subset and give
   each JSON a finite ``fid_phosc``.
33. (after phase 22) the host C pass and the JAX repo's two program
   descriptions, as the port's own: (a) ``data.native``'s library built
   here (``g++ -O3 -march=native -fopenmp``, under ``build/wd_torch_host/``)
   and loaded after torch, one OpenMP runtime mapped (``/proc/self/maps``);
   ``batch_normalize`` and ``vertical_lines`` bitwise their numpy bodies,
   ``batch_denormalize`` bitwise ``floor(clip(v) * 255 + 0.5)`` in float32
   (128 of the 255 ties a level above the numpy body's half to even),
   ``batch_resize_pad_normalize`` within the JAX package's bounds of the
   PIL-exact numpy path (max < 1.0, mean < 0.03); ms per batch of 128
   64x256x3 crops, library against numpy, for the four calls, beside the
   CPUs this process may run on and the OpenMP thread count; (b)
   ``scripts.profile_denoiser`` on 10 chained ``iam`` calls at B=128: ms a
   call, the device time by bucket (summing to the device total within
   1%), 4 / 8 / 9 / 12 B.1 / B.4 / B.5 / B.6 launches a call; (c)
   ``scripts.roofline_dump``: the call's and the train step's ``model`` and
   ``as_run`` counts finite, ``as_run``'s kernel-site bytes equal to the
   sum of each logged site's bound bytes (its operands and output from
   their shapes), (b)'s ms a call as a share of each bound.

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
import functools
import gc
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

T_START = time.perf_counter()
D, INNER, B = 320, 1280, 16
FFN_SHAPES = (B * 256, B * 64, 1000)   # M: full-res blocks, middle block, ragged
FFN_SMALL_SHAPES = (64, 65)            # one row tile, and one row past it
TRAIN_B = 128
BWD_SHAPES = (TRAIN_B * 256, TRAIN_B * 64, 1000)
# (M, d) of B.1 at the widths above 320: channel_mult (1, 2)'s middle block
# (d = 640, 4 heads of 160) at B = 16 and 128, and the widest d the kernel
# takes (JAX's fits_vmem(d, 4d) holds up to 768); inner = 4d
FFN_WIDE_SHAPES = ((B * 64, 640), (TRAIN_B * 64, 640), (4096, 768))
TRAIN_STEPS_PER_EPOCH = 5  # phases 7, 10 and 13: 2 epochs of 5 steps
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
PREVIEW_N = 3  # the training preview's probe words (``WordSampler.sample_preview``)
# (B, H, Nq, Nk) of the attentions on a model rank of the tensor-parallel
# path: iam training and its preview at 2 local heads (a model axis of 2),
# and training at 1 (an axis of 4)
TP_ATTN_SHAPES = (
    (TRAIN_B, HEADS // 2, 256, 42), (TRAIN_B, HEADS // 2, 64, 42),
    (PREVIEW_N, HEADS // 2, 256, 42), (PREVIEW_N, HEADS // 2, 64, 42),
    (TRAIN_B, HEADS // 4, 256, 42), (TRAIN_B, HEADS // 4, 64, 42),
)
# bf16 output: the kernel and the plain version differ in the order of the
# fp32 sums, which can move one bf16 rounding of p or of the output (0.4%
# of a value); bound at 1% of max |plain|.
ATTN_REL_TOL = 1e-2
# (B, Nq, Nk, D) of B.4 at head widths above 128: channel_mult (1, 2)'s middle
# block (4 heads of 160 over 64 tokens, the 42 characters) at B = 16 and 128,
# and the widest head the kernel takes
ATTN_WIDE_SHAPES = ((B, 64, 42, 160), (TRAIN_B, 64, 42, 160), (B, 64, 42, 256))
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
MASKED_STEPS = 120  # phase 22(i)'s schedule: the preset's 600 steps cut in depth
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
UNET_KERNELS = 398
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


# The SFU's exp2 rate on Hopper: 16 a clock an SM, at the card's maximum SM
# clock as nvidia-smi reads it. B.4's third floor: one exponential a score.
SFU_EXP_PER_CLOCK = 16


@functools.cache
def exp_per_s() -> float:
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return SFU_EXP_PER_CLOCK * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def attn_floors(q, k, v, out) -> dict:
    """B.4's three floors in ms (bytes: q, k, v read and out written once;
    tensor: the two products in bf16; exp: one exponential a score on the
    SFU) and the largest of them."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    f = dict(bytes_ms=nbytes(q, k, v, out) / HBM_BYTES_PER_S * 1e3,
             tensor_ms=4 * b * h * nq * nk * d / BF16_FLOP_PER_S * 1e3,
             exp_ms=b * h * nq * nk / exp_per_s() * 1e3)
    f["largest_ms"] = max(f.values())
    return f


def attn_plan_text(b: int, h: int, nq: int, nk: int, d: int = D_HEAD) -> str:
    from worddiffusion_tpu_torch.ops import attention

    p = attention.plan(b * h, nq, nk, d)
    return (f"{p['rows']}-query tile, {p['keys']}-key chunks, {p['ctas']} CTAs, {p['q_slots']} q "
            f"slots, {p['kv_stages']} k/v stages")


def floors_text(f: dict, ms: float) -> str:
    return (f"floors bytes {f['bytes_ms']:.4f} tensor {f['tensor_ms']:.4f} exp {f['exp_ms']:.4f} ms, "
            f"kernel at {f['largest_ms'] / ms:.1%} of the largest")


def bwd_plan_text(m: int, d: int = D) -> str:
    """B.3's launch plan at M rows and width d (inner = 4d), as a log fragment."""
    from worddiffusion_tpu_torch.ops import ffn

    p = ffn.bwd_plan(m, d, 4 * d)
    split = f", dxn {p['dxn_ctas']} CTAs" if p["route"] == "split" else ""
    return (f"{p['route']} route; rows: {p['rows_tile']}-row tiles, {p['rows_stages']} ring "
            f"stages, {p['rows_ctas']} CTAs, clusters of {p['rows_cluster']} a tile{split}; "
            f"weights: {p['weights_ctas']} CTAs in clusters of {p['weights_cluster']}, "
            f"{p['weights_stages']} ring stages, {p['weights_tile_n']}-column tiles")


def conv_plan_text(b: int, h: int, w: int, c: int, groups: int) -> str:
    """B.6's launch plan at this shape, as a log fragment."""
    from worddiffusion_tpu_torch.ops import gn_conv

    p = gn_conv.plan(b, h, w, c, groups)
    stats = (f"statistics in the kernel, clusters of {p['cluster']}" if p["cluster"]
             else "statistics by B.5's launch first")
    return (f"{p['pixels']} pixels x {p['channels']} channels a CTA"
            f"{', K split across the warpgroups' if p['k_split'] else ''}, {p['ctas']} CTAs, "
            f"{p['stages']} ring stages, {stats}")


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
    attention.launches = attention.bwd_calls = attention.probs_launches = 0
    attention.fast_launches = 0
    fold_attention.launches = fold_attention.bwd_calls = fold_attention.flat_launches = 0
    groupnorm.launches = groupnorm.bwd_calls = gn_conv.launches = gn_conv.bwd_calls = 0
    gn_conv.stats_launches = 0


def card_generator(seed: int):
    """A seeded generator on the card: the kernels' inputs are drawn there
    (drawing the widest on the host took seconds of the run)."""
    import torch

    return torch.Generator(device="cuda").manual_seed(seed)


def attn_inputs(b: int, nq: int, nk: int, seed: int, heads: int = HEADS, d: int = D_HEAD):
    """Seeded bf16 q, k, v [b, heads, n, d] with unit-scale entries, as the
    projections of LayerNormed tokens give them."""
    import torch

    g = card_generator(seed)
    return tuple(torch.randn(b, heads, n, d, generator=g, device="cuda").bfloat16()
                 for n in (nq, nk, nk))


def phase8_attention(smi: str) -> dict:
    """The attention kernel against its plain version at every path's
    shapes (the tensor-parallel path's local heads too), and the Function
    against plain autograd."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import attention

    rows, fast_rows = [], []
    shapes = ([(b, HEADS, nq, nk, D_HEAD) for b, nq, nk in ATTN_SHAPES]
              + [(b, h, nq, nk, D_HEAD) for b, h, nq, nk in TP_ATTN_SHAPES]
              + [(b, HEADS, nq, nk, d) for b, nq, nk, d in ATTN_WIDE_SHAPES])
    for i, (b, h, nq, nk, dh) in enumerate(shapes):
        scale = dh ** -0.5
        q, k, v = attn_inputs(b, nq, nk, seed=30 + i, heads=h, d=dh)
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
        bound_ms, bound_by = bound(nbytes(q, k, v, got), 4 * b * h * nq * nk * dh)
        floors = attn_floors(q, k, v, got)
        log(f"attention B={b} H={h} Nq={nq} Nk={nk} D={dh} ({attn_plan_text(b, h, nq, nk, dh)}): "
            f"max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {ATTN_REL_TOL}); bitwise "
            f"repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"scaled_dot_product_attention {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {bound_ms / ms:.1%} of the bound; {floors_text(floors, ms)} "
            f"[{smi}]")
        at = (b, h, nq, nk, dh)
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite attention at {at}"
        assert torch.equal(got, again), f"attention differs between two runs at {at}"
        assert rel <= ATTN_REL_TOL, f"attention kernel disagrees at {at}: rel {rel}"
        rows.append(dict(b=b, h=h, nq=nq, nk=nk, d=dh, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, **floors))
        fast_rows.append(fast_attention_row(smi, "attention", q, k, v, rows[-1], got))

    # The Function (kernel forward, plain-recompute backward) against plain
    # autograd at the widest training shape: output and q, k, v gradients.
    b, nq, nk = TRAIN_B, 256, 811
    scale = D_HEAD ** -0.5
    q, k, v = attn_inputs(b, nq, nk, seed=60)
    dout = (0.1 * torch.randn(b, HEADS, nq, D_HEAD, generator=card_generator(61),
                              device="cuda")).bfloat16()

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
    return dict(rows=rows, fast_rows=fast_rows, pair_ms=pair_ms, plain_pair_ms=plain_pair_ms)


def fast_attention_row(smi: str, label: str, q, k, v, row: dict, default_out) -> dict:
    """B.4's fast mode (``UNetConfig.fast_softmax=True``) at ``row``'s shape
    against the plain fast version (JAX's ``_attend(fast_softmax=True)``
    order), and the default mode's output ``default_out`` against the same:
    each mode's max and mean |kernel - plain fast| over max |plain fast|;
    ms per call of the fast mode (the default mode's is ``row['ms']``) and
    of the plain fast version. The library call is ``row``'s SDPA (it has
    no fast order); the bound is the default mode's (the same bytes and
    products)."""
    import torch

    from worddiffusion_tpu_torch.ops import attention

    scale = q.shape[-1] ** -0.5
    got, again = (attention.fused_attention(q, k, v, scale, True) for _ in range(2))
    torch.cuda.synchronize()
    want = attention.attention_reference(q, k, v, scale, True).float()
    top = want.abs().max().item()
    rel = {}
    for mode, out in (("fast", got), ("default", default_out)):
        d = (out.float() - want).abs()
        rel[mode] = (d.max().item() / top, d.mean().item() / top)
    err = (got.float() - want).abs().max().item()
    ms = launch_ms(lambda: attention.fused_attention(q, k, v, scale, True))
    plain_ms = launch_ms(lambda: attention.attention_reference(q, k, v, scale, True))
    at = (q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    log(f"{label} fast mode B={at[0]} H={at[1]} Nq={at[2]} Nk={at[3]}: against the plain fast "
        f"version, fast kernel max_rel_err {rel['fast'][0]:.6g} mean_rel_err {rel['fast'][1]:.6g} "
        f"(tol {ATTN_REL_TOL}), default kernel max_rel_err {rel['default'][0]:.6g} mean_rel_err "
        f"{rel['default'][1]:.6g}; bitwise repeatable {torch.equal(got, again)}; fast kernel "
        f"{ms:.4f} ms, default kernel {row['ms']:.4f} ms, plain fast {plain_ms:.4f} ms [{smi}]")
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all()), f"non-finite fast attention at {at}"
    assert torch.equal(got, again), f"fast attention differs between two runs at {at}"
    assert rel["fast"][0] <= ATTN_REL_TOL, f"fast attention kernel disagrees at {at}: {rel}"
    return dict(b=at[0], h=at[1], nq=at[2], nk=at[3], err=err, rel=rel["fast"][0],
                mean_rel=rel["fast"][1], default_rel=rel["default"][0],
                default_mean_rel=rel["default"][1], ms=ms, default_ms=row["ms"],
                plain_ms=plain_ms, library_ms=row["library_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"])


def ffn_inputs(m: int, seed: int, inner: int = INNER, d: int = D):
    """Seeded inputs scaled like the model's: a unit-scale residual stream,
    LayerNorm affine near identity, lecun-scaled weights."""
    import torch

    g = card_generator(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return dict(
        x=r(m, d).bfloat16(), gamma=1 + 0.1 * r(d), beta=0.1 * r(d),
        w1=(r(d, 2 * inner) / d ** 0.5).bfloat16(), b1=0.02 * r(2 * inner),
        w2=(r(inner, d) / inner ** 0.5).bfloat16(), b2=0.02 * r(d),
    )


def bwd_inputs(m: int, seed: int):
    """Kernel-layout inputs of the backward (bf16 x, dy and weights)."""
    import torch

    t = ffn_inputs(m, seed)
    t.pop("b2")
    g = card_generator(seed + 100)
    t["dy"] = (0.1 * torch.randn(m, D, generator=g, device="cuda")).bfloat16()
    return {k: t[k] for k in ("x", "dy", "gamma", "beta", "w1", "b1", "w2")}


# (M, inner) of B.2: its tensor-parallel caller's local widths (a model axis
# of 2 and of 4 cut 1280 to 640 and 320) at the training M of the
# full-resolution and middle blocks and (axis 2) at the preview's, then B.1's
# sites at the full width
GEGLU_SHAPES = ((TRAIN_B * 256, INNER // 2), (TRAIN_B * 256, INNER // 4),
                (TRAIN_B * 64, INNER // 2), (TRAIN_B * 64, INNER // 4),
                (PREVIEW_N * 256, INNER // 2), (PREVIEW_N * 64, INNER // 2),
                (B * 256, INNER), (TRAIN_B * 256, INNER), (1000, INNER))
# (M, d) of B.2 at channel_mult (1, 2)'s middle-block width, inner = 4d
GEGLU_WIDE_SHAPES = ((TRAIN_B * 64, 640),)


def phase3_geglu(smi: str) -> dict:
    """B.2, the bare GEGLU FFN launch mode, against its plain version at
    the tensor-parallel FF's local widths and at B.1's shapes, bitwise
    repeatability, and its Function (kernel forward, autograd of the
    unfused composition backward, as JAX's custom_vjp) against plain
    autograd of that composition: output and five gradients."""
    import torch

    from worddiffusion_tpu_torch.ops import ffn

    rows = []
    shapes = [(m, inner, D) for m, inner in GEGLU_SHAPES] + [
        (m, 4 * d, d) for m, d in GEGLU_WIDE_SHAPES]
    for i, (m, inner, d) in enumerate(shapes):
        t = ffn_inputs(m, seed=40 + i, inner=inner, d=d)
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
        bound_ms, bound_by = bound(nbytes(*a, got), 6 * m * d * inner)
        log(f"geglu_ffn (B.2) M={m} d={d} inner={inner} (cluster of "
            f"{ffn.cluster_size(m, inner)}): max_abs_err {err:.6g} max_rel_err "
            f"{rel:.6g} (tol {FFN_REL_TOL}); bitwise repeatable {torch.equal(got, again)}; kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of the bound [{smi}]")
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), f"non-finite B.2 output at M={m}"
        assert torch.equal(got, again), f"B.2 differs between two runs at M={m}"
        assert rel <= FFN_REL_TOL, f"B.2 kernel disagrees with plain at M={m}: rel {rel}"
        rows.append(dict(m=m, inner=inner, d=d, err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        del t, a, got, again, want

    m = TRAIN_B * 256
    t = ffn_inputs(m, seed=45)
    dy = (0.1 * torch.randn(m, D, generator=card_generator(46), device="cuda")).bfloat16()
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


def bwd_row(smi: str, a: dict) -> dict:
    """B.3 on kernel-layout inputs ``a`` (x, dy [M, d], JAX-layout weights)
    against its plain version: the seven gradients, each within BWD_REL_TOL
    of its max, bitwise repeatable; its plan; kernel / plain / bound times."""
    import torch

    from worddiffusion_tpu_torch.ops import ffn

    (m, d), inner = a["x"].shape, a["w2"].shape[0]
    n0 = ffn.bwd_launches
    got, again = ffn.ln_geglu_ffn_bwd(**a), ffn.ln_geglu_ffn_bwd(**a)
    torch.cuda.synchronize()
    assert ffn.bwd_launches == n0 + 2, ffn.bwd_launches - n0
    want = ffn.ln_geglu_ffn_bwd_reference(**a)
    errs, shares = [], {}
    for name, g, w, g2 in zip(GRADS, got, want, again):
        assert bool(torch.isfinite(g.float()).all()), f"non-finite {name} at M={m} d={d}"
        assert torch.equal(g, g2), f"{name} differs between two runs at M={m} d={d}"
        errs.append((g.float() - w.float()).abs().max().item())
        shares[name] = round(errs[-1] / w.float().abs().max().item(), 6)
    ms = launch_ms(lambda: ffn.ln_geglu_ffn_bwd(**a))
    plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_bwd_reference(**a))
    # the backward recomputes h = LN(x) W1 and does four more products of
    # the same size: 16 M d inner operations in all
    bound_ms, bound_by = bound(nbytes(*a.values(), *got), 16 * m * d * inner)
    log(f"ffn bwd (B.3) M={m} d={d} inner={inner} ({bwd_plan_text(m, d)}): share of max "
        f"|plain| by gradient {shares} (tol {BWD_REL_TOL}); bitwise repeatable; kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.1%} of the bound [{smi}]")
    assert max(shares.values()) <= BWD_REL_TOL, f"backward kernel disagrees at M={m} d={d}"
    return dict(m=m, d=d, err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, route=ffn.bwd_plan(m, d, inner)["route"])


def ffn_bound(inputs: dict, out) -> tuple[float, str]:
    """The forward's bound: its inputs and output, and the two products
    x W1 [M, d] x [d, 2 inner] and act W2 [M, inner] x [inner, d]."""
    m, d = inputs["x"].shape
    return bound(nbytes(*inputs.values(), out), 6 * m * d * inputs["w2"].shape[0])


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

        rows.append(bwd_row(smi, bwd_inputs(m, seed=10 + i)))

    # The autograd Function (forward + backward kernels) against plain
    # autograd of the plain forward, on fp32 master weights in parameter
    # layout, as the UNet's FF sub-layer calls it; output and gradients.
    order = ("gamma", "beta", "w1", "b1", "w2", "b2")
    for m in BWD_SHAPES[:2]:
        a = ffn_inputs(m, seed=20)
        p = {k: a[k].float() for k in ("gamma", "beta", "b1", "b2")}
        p["w1"] = a["w1"].float().t().contiguous()  # proj.weight [2*inner, d]
        p["w2"] = a["w2"].float().t().contiguous()  # out.weight [d, inner]
        dy = (0.1 * torch.randn(m, D, generator=card_generator(21), device="cuda")).bfloat16()

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
    fold7, probs = fold_attention.flat_launches, attention.probs_launches
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
    assert probs == 0, probs
    return dict(fwd=fwd, bwd=bwd, geglu=geglu, fold_b7=fold7, attn=attn, gn=gn, conv=conv,
                probs=probs, s_per_step=k_s / k_n, peak_bytes=peak,
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
    fold7, probs = fold_attention.flat_launches, attention.probs_launches
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
    assert geglu == 0 and fold7 == 0 and probs == 0, (geglu, fold7, probs)
    return dict(fwd=fwd, bwd=bwd, geglu=geglu, fold_b7=fold7, attn=attn, gn=gn, conv=conv,
                probs=probs, s_per_step=s_ / n_)


def fold_inputs(b: int, n: int, l: int, seed: int, c: int = D) -> dict:
    """Seeded sub-layer inputs scaled like the model's: a unit-scale residual
    stream, LayerNorm affine near identity, folds that give unit-scale
    scores and outputs (B.8's per-head layout), small biases."""
    import torch

    g = card_generator(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return dict(x=r(b, n, c).bfloat16(), wt4=(r(b, HEADS, c, l) / c ** 0.5).bfloat16(),
                vw4=r(b, HEADS, l, c).bfloat16(), gamma=1 + 0.1 * r(c), beta=0.1 * r(c),
                b_out=0.02 * r(c))


def fold_row(smi: str, b: int, n: int, l: int, seed: int, c: int = D) -> dict:
    """The fold at one shape (4 heads) against its plain version through both
    entries: B.8's folds as build_folds lays them out (wt4 the [..., :L] view
    of an L stride rounded up to 8: the kernel's TMA route) and contiguous
    (the producer's copy route at C <= 320, a copy to build_folds' stride
    above), B.7's [B, C, H*L] folds (vw the same memory); bitwise repeatable,
    the layouts bitwise equal; its route; kernel / plain / bound times."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import fold_attention as fa

    t = fold_inputs(b, n, l, seed, c)
    vecs = (t["gamma"], t["beta"], t["b_out"])
    wt4p = F.pad(t["wt4"], (0, -l % 8))[..., :l]
    wt = t["wt4"].permute(0, 2, 1, 3).reshape(b, c, HEADS * l).contiguous()
    vw = t["vw4"].view(b, HEADS * l, c)

    def per_head():
        return fa.fold_attention_heads(t["x"], wt4p, t["vw4"], *vecs)

    def flat():
        return fa.fold_attention(t["x"], wt, vw, *vecs, HEADS)

    def plain():
        return fa.fold_attention_reference(t["x"], t["wt4"], t["vw4"], *vecs)

    n0 = fa.launches
    got, again, got7 = per_head(), per_head(), flat()
    contiguous = fa.fold_attention_heads(t["x"], t["wt4"], t["vw4"], *vecs)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 4, fa.launches - n0
    want = plain()
    err = max((g.float() - want.float()).abs().max().item() for g in (got, got7, contiguous))
    rel = err / want.float().abs().max().item()
    ms, ms7, plain_ms = launch_ms(per_head), launch_ms(flat), launch_ms(plain)
    bound_ms, bound_by = bound(nbytes(*t.values(), got), 4 * b * n * c * HEADS * l)
    wt_routes = {name: fa.wt_route(w) for name, w in (
        ("build_folds", wt4p), ("contiguous", t["wt4"]),
        ("B.7", wt.view(b, c, HEADS, l).transpose(1, 2)))}
    ctas = fa.ctas(b, n, c, l)
    log(f"fold attention B={b} N={n} C={c} H={HEADS} L={l} (route: {ctas} persistent CTAs "
        f"for {b * -(-n // 64)} tiles of 64 rows and {HEADS} heads, cluster 1; wt arrives "
        f"{wt_routes}): max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {FOLD_REL_TOL}); "
        f"bitwise repeatable {torch.equal(got, again)}; B.7 layout == B.8 layout "
        f"{torch.equal(got, got7)}; contiguous == build_folds' {torch.equal(got, contiguous)}; "
        f"kernel {ms:.4f} ms (B.7 layout {ms7:.4f} ms) plain {plain_ms:.4f} ms bound "
        f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the bound [{smi}]")
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all()), f"non-finite fold at {b, n, l, c}"
    assert torch.equal(got, again), f"fold attention differs between two runs at {b, n, l, c}"
    assert torch.equal(got, got7) and torch.equal(got, contiguous), \
        f"the layouts differ at {b, n, l, c}"
    assert wt_routes["build_folds"] == "tma", wt_routes
    assert rel <= FOLD_REL_TOL, f"fold attention kernel disagrees at {b, n, l, c}: rel {rel}"
    return dict(b=b, n=n, l=l, c=c, err=err, ms=ms, ms7=ms7, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, ctas=ctas)


def phase11_fold(smi: str) -> dict:
    """The fold attention kernel against its plain version at the fold
    path's shapes, through both entries (B.8's per-head folds as
    build_folds lays them out, with the L stride padded, and contiguous;
    B.7's [B, C, H*L] folds), its route at each shape, and the Function
    against plain autograd."""
    import torch

    from worddiffusion_tpu_torch.ops import fold_attention as fa

    rows = [fold_row(smi, b, n, l, seed=70 + i) for i, (b, n, l) in enumerate(FOLD_SHAPES)]

    # The Function (kernel forward, plain-recompute backward) against plain
    # autograd at the training shape: the output and the six gradients.
    b, n, l = TRAIN_B, 256, 42
    t = fold_inputs(b, n, l, seed=80)
    dy = (0.1 * torch.randn(b, n, D, generator=card_generator(81), device="cuda")).bfloat16()
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


# Calls a device_profile counts (after one call before its window and one in
# it that may lose its first kernels).
PROFILE_CALLS = 5


def device_profile(fn, calls: int = PROFILE_CALLS) -> dict:
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
    # spin_kernel) parts it from the counted calls. Device activity alone:
    # the host's ops add nothing read here and cost seconds to parse.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # device events, less the annotation ranges of the optimizer step and of
    # gloo's collectives (not kernels: the latter spans its host copies)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Optimizer.", "gloo:"))),
                    key=lambda e: e.time_range.start)
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


def step_profile(smi: str, trainer, label: str, folds: int, ffn_bwd: int = 4) -> dict:
    """Three training steps of ``trainer``'s step function on a fresh state
    and its first batch, profiled: the step's device busy time and kernels,
    and per step 4 FF forward kernels (B.1, or B.2 under a model axis: one
    kernel template), ``ffn_bwd`` of each of B.3's, ``folds`` fold kernels
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
    want = {"ffn_kernel": 4, **{k: ffn_bwd for k in BWD_KERNELS}, "fold_attention_kernel": folds,
            "attention_kernel": 8 - folds}
    assert counts == want, (counts, want)
    return dict(busy_ms=d["busy_ms"], kernels=d["kernels"])


def register_iam_preset(name: str, **unet) -> None:
    """``name``: the ``iam`` preset at full width with the UNet fields
    ``unet`` set, in the port's presets, where the CLIs resolve --preset
    (``iam_fold``: the context-folded attention; ``iam_fast``:
    ``fast_softmax=True``)."""
    from worddiffusion_tpu_torch.configs import presets

    def preset():
        exp = presets.iam()
        return exp.replace(name=name, unet=dataclasses.replace(exp.unet, **unet))

    presets.PRESETS[name] = preset


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


# B.5 and B.6 launches a UNet call at channel_mult (1, 2) (attention at the
# first level only, as iam's): B.5 at the 320 -> 640 ResBlock's in_layers and
# the four decoder concats (1280, 960 at 4 x 16; 960, 640 at 8 x 32), the 4
# transformer norms and the out norm; B.6 at the 8 out_layers and the in_layers
# whose width does not change (the first level's and the middle block's two)
WIDE_NORMS = (10, 11)


def phase34_wide(smi: str, cli, gt: str, work: str, words) -> dict:
    """The regeneration CLI on ``--preset iam_wide`` (``iam`` with
    channel_mult (1, 2): 640 channels at the second level and in the middle
    block, whose transformer runs B.1 at d = 640 and B.4 at 4 heads of 160):
    one UNet call against the all-plain UNet on the same weights, its
    kernels by name and width in a profile (4 B.1, one at d = 640; 8 B.4,
    two at D = 160; no plain FF sub-layer) with the device's idle share, then
    one batch through the pipeline (120 calls, decode, OCR, PNGs)."""
    import torch

    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import ffn

    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_wide"),
                                              "--preset", "iam_wide"))
    sampler = regen.sampler
    cfg = sampler.model.cfg
    assert tuple(cfg.channel_mult) == (1, 2) and cfg.model_channels == 320, cfg
    init_weights_(sampler.model, seed=0, zero_init=False)
    inputs = unet_inputs(sampler, words, phosc=False)
    plain0 = ffn.plain_calls
    unet = unet_check(smi, sampler.model, inputs, "iam_wide", launches=(4, 8, 0, *WIDE_NORMS))
    with torch.no_grad():
        prof = device_profile(lambda: sampler.model(*inputs))
    by_width = {f"{name}<{d},": sum(n for k, n in prof["per_call"].items()
                                    if f"{name}<{d}," in k)
                for name, widths in (("ffn_kernel", (320, 640)), ("attention_kernel", (80, 160)))
                for d in widths}
    idle = 1 - prof["busy_ms"] / unet["ms"]
    log(f"unet B={B} iam_wide, profiled: kernels per call by width {by_width}; plain FF "
        f"sub-layers {ffn.plain_calls - plain0}; device busy {prof['busy_ms']:.4f} ms/call, "
        f"{prof['kernels']:.0f} kernels/call, idle {idle:.1%} of the unprofiled call "
        f"({unet['ms']:.3f} ms); top kernels (ms/call) {prof['top']} [{smi}]")
    assert by_width == {"ffn_kernel<320,": 3, "ffn_kernel<640,": 1, "attention_kernel<80,": 6,
                        "attention_kernel<160,": 2}, by_width
    out = drive_regen(smi, regen, samples[:B], seed=0, label="iam_wide",
                      per_call=(4, 8, 0, *WIDE_NORMS))
    assert ffn.plain_calls == plain0, ffn.plain_calls - plain0
    return dict(out, unet_ms=unet["ms"], busy_ms=prof["busy_ms"], idle=idle, rel=unet["rel"])


# (M, d) of B.3's rows in phase 35: every width the kernels take at M = 1024,
# then channel_mult (1, 2)'s training sites at B = 128 (d = 320 at 256 tokens,
# d = 640 at the middle block's 64); inner = 4d
BWD_WIDE_SHAPES = tuple((1024, d) for d in range(64, 769, 64)) + (
    (TRAIN_B * 256, 320), (TRAIN_B * 64, 640))
# (B, N) of the fold at C = 640 (4 heads over the 42 characters): the (1, 2)
# middle block at the regeneration and training batches
FOLD_WIDE_C, FOLD_WIDE_SHAPES = 640, ((B, 64), (TRAIN_B, 64))
# A (1, 2) training step all-kernel against all-plain on the same weights and
# draws, bf16: each of the 4 FF sub-layers' backward differs by a few bf16
# ulps of each gradient (BWD_REL_TOL bounds one at 2%), the attention and the
# norms by one bf16 rounding, carried back through the bf16 layers before
# them: 5% of each gradient's max, floored at 1% of the largest gradient
# anywhere (a tensor whose gradient is near 0 is held to the step's scale, as
# tests/test_torch_train.py argues); the loss, an fp32 mean over the batch of
# the eps error, 1%.
WIDE_GRAD_TOL, WIDE_GRAD_FLOOR, WIDE_LOSS_TOL = 5e-2, 1e-2, 1e-2
WIDE_TRAIN_STEPS, WIDE_FOLD_STEPS = 3, 2


def bwd_wide_rows(smi: str) -> list:
    """B.3 at every width (M = 1024) and at the (1, 2) training sites against
    its plain version (``bwd_row``), each on the route its width takes."""
    import torch

    rows = []
    for i, (m, d) in enumerate(BWD_WIDE_SHAPES):
        a = ffn_inputs(m, seed=300 + i, inner=4 * d, d=d)
        a["dy"] = (0.1 * torch.randn(m, d, generator=card_generator(400 + i),
                                     device="cuda")).bfloat16()
        rows.append(bwd_row(smi, {k: a[k] for k in ("x", "dy", "gamma", "beta", "w1", "b1",
                                                      "w2")}))
        assert rows[-1]["route"] == ("fused" if d <= 320 else "split"), rows[-1]
        del a
    return rows


def fold_wide_rows(smi: str) -> list:
    """The fold at C = 640 against its plain version in both layouts
    (``fold_row``)."""
    return [fold_row(smi, b, n, 42, seed=500 + i, c=FOLD_WIDE_C)
            for i, (b, n) in enumerate(FOLD_WIDE_SHAPES)]


def by_width(prof: dict, patterns) -> dict:
    """Kernels a call (or step) of a profile whose names hold each pattern."""
    return {p: sum(n for k, n in prof["per_call"].items() if p in k) for p in patterns}


# B.3's kernels by name and width a (1, 2) training step: the fused route at
# d = 320 (3 FF sub-layers), the split route at d = 640 (the middle block)
WIDE_STEP_KERNELS = {
    "ffn_kernel<320,": 3, "ffn_kernel<640,": 1,
    "ffn_bwd_rows_kernel<320>": 3, "ffn_bwd_weights_kernel<320>": 3,
    "ffn_bwd_norm_kernel<640>": 1, "ffn_bwd_gate_kernel<640>": 1, "ffn_bwd_dxn_kernel<640>": 1,
    "ffn_bwd_ln_kernel<640>": 1, "ffn_bwd_weights_kernel<640>": 1, "ffn_bwd_reduce_kernel": 4,
}
# the fold's kernels a call or step at (1, 2): the narrow one at the six
# 320-wide attentions, the wide one (C = 640) at the middle block's two
WIDE_FOLDS = {"fold_attention_kernel<": 6, "fold_attention_wide_kernel<": 2}


def wide_train(smi: str, work: str, corpus, preset: str, steps: int, folds: int) -> dict:
    """The train CLI's Trainer on ``preset`` at B=128 for ``steps`` steps (a
    max_steps stop, one checkpoint), its launches counted from 0 over the
    run; then, on one batch and a fresh state: one step profiled by kernel
    name and width, with the device's idle share."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.data.loader import epoch_batches
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention
    from worddiffusion_tpu_torch.train.step import make_train_step

    gt, cache = corpus
    trainer = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", preset, "--gt_train", gt, "--latent_cache", cache,
        "--batch_size", str(TRAIN_B), "--epochs", "1", "--ckpt_every_epochs", "100",
        "--save_path", os.path.join(work, preset), "--seed", "0", "--device", "cuda"]))
    cfg = trainer.exp.unet
    assert tuple(cfg.channel_mult) == (1, 2) and bool(cfg.attn_fold_context) == bool(folds), cfg
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
    reset_counts()
    plain0 = ffn.plain_calls
    t0 = time.perf_counter()
    state = trainer.run(epochs=1, max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ffn=ffn.launches, ffn_bwd=ffn.bwd_launches, geglu=ffn.geglu_launches,
                  attn=attention.launches, attn_bwd=attention.bwd_calls,
                  fold=fold_attention.launches, fold_b7=fold_attention.flat_launches,
                  fold_bwd=fold_attention.bwd_calls, probs=attention.probs_launches,
                  attn_fast=attention.fast_launches,
                  **dict(zip(("gn", "conv", "gn_bwd", "conv_bwd"), norm_counts())))
    moved = [k for k, v in state.model.state_dict().items()
             if ".ff.net." in k and k.endswith("weight") and not torch.equal(v, initial[k])]
    log(f"train {preset}: {state.step} steps of B={TRAIN_B} in {wall:.2f} s incl. a checkpoint; "
        f"launches {counts}; plain FF sub-layers {ffn.plain_calls - plain0}; FF weights moved "
        f"{len(moved)} [{smi}]")
    gn_u, conv_u = WIDE_NORMS
    want = dict(ffn=4 * steps, ffn_bwd=4 * steps, geglu=0, attn=(8 - folds) * steps,
                attn_bwd=(8 - folds) * steps, fold=folds * steps, fold_b7=0,
                fold_bwd=folds * steps, probs=0, attn_fast=0, gn=gn_u * steps, conv=conv_u * steps,
                gn_bwd=gn_u * steps, conv_bwd=conv_u * steps)
    assert state.step == steps and counts == want, (state.step, counts, want)
    assert ffn.plain_calls == plain0, ffn.plain_calls - plain0
    assert len(moved) == 8 and all(torch.isfinite(p).all() for p in state.model.parameters())

    step_fn = make_train_step(trainer.schedule, trainer.exp, trainer.encode_fn)
    batch = next(iter(epoch_batches(trainer.dataset, TRAIN_B, epoch=0,
                                    seed=trainer.exp.train.seed, map_fn=trainer._device_batch)))
    fresh = trainer.init_state()
    step_ms = cuda_ms(lambda: step_fn(fresh, batch), reps=3, warmup=1)
    prof = device_profile(lambda: step_fn(fresh, batch), calls=3)
    patterns = dict(WIDE_STEP_KERNELS, **(WIDE_FOLDS if folds else
                                          {"attention_kernel<80,": 6, "attention_kernel<160,": 2}))
    got = by_width(prof, patterns)
    idle = 1 - prof["busy_ms"] / step_ms
    log(f"train step {preset} B={TRAIN_B}: {step_ms:.3f} ms a step, profiled device busy "
        f"{prof['busy_ms']:.3f} ms ({prof['kernels']:.0f} kernels), idle {idle:.1%}; kernels a "
        f"step by name and width {got}; top kernels (ms) {prof['top']} [{smi}]")
    assert got == patterns, (got, patterns)
    return dict(counts, trainer=trainer, batch=batch, step_fn=step_fn, step_ms=step_ms,
                busy_ms=prof["busy_ms"], idle=idle)


def wide_step_vs_plain(smi: str, run: dict) -> dict:
    """One (1, 2) training step on a fresh state, all-kernel, against the
    all-plain step (plain FF, attention, B.5, B.6) on the same weights, batch
    and draws: the loss and every gradient; then the all-kernel step twice:
    gradients and updated parameters bitwise equal."""
    import torch

    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
    from worddiffusion_tpu_torch.train.step import make_train_step

    trainer, batch = run["trainer"], run["batch"]
    exp = trainer.exp
    plain_exp = exp.replace(unet=dataclasses.replace(exp.unet, use_pallas_ffn=False))
    # every layer random, the zero-initialised output convs too: with them at
    # zero no gradient reaches the layers below the last conv
    init = init_weights_(trainer.init_state().model, seed=1, zero_init=False).state_dict()

    def step(plain: bool):
        e = plain_exp if plain else exp
        model = UNet(e.unet).cuda()
        model.load_state_dict(init)
        state = TrainState.create(model, make_optimizer(model.parameters(), e.train.lr,
                                                        e.train.weight_decay))
        with all_plain() if plain else contextlib.nullcontext():
            loss = make_train_step(trainer.schedule, e, trainer.encode_fn)(state, batch)["loss"]
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}, \
            {k: p.detach().clone() for k, p in model.named_parameters()}

    (lk, gk, pk), (lp, gp, _), (lk2, gk2, pk2) = step(False), step(True), step(False)
    floor = WIDE_GRAD_FLOOR * max(g.abs().max().item() for g in gp.values())
    shares = {k: (gk[k].float() - w.float()).abs().max().item()
              / max(w.abs().max().item(), floor) for k, w in gp.items()}
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    ff = [k for k in gp if ".ff.net." in k]
    assert len(ff) == 16 and all(gp[k].abs().max() > 0 for k in ff), "no gradient reached the FF"
    loss_rel = abs(lk - lp) / abs(lp)
    bitwise = lk == lk2 and all(torch.equal(gk[k], gk2[k]) and torch.equal(pk[k], pk2[k])
                                for k in gk)
    log(f"train step {exp.name} B={TRAIN_B} all-kernel vs all-plain on the same weights and "
        f"draws: loss {lk:.6g} vs {lp:.6g} (rel {loss_rel:.3g}, tol {WIDE_LOSS_TOL}); gradients' "
        f"largest error as a share of max(|plain|, {WIDE_GRAD_FLOOR} of the largest) "
        f"{worst} (tol {WIDE_GRAD_TOL}); two all-kernel steps bitwise equal {bitwise} [{smi}]")
    assert loss_rel <= WIDE_LOSS_TOL, (lk, lp)
    assert max(shares.values()) <= WIDE_GRAD_TOL, worst
    assert bitwise, "two identical (1, 2) training steps differ"
    return dict(loss_rel=loss_rel, grad_share=worst[0][1])


def phase35_wide_train(smi: str, cli, gt: str, work: str, words, corpus) -> dict:
    """channel_mult (1, 2) training and the fold at C = 640: B.3 at every
    width and the fold at C = 640 against their plain versions; (a) the train
    CLI's Trainer on ``--preset iam_wide`` at B=128 for 3 steps (B.3 at d = 320
    3 a step, at 640 1 a step), a step profiled by kernel and width, one step
    against the all-plain step and bitwise repeated; (b) ``--preset
    iam_wide_fold``: one UNet call against all-plain (8 fold launches, 2 at
    C = 640, by profiled name), one regeneration batch of 16 through the CLI,
    and 2 training steps (the fold's backward the plain recompute)."""
    import torch

    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import ffn

    bwd_rows, fold_rows = bwd_wide_rows(smi), fold_wide_rows(smi)
    wide = wide_train(smi, work, corpus, "iam_wide", WIDE_TRAIN_STEPS, folds=0)
    vs_plain = wide_step_vs_plain(smi, wide)

    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_wide_fold"),
                                              "--preset", "iam_wide_fold"))
    sampler = regen.sampler
    cfg = sampler.model.cfg
    assert tuple(cfg.channel_mult) == (1, 2) and cfg.attn_fold_context, cfg
    init_weights_(sampler.model, seed=0, zero_init=False)
    inputs = unet_inputs(sampler, words, phosc=False)
    plain0 = ffn.plain_calls
    unet = unet_check(smi, sampler.model, inputs, "iam_wide_fold",
                      launches=(4, 0, 8, *WIDE_NORMS))
    with torch.no_grad():
        prof = device_profile(lambda: sampler.model(*inputs))
    folds = by_width(prof, WIDE_FOLDS)
    log(f"unet B={B} iam_wide_fold, profiled: fold kernels per call by width {folds}; device "
        f"busy {prof['busy_ms']:.4f} ms/call, idle {1 - prof['busy_ms'] / unet['ms']:.1%} of "
        f"the unprofiled call ({unet['ms']:.3f} ms) [{smi}]")
    assert folds == WIDE_FOLDS, folds
    out = drive_regen(smi, regen, samples[:B], seed=0, label="iam_wide_fold",
                      per_call=(4, 0, 8, *WIDE_NORMS))
    assert ffn.plain_calls == plain0, ffn.plain_calls - plain0
    del regen, sampler
    wide_fold = wide_train(smi, work, corpus, "iam_wide_fold", WIDE_FOLD_STEPS, folds=8)
    keys = ("ffn", "ffn_bwd", "attn", "fold", "fold_b7", "gn", "conv", "geglu", "probs",
            "attn_fast")
    return dict(bwd_rows=bwd_rows, fold_rows=fold_rows, vs_plain=vs_plain, unet_rel=unet["rel"],
                step_ms=wide["step_ms"], busy_ms=wide["busy_ms"], idle=wide["idle"],
                fold_step_ms=wide_fold["step_ms"], paths={
                    "train_iam_wide": {k: wide[k] for k in keys},
                    "regenerate_iam_wide_fold": dict(
                        {k: out[k] for k in ("ffn", "attn", "fold", "gn", "conv", "geglu",
                                             "fold_b7", "probs")}, ffn_bwd=0, attn_fast=0),
                    "train_iam_wide_fold": {k: wide_fold[k] for k in keys}})


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
                      fold_bwd=fold_attention.bwd_calls, probs=attention.probs_launches,
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
                          conv_bwd=conv_u * steps, probs=0), counts

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

    g = card_generator(seed)
    c = shape[-1]
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return dict(x=(2 * r(*shape) + 0.5).bfloat16(), scale=1 + 0.1 * r(c), bias=0.1 * r(c))


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
        g = card_generator(150 + i)
        wt = torch.randn(c, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5
        cb = 0.1 * torch.randn(c, generator=g, device="cuda")
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
        log(f"gn_silu_conv3x3 B={b} {h}x{w} C={c} G={groups} "
            f"({conv_plan_text(b, h, w, c, groups)}): "
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
    g = card_generator(181)
    t["w"] = torch.randn(D, D, 3, 3, generator=g, device="cuda") / (9 * D) ** 0.5
    t["b"] = 0.1 * torch.randn(D, generator=g, device="cuda")
    dy = (0.1 * torch.randn(TRAIN_B, 8, 32, D, generator=g, device="cuda")).bfloat16()
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
    dy = (0.1 * torch.randn(PHOSC_B, 25, 125, 64, generator=g, device="cuda")).bfloat16()

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
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention

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
    probs = attention.probs_launches
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
    assert geglu == 0 and fold7 == 0 and probs == 0, (geglu, fold7, probs)
    return dict(gn=gn, conv=conv, geglu=geglu, fold_b7=fold7, probs=probs,
                imgs_per_s=N_IMAGES / wall,
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
                  fold_b7=fold_attention.flat_launches, probs=attention.probs_launches,
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
        + conv_p, gn_bwd=gn_u * steps, conv_bwd=conv_u * steps, probs=0), counts

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
                          counts=(4, 8, 0, *VARIANT_NORMS[label]), probs=r["probs"])
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
                      probs=attention.probs_launches,
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

        def recorded(q, k, v, *rest):
            nks.append(k.shape[2])
            return fused(q, k, v, *rest)

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
            conv_bwd=per_call[1] * steps, probs=0), counts
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
                      probs=attention.probs_launches,
                      **dict(zip(("gn", "conv"), norm_counts()[:2])))
        want = dict(ffn=4 * calls, attn=8 * calls, fold=0, geglu=0, fold_b7=0, probs=0,
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
        t1 = time.perf_counter()
        sampler.sample_async(w_, i_, card_generator(0), **cond_kw).cpu()
        secs = [time.perf_counter() - t1]
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
                conv=conv, geglu=ffn.geglu_launches, probs=attention.probs_launches)


def only_groupnorm(gn: int) -> dict:
    """The counts of a path that launches B.5 ``gn`` times and no other kernel."""
    return dict(ffn=0, ffn_bwd=0, attn=0, fold=0, fold_b7=0, gn=gn, conv=0, geglu=0, probs=0)


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
    gen = card_generator(0)
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
    (seeded, B=16) over a linear schedule of MASKED_STEPS steps (the
    preset's 600 cut in depth): MASKED_STEPS - 1 UNet calls, kernels per
    call, time."""
    import torch

    from worddiffusion_tpu_torch.diffusion.masking import masked_ddpm_sample
    from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule

    x, _, ctx, wid, _ = unet_inputs(sampler, words, phosc=False)
    g = card_generator(5)
    ref = torch.randn(x.shape, generator=g, device="cuda") * 0.5 + 0.3
    assert sampler.schedule.num_steps == 600
    schedule = NoiseSchedule.linear(MASKED_STEPS)
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
    assert calls == MASKED_STEPS - 1 and bool(torch.isfinite(out).all())
    assert counts == dict(ffn=4 * calls, ffn_bwd=0, attn=8 * calls, fold=0, fold_b7=0,
                          gn=UNET_NORMS[0] * calls, conv=UNET_NORMS[1] * calls, geglu=0,
                          probs=0), counts
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


HOST_CROPS = TRAIN_B  # phase 33(a)'s batch of 64x256x3 crops


def batch_ms(fn, reps: int = 3) -> float:
    """Host ms of ``fn()``, the best of ``reps``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def phase33a_host_pass(smi: str) -> dict:
    """(a) The host C pass built on this machine: where it lies, one OpenMP
    runtime, each entry point against its numpy body, ms per batch."""
    import ctypes

    import numpy as np

    from worddiffusion_tpu_torch.data import native

    lib = native.build()
    assert "wd_torch_host" in lib.parts and lib.parent.parent == native.BUILD_ROOT, lib
    native.load()
    runtimes = sorted({line.split()[-1] for line in open("/proc/self/maps")
                       if "gomp" in line or "libomp" in line or "iomp" in line})
    threads = ctypes.CDLL("libgomp.so.1").omp_get_max_threads()
    cpus = len(os.sched_getaffinity(0))
    assert len(runtimes) == 1, f"more than one OpenMP runtime mapped: {runtimes}"
    rng = np.random.default_rng(33)
    u8 = rng.integers(0, 256, (HOST_CROPS, PIX_H, PIX_W, 3), np.uint8)
    crops = list(u8)
    # the resize's bounds (C's bilinear against PIL's filter) are the JAX
    # package's, on its own test crops (tests/test_native.py: seed 1, 48 rows,
    # widths 100, 260, 80); 16 more ragged crops are printed beside them
    jrng = np.random.default_rng(1)
    ragged = [jrng.integers(0, 256, (48, w, 3), np.uint8) for w in (100, 260, 80)]
    ragged += [rng.integers(0, 256, (48, int(w), 3), np.uint8) for w in rng.integers(60, 300, 16)]
    f = np.clip(rng.normal(0.9, 0.2, u8.shape), -0.1, 1.1).astype(np.float32)
    ties = ((np.arange(255) + 0.5) / 255).astype(np.float32)
    f.reshape(-1)[:255] = ties
    xs = [rng.integers(-20, PIX_W + 20, 15) for _ in range(HOST_CROPS)]
    calls = {
        "batch_resize_pad_normalize": lambda: native.batch_resize_pad_normalize(crops, PIX_H,
                                                                                PIX_W),
        "batch_normalize": lambda: native.batch_normalize(u8),
        "batch_denormalize": lambda: native.batch_denormalize(f),
        "vertical_lines": lambda: [native.vertical_lines(u8[i].copy(), xs[i], 255)
                                   for i in range(HOST_CROPS)],
    }
    got = {k: fn() for k, fn in calls.items()}
    host_ms = {k: dict(library=batch_ms(fn)) for k, fn in calls.items()}
    with mock.patch.dict(os.environ, {"WD_NATIVE": "0"}):
        assert not native.preferred()
        want = {k: fn() for k, fn in calls.items()}
        for k, fn in calls.items():
            host_ms[k]["numpy"] = batch_ms(fn, reps=1 if k.startswith("batch_resize") else 3)
        numpy_ties = native.batch_denormalize(ties)
        ragged_numpy = native.batch_resize_pad_normalize(ragged, PIX_H, PIX_W)
    half_up = np.floor(np.clip(f, 0, 1) * np.float32(255) + np.float32(0.5)).astype(np.uint8)
    ragged_err = np.abs(native.batch_resize_pad_normalize(ragged, PIX_H, PIX_W) - ragged_numpy)
    resize_err, more_err = ragged_err[:3], ragged_err[3:]
    assert np.array_equal(got["batch_resize_pad_normalize"], want["batch_resize_pad_normalize"])
    tie_diff = int((native.batch_denormalize(ties) != numpy_ties).sum())
    lines_equal = all(np.array_equal(a, b)
                      for a, b in zip(got["vertical_lines"], want["vertical_lines"]))
    log(f"host C pass: {lib} (one OpenMP runtime: {runtimes}; {threads} OpenMP threads, "
        f"{cpus} CPUs in this process's affinity); normalize bitwise numpy "
        f"{np.array_equal(got['batch_normalize'], want['batch_normalize'])}, vertical_lines "
        f"bitwise numpy {lines_equal}, "
        f"denormalize bitwise half up {np.array_equal(got['batch_denormalize'], half_up)} "
        f"({tie_diff} of 255 ties above the numpy body), resize bitwise numpy at 64x256 "
        f"(no resampling), against PIL-exact on the JAX test's crops max {resize_err.max():.4f} "
        f"mean {resize_err.mean():.5f} (16 more ragged crops: max {more_err.max():.4f} mean "
        f"{more_err.mean():.5f}); ms per batch of {HOST_CROPS} "
        f"{PIX_H}x{PIX_W}x3 (library / numpy) "
        + ", ".join(f"{k} {v['library']:.3f} / {v['numpy']:.3f}" for k, v in host_ms.items())
        + f" [{smi}]")
    assert np.array_equal(got["batch_normalize"], want["batch_normalize"])
    assert lines_equal
    assert np.array_equal(got["batch_denormalize"], half_up) and tie_diff == 128, tie_diff
    assert resize_err.max() < 1.0 and resize_err.mean() < 0.03, resize_err.max()
    return dict(lib=str(lib), runtimes=runtimes, threads=threads, cpus=cpus, host_ms=host_ms)


def site_bound_bytes(call: dict) -> int:
    """A logged kernel site's bytes by the bound column's rule: each operand
    read once and each output written once (a forward site writes one x-shaped
    output; B.3 writes dx and the six parameter gradients in fp32)."""
    import numpy as np

    size = {"float32": 4, "bfloat16": 2}
    shapes, dtypes = call["shapes"], call["dtypes"]
    n = sum(int(np.prod(s)) * size[d] for s, d in zip(shapes, dtypes))
    if call["site"] == "ln_geglu_ffn_bwd":
        return n + int(np.prod(shapes[0])) * size[dtypes[0]] + 4 * (
            sum(int(np.prod(s)) for s in shapes[2:]) + shapes[0][1])
    return n + int(np.prod(shapes[0])) * size[dtypes[0]]


def phase33_host_and_tools(smi: str) -> dict:
    """Phase 33: the host C pass, ``profile_denoiser`` on 10 calls and
    ``roofline_dump``'s counts."""
    import math

    from worddiffusion_tpu_torch.scripts import profile_denoiser as pdn
    from worddiffusion_tpu_torch.scripts import roofline_dump as rd

    out = phase33a_host_pass(smi)
    # (b) the denoiser's time by bucket
    model, inputs = pdn.flagship("cuda")
    prof = pdn.profile(model, inputs, calls=10)
    del model, inputs
    total = prof["device_leaf_total_ms_per_call"]
    buckets = prof["buckets_ms_per_call"]
    launches = prof["launches_per_call"]
    top = prof["top_ops_ms_per_call"][:5]
    log(f"profile_denoiser (10 chained iam calls, B={TRAIN_B}): {prof['measured_ms_per_call']:.4f} "
        f"ms a call, device {total:.4f} ms ({prof['kernels_per_call']:.0f} kernels a call); "
        f"buckets (ms a call) { {k: round(v, 4) for k, v in buckets.items()} }; launches a call "
        f"{launches}; top {[(t['layer'][:40], t['op'][:30], round(t['ms'], 4)) for t in top]} "
        f"[{smi}]")
    assert abs(sum(buckets.values()) - total) <= 0.01 * total, (buckets, total)
    assert launches == {"ln_geglu_ffn": 4, "attention": 8, "groupnorm": UNET_NORMS[0],
                        "gn_silu_conv3x3": UNET_NORMS[1]}, launches
    # (c) the call's and the train step's work and bounds
    call, train = rd.call_counts(), rd.train_counts()
    nums = [v for c in (call["model"], call["as_run"], train["model"], train["as_run"])
            for v in (c["flops"], c["bytes_accessed"])]
    assert all(math.isfinite(v) and v > 0 for v in nums), nums
    for run in (call["as_run"], train["as_run"]):
        assert run["kernel_site_bytes"] == sum(site_bound_bytes(c) for c in run["calls"])
    ms = prof["measured_ms_per_call"]
    shares = {k: {"memory": call[k]["memory_bound_time_per_call_ms"] / ms,
                  "tensor": call[k]["tensor_bound_time_per_call_ms"] / ms} for k in call}
    attainable = call["as_run"]["attainable"]["attainable_time_per_call_ms"]
    shares["as_run"]["attainable"] = attainable / ms
    log(f"roofline_dump (B={TRAIN_B}): call model {call['model']['flops'] / 1e9:.2f} GFLOP "
        f"{call['model']['gb_per_call']:.3f} GB, as_run {call['as_run']['gb_per_call']:.3f} GB "
        f"(kernel sites {call['as_run']['kernel_site_bytes'] / 1e9:.3f} GB), attainable "
        f"{attainable:.4f} ms; measured "
        f"{ms:.4f} ms as a share of each bound {shares}; train step model "
        f"{train['model']['flops'] / 1e12:.3f} TFLOP {train['model']['bytes_accessed'] / 1e9:.2f} "
        f"GB ({train['model']['binding_resource']}), as_run {train['as_run']['flops'] / 1e12:.3f} "
        f"TFLOP {train['as_run']['bytes_accessed'] / 1e9:.2f} GB "
        f"({train['as_run']['binding_resource']}) [{smi}]")
    reset_counts()
    return dict(out, profile=prof, shares=shares)


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
    from worddiffusion_tpu_torch.ops import attention, ffn, fold_attention, gn_conv

    plain = UNet(dataclasses.replace(unet.cfg, use_pallas_ffn=False)).cuda().eval()
    plain.load_state_dict(unet.state_dict())
    with torch.no_grad():
        f0, a0, d0 = ffn.launches, attention.launches, fold_attention.launches
        n0, p0, s0 = norm_counts(), attention.probs_launches, gn_conv.stats_launches
        eps_k = unet(*inputs)
        n_ff, n_attn = ffn.launches - f0, attention.launches - a0
        n_fold, n_probs = fold_attention.launches - d0, attention.probs_launches - p0
        n_gn, n_conv = (b - a for a, b in zip(n0[:2], norm_counts()[:2]))
        n_stats = gn_conv.stats_launches - s0
        with plain_norms():
            before_ms = cuda_ms(lambda: unet(*inputs), reps=10)
            prof_before = device_profile(lambda: unet(*inputs))
        with all_plain():
            eps_p = plain(*inputs)
            plain_ms = cuda_ms(lambda: plain(*inputs), reps=10)
        err = (eps_k - eps_p).abs().max().item()
        rel = err / eps_p.abs().max().item()
        unet_ms = cuda_ms(lambda: unet(*inputs), reps=10)
        # one B.1 kernel per FF sub-layer, one B.5 kernel per GroupNorm and one
        # B.6 kernel per conv site, and B.5's statistics launch before a conv
        # site only where its sample is more CTAs than a cluster holds (pixel
        # space's images; the latent UNet's 8 x 32 and 4 x 16 sites take their
        # statistics in the conv kernel). The wrappers' counters are read over
        # the same window as the trace and must count every call's launches
        # exactly; the profiler now and then misses a kernel event on the card
        # (one gn_cluster_kernel of 105 in a pixel-space window), so a trace
        # short of what the counters of its own window show launched is logged
        # beside them and taken again, up to three times
        want = {"ffn_kernel<": n_ff, "gn_cluster_kernel": n_gn + n_stats, "conv_kernel<": n_conv}
        window = lambda: (ffn.launches, norm_counts()[0] + gn_conv.stats_launches,
                          norm_counts()[1])
        for attempt in range(3):
            c0 = window()
            prof = device_profile(lambda: unet(*inputs), calls=PROFILE_CALLS)
            counted = {k: (b - a) / (PROFILE_CALLS + 2)  # device_profile's calls
                       for k, a, b in zip(want, c0, window())}
            assert counted == want, f"launches counted in the profiled window {counted}, {want}"
            by_name = {k: sum(n for name, n in prof["per_call"].items() if k in name)
                       for k in want}
            if by_name == want:
                break
            log(f"unet B={B} ({label}): trace {attempt + 1} holds {by_name} kernels per call by "
                f"name, its window's counters {counted}: a kernel event missed; traced again")
    got = (n_ff, n_attn, n_fold, n_gn, n_conv)
    log(f"unet B={B} ({label}, {unet.cfg.model_channels} ch): eps max_abs_err {err:.6g} "
        f"max_rel_err {rel:.6g} (tol {UNET_REL_TOL}) against all-plain; launches per call: "
        f"{n_ff} FF, {n_attn} attention, {n_fold} fold attention, {n_gn} groupnorm, {n_conv} "
        f"gn_silu_conv3x3; call {unet_ms:.3f} ms all kernels, {before_ms:.3f} ms with plain "
        f"B.5/B.6, {plain_ms:.3f} ms all plain; profiled device busy {prof['busy_ms']:.4f} ms "
        f"and {prof['kernels']:.0f} kernels per call ({prof_before['busy_ms']:.4f} ms and "
        f"{prof_before['kernels']:.0f} with plain B.5/B.6); profiled kernels per call by name "
        f"{by_name}; top kernels (ms/call) {prof['top']} [{smi}]")
    assert got == tuple(launches) and n_probs == 0, (got, n_probs)
    assert by_name == want, (by_name, want)
    assert n_stats == (n_conv if unet.cfg.in_channels == 3 else 0), n_stats
    assert bool(torch.isfinite(eps_k).all()), "non-finite eps"
    assert rel <= UNET_REL_TOL, f"UNet all-kernel vs all-plain: rel {rel}"
    return dict(ms=unet_ms, before_ms=before_ms, plain_ms=plain_ms, err=err, rel=rel,
                probs=n_probs, eps=eps_k, busy_ms=prof["busy_ms"], kernels=prof["kernels"], top=prof["top"],
                busy_before_ms=prof_before["busy_ms"], kernels_before=prof_before["kernels"])


def drive_regen(smi: str, regen, samples, seed: int, label: str,
                per_call=(4, 8, 0, *UNET_NORMS), decoder=DECODER_NORMS,
                warm: bool = True) -> dict:
    """The regeneration main path over ``samples``: counts set to 0 just
    before the run and read just after; checks shapes, finiteness, the
    PNGs and the FF, attention, fold attention, B.5 and B.6 launches per
    denoiser call (``per_call``) plus, per batch, one VAE decode's
    (``decoder``; none in pixel space) and one OCR call's B.5 and B.6.
    ``warm``: one untimed batch first (left out where an earlier phase ran
    the same preset, so that nothing is paid for the first time)."""
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
    if warm:
        sampler.sample_async(words, list(range(B)), card_generator(123), ph)[0].cpu()
        checks.clear()

    reset_counts()
    t0 = time.perf_counter()
    stats = regen.run(samples, batch_size=B, seed=seed)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    got = (ffn.launches, attention.launches, fold_attention.launches, *norm_counts()[:2])
    geglu, fold7 = ffn.geglu_launches, fold_attention.flat_launches
    probs = attention.probs_launches

    dump = regen.out_dir
    n_batches = -(-len(samples) // B)
    log(f"regen {label}: {stats.generated} generated, {stats.accepted} accepted, {n_batches} "
        f"batches of {B}, {calls} denoiser calls each; {elapsed / n_batches:.3f} s/batch, "
        f"{stats.generated / elapsed:.2f} imgs/s (incl. PNG writes) [{smi}]")
    per_batch = (0, 0, 0, decoder[0] + OCR_NORMS[0], decoder[1] + OCR_NORMS[1])
    want = tuple((k * calls + p) * n_batches for k, p in zip(per_call, per_batch))
    log(f"kernel launches in the {label} main path (FF, attention, fold attention, groupnorm, "
        f"gn_silu_conv3x3): {got} (expect ({per_call} x {calls} calls + {per_batch}) x "
        f"{n_batches} batches = {want})")
    assert calls == 120, calls
    assert got == want and geglu == fold7 == probs == 0, (got, want, geglu, fold7, probs)
    assert stats.generated == len(samples), stats
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
                probs=probs, s_per_batch=elapsed / n_batches,
                imgs_per_s=stats.generated / elapsed)


def batch_seconds(smi: str, sampler, words, label: str, phosc=None) -> dict:
    """Wall seconds of one queued batch (120 denoiser calls, decode, OCR)
    with the attention kernels and with the plain attentions (folded or
    not), one after the other (the host-bound batch time drifts with the
    load on the host's shared cores, so compare within one run)."""
    import torch

    times = {"kernel": [], "plain": []}
    for r, kernel in enumerate((True, False)):
        gen = card_generator(200 + r)
        with contextlib.nullcontext() if kernel else plain_attention():
            t0 = time.perf_counter()
            sampler.sample_async(words, list(range(len(words))), gen, phosc)[0].cpu()
            times["kernel" if kernel else "plain"].append(time.perf_counter() - t0)
    log(f"regen {label} one batch of {len(words)} (120 calls + decode + OCR): "
        f"{times['kernel']} s with the attention kernel, {times['plain']} s with the plain "
        f"attention [{smi}]")
    return times


def regen_cli_args(cli, gt: str, dump: str, *extra: str):
    return cli.build_parser().parse_args([
        "--gt_file", gt, "--dump_path", dump, "--batch_size", str(B), "--keep_rejected", "1",
        "--seed", "0", *extra,
    ])


PIX_H, PIX_W = 64, 256
PIXEL_TRAIN_BS = (32, 16, 8)  # the largest of these that fits trains phase 23
# The pixel-space iam UNet's kernel sites at B=16: B.5 at the decoder's
# concatenated 640-channel inputs (+ SiLU), the spatial transformers' norms
# (no SiLU) and the output norm; B.6 at both resolutions; B.4 over the
# 42-token character context at 16384 and 4096 queries; B.1 over those
# tokens. B.4's self-attention row is the iam_phosc / gw shape (attn1 over
# the image itself), its plain version run in query chunks.
PIXEL_GN_SHAPES = ((B, 64, 256, 640, 32, True), (B, 32, 128, 640, 32, True),
                   (B, 64, 256, 320, 32, False), (B, 32, 128, 320, 32, False),
                   (B, 64, 256, 320, 32, True))
PIXEL_CONV_SHAPES = ((B, 64, 256, 320, 32), (B, 32, 128, 320, 32))
PIXEL_ATTN_SHAPES = ((B, 16384, 42), (B, 4096, 42))
PIXEL_SELF_ATTN = (B, 16384, 16384)
SELF_ATTN_CHUNK = 512  # query rows a chunk of the plain self-attention: 2 GiB of scores
PIXEL_FFN_M = (B * 16384, B * 4096)
HIGAN_NORMS = 13  # B.5 launches a HiGAN+ call: 2 per block (6) + out_norm
MAPS_ABS_TOL = 1e-4  # the maps kernel's fp32 probabilities against the plain softmax
MAPS_SHAPES = ((B, 256, 42), (B, 64, 42), (B, 16384, 42), (B, 4096, 42))


def pixel_kernel_rows(smi: str) -> dict:
    """Phase 23(a): B.5, B.6, B.4, B.1 and B.3 at the pixel-space shapes
    against their plain versions, each beside its bound and its library call."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import attention, ffn, gn_conv, groupnorm

    gn_rows, conv_rows, attn_rows, ffn_rows, bwd_rows, fast_rows = [], [], [], [], [], []
    for i, (b, h, w, c, groups, silu) in enumerate(PIXEL_GN_SHAPES):
        t = norm_inputs((b, h, w, c), seed=300 + i)
        args = (t["x"], t["scale"], t["bias"], groups, 1e-5, silu)
        got, again = groupnorm.fused_groupnorm(*args), groupnorm.fused_groupnorm(*args)
        torch.cuda.synchronize()
        want = groupnorm.groupnorm_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: groupnorm.fused_groupnorm(*args))
        plain_ms = launch_ms(lambda: groupnorm.groupnorm_reference(*args))
        nchw, ws, bs = t["x"].permute(0, 3, 1, 2), t["scale"].bfloat16(), t["bias"].bfloat16()
        library_ms = launch_ms(lambda: (F.silu if silu else (lambda y: y))(
            F.group_norm(nchw, groups, ws, bs, 1e-5)))
        bound_ms, bound_by = bound(nbytes(*t.values(), got), 0)
        cl, kept = groupnorm.route(t["x"], groups)
        log(f"pixel groupnorm B={b} {h}x{w} C={c} G={groups} silu={silu} (clusters of {cl}, x "
            f"{'kept in shared memory' if kept else 'read twice'}): max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {NORM_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
            f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{bound_ms / ms:.1%} of the bound [{smi}]")
        assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, again), (b, h, w, c)
        assert rel <= NORM_REL_TOL, f"groupnorm kernel disagrees at {b, h, w, c}: rel {rel}"
        gn_rows.append(dict(shape=(b, h, w, c, groups, silu), err=err, rel=rel, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, cluster=cl, kept=kept))
        del t, got, again, want

    for i, (b, h, w, c, groups) in enumerate(PIXEL_CONV_SHAPES):
        t = norm_inputs((b, h, w, c), seed=320 + i)
        g = card_generator(330 + i)
        wt = torch.randn(c, c, 3, 3, generator=g, device="cuda") / (9 * c) ** 0.5
        cb = 0.1 * torch.randn(c, generator=g, device="cuda")
        args = (t["x"], t["scale"], t["bias"], wt, cb, groups, 1e-5)
        got, again = gn_conv.fused_gn_silu_conv3x3(*args), gn_conv.fused_gn_silu_conv3x3(*args)
        torch.cuda.synchronize()
        want = gn_conv.gn_silu_conv3x3_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: gn_conv.fused_gn_silu_conv3x3(*args))
        plain_ms = launch_ms(lambda: gn_conv.gn_silu_conv3x3_reference(*args), calls=3)
        nchw, ws, bs = t["x"].permute(0, 3, 1, 2), t["scale"].bfloat16(), t["bias"].bfloat16()
        wb, cbb = wt.bfloat16().contiguous(memory_format=torch.channels_last), cb.bfloat16()
        library_ms = launch_ms(lambda: F.conv2d(F.silu(F.group_norm(nchw, groups, ws, bs, 1e-5)),
                                                wb, cbb, padding=1))
        flops = 2 * 9 * c * c * b * h * w
        bound_ms, bound_by = bound(nbytes(*t.values(), got, cb) + wt.numel() * 2, flops)
        log(f"pixel gn_silu_conv3x3 B={b} {h}x{w} C={c} "
            f"({conv_plan_text(b, h, w, c, groups)}): max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {NORM_REL_TOL}); "
            f"bitwise repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms F.group_norm + F.silu + F.conv2d {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / ms:.1%} of the bound, "
            f"{flops / ms / 1e9:.0f} TFLOP/s [{smi}]")
        assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, again), (b, h, w, c)
        assert rel <= NORM_REL_TOL, f"gn_silu_conv3x3 disagrees at {b, h, w, c}: rel {rel}"
        conv_rows.append(dict(shape=(b, h, w, c, groups), err=err, rel=rel, ms=ms,
                              plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by))
        del t, got, again, want

    scale = D_HEAD ** -0.5
    for i, (b, nq, nk) in enumerate(PIXEL_ATTN_SHAPES + (PIXEL_SELF_ATTN,)):
        q, k, v = attn_inputs(b, nq, nk, seed=340 + i)
        got, again = (attention.fused_attention(q, k, v, scale) for _ in range(2))
        torch.cuda.synchronize()
        chunked = nq * nk > 2 ** 26  # the plain [B, H, Nq, Nk] fp32 scores in query chunks

        def plain():
            if not chunked:
                return attention.attention_reference(q, k, v, scale)
            return torch.cat([attention.attention_reference(
                q[:, :, s:s + SELF_ATTN_CHUNK], k, v, scale)
                for s in range(0, nq, SELF_ATTN_CHUNK)], dim=2)

        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: attention.fused_attention(q, k, v, scale), calls=3 if chunked else 10)
        plain_ms = launch_ms(plain, calls=1, reps=3)
        library_ms = launch_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                               calls=3 if chunked else 10)
        bound_ms, bound_by = bound(nbytes(q, k, v, got), 4 * b * HEADS * nq * nk * D_HEAD)
        floors = attn_floors(q, k, v, got)
        log(f"pixel attention B={b} H={HEADS} Nq={nq} Nk={nk} D={D_HEAD} "
            f"({attn_plan_text(b, HEADS, nq, nk)}; plain "
            f"{'in query chunks' if chunked else 'whole'}): "
            f"max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {ATTN_REL_TOL}); bitwise "
            f"repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"scaled_dot_product_attention {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {bound_ms / ms:.1%} of the bound; {floors_text(floors, ms)} "
            f"[{smi}]")
        assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, again), (b, nq, nk)
        assert rel <= ATTN_REL_TOL, f"attention kernel disagrees at {b, nq, nk}: rel {rel}"
        attn_rows.append(dict(b=b, nq=nq, nk=nk, err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                              **floors))
        if not chunked:  # the self-attention's plain version alone takes 364 ms
            fast_rows.append(fast_attention_row(smi, "pixel attention", q, k, v, attn_rows[-1],
                                                got))
        del q, k, v, got, again, want

    for i, m in enumerate(PIXEL_FFN_M):
        f = ffn_inputs(m, seed=360 + i)
        got, again = ffn.fused_ln_geglu_ffn(**f), ffn.fused_ln_geglu_ffn(**f)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_reference(**f)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: ffn.fused_ln_geglu_ffn(**f))
        plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_reference(**f), calls=3)
        bound_ms, bound_by = ffn_bound(f, got)
        log(f"pixel ffn M={m} (cluster of {ffn.cluster_size(m, INNER)}): max_abs_err {err:.6g} "
            f"max_rel_err {rel:.6g} (tol {FFN_REL_TOL}); bitwise repeatable "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}), kernel at {bound_ms / ms:.1%} of the bound [{smi}]")
        assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, again), m
        assert rel <= FFN_REL_TOL, f"ffn kernel disagrees at M={m}: rel {rel}"
        ffn_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
        del f, got, again, want

        a = bwd_inputs(m, seed=370 + i)
        got, again = ffn.ln_geglu_ffn_bwd(**a), ffn.ln_geglu_ffn_bwd(**a)
        torch.cuda.synchronize()
        want = ffn.ln_geglu_ffn_bwd_reference(**a)
        errs = []
        for name, g, w, g2 in zip(GRADS, got, want, again):
            share = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
            errs.append((g.float() - w.float()).abs().max().item())
            assert bool(torch.isfinite(g.float()).all()) and torch.equal(g, g2), (name, m)
            assert share <= BWD_REL_TOL, f"backward kernel disagrees at M={m}: {name} {share}"
        ms = launch_ms(lambda: ffn.ln_geglu_ffn_bwd(**a), calls=3)
        plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_bwd_reference(**a), calls=1, reps=3)
        bound_ms, bound_by = bound(nbytes(*a.values(), *got), 16 * m * D * INNER)
        log(f"pixel ffn bwd (B.3) M={m} ({bwd_plan_text(m)}): every "
            f"gradient within {BWD_REL_TOL} of plain, bitwise repeatable; kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{bound_ms / ms:.1%} of the bound [{smi}]")
        bwd_rows.append(dict(m=m, err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
        del a, got, again, want
    torch.cuda.empty_cache()
    return dict(gn_rows=gn_rows, conv_rows=conv_rows, attn_rows=attn_rows, ffn_rows=ffn_rows,
                bwd_rows=bwd_rows, attn_fast_rows=fast_rows)


def pixel_unet_inputs(sampler, words):
    """One pixel-space UNet call's inputs at B=16: seeded x_t [16, 64, 256,
    3], four timesteps, the words' char ids, writers 0..15."""
    import torch

    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, PIX_H, PIX_W, 3, generator=g).cuda()
    t = torch.tensor([599, 400, 200, 10] * (B // 4)).cuda()
    ctx = torch.from_numpy(sampler.tokenizer.encode_batch(words[:B])).long().cuda()
    return x, t, ctx, torch.arange(B).cuda(), None


def write_pixel_corpus(work: str, n: int) -> tuple[str, str]:
    """``n`` seeded 64x256 word PNGs and their gt file (phase 23's training)."""
    from worddiffusion_tpu_torch.data.synthetic import render_word
    from worddiffusion_tpu_torch.utils.images import encode_png

    crops = os.path.join(work, "pixel_crops")
    os.makedirs(crops)
    words = "the of and to in is was that for it with as his on be at".split()
    gt = os.path.join(work, "pixel.filter27")
    with open(gt, "w") as f:
        for i in range(n):
            img = render_word(words[i % len(words)], PIX_H, PIX_W, seed=i)
            with open(os.path.join(crops, f"p01-{i:04d}u-00.png"), "wb") as png:
                png.write(encode_png(img))
            f.write(f"{i % 50:03d},p01-{i:04d}u-00 {words[i % len(words)]}\n")
    return crops, gt


def phase23_pixel(smi: str, work: str, cli, gt: str, words) -> dict:
    """Phase 23: pixel space (``--latent 0``) at full width: the kernels at
    its shapes, one UNet call all-kernel vs all-plain, the regeneration CLI
    at B=16 and the train CLI at the largest batch that fits, with a bitwise
    resume."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.models.layers import init_weights_

    rows = pixel_kernel_rows(smi)

    # (b) one UNet call all kernels against all plain, and (c) the regeneration CLI
    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_pixel"),
                                              "--latent", "0"))
    sampler = regen.sampler
    assert sampler.vae is None and sampler.latent_shape == (PIX_H, PIX_W, 3)
    assert sampler.model.cfg.in_channels == sampler.model.cfg.out_channels == 3
    init_weights_(sampler.model, seed=0, zero_init=False)
    torch.cuda.reset_peak_memory_stats()
    unet = unet_check(smi, sampler.model, pixel_unet_inputs(sampler, words), "iam pixel")
    regen_px = drive_regen(smi, regen, samples[:B], seed=0, label="iam pixel",
                           decoder=(0, 0), warm=False)
    peak_regen = torch.cuda.max_memory_allocated()
    log(f"pixel regeneration: peak memory {peak_regen / 2 ** 30:.3f} GiB [{smi}]")
    del regen, sampler
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the train CLI: the largest of PIXEL_TRAIN_BS that fits
    train_b, err = None, None
    for tb in PIXEL_TRAIN_BS:
        os.makedirs(os.path.join(work, f"px{tb}"))
        crops, pgt = write_pixel_corpus(os.path.join(work, f"px{tb}"), 2 * tb + tb // 2)
        try:
            out = pixel_train(smi, work, crops, pgt, tb, train_cli)
            train_b = tb
            break
        except torch.cuda.OutOfMemoryError as e:  # the next smaller batch
            err = str(e).splitlines()[0]  # not the exception: its frames hold the tensors
            log(f"pixel training at B={tb} does not fit: {err}")
            gc.collect()
            torch.cuda.empty_cache()
    assert train_b is not None, f"no pixel-space batch of {PIXEL_TRAIN_BS} fits: {err}"
    log(f"pixel training batch: B={train_b} (of {PIXEL_TRAIN_BS}), peak memory above the "
        f"run's start {out['peak_bytes'] / 2 ** 30:.3f} GiB [{smi}]")

    # (e) the sampling CLI on the trained EMA weights: DDIM-10, no decoder
    from worddiffusion_tpu_torch.cli import sample as sample_cli

    ckpt = os.path.join(work, f"pixel_run{train_b}", "ckpt", "4", "ema_unet.pt")
    reset_counts()
    names = sample_cli.main(["--words", ",".join(words[:6]), "--writer", "3", "--latent", "0",
                             "--torch_ckpt", ckpt, "--ddim", "10", "--seed", "0",
                             "--save_path", os.path.join(work, "sample_pixel")])
    sampled = all_counts()
    log(f"pixel sample: {len(names)} PNGs from the trained EMA weights, launches {sampled} "
        f"[{smi}]")
    assert names == [f"{i:05d}_3_{w}.png" for i, w in enumerate(words[:6])], names
    assert sampled == dict(ffn=40, ffn_bwd=0, attn=80, fold=0, fold_b7=0, gn=10 * UNET_NORMS[0],
                           conv=10 * UNET_NORMS[1], geglu=0, probs=0), sampled
    assert png_size(os.path.join(work, "sample_pixel", names[0])) == (PIX_W, PIX_H)
    return dict(rows=rows, unet=unet, regen=regen_px, train=out, train_b=train_b,
                peak_regen=peak_regen, sample=sampled, corpus=(crops, pgt))


def pixel_train(smi: str, work: str, crops: str, gt: str, tb: int, train_cli) -> dict:
    """The train CLI with ``--latent 0`` at B=``tb``: 2 epochs of 2 steps on
    the crops (x0 the image itself), a DDIM-10 preview at the end; launches
    and Function backwards a step; a max_steps stop and a bitwise resume;
    s/step and peak memory."""
    import torch

    from worddiffusion_tpu_torch.ops import attention, ffn

    steps = 4

    def args(save: str, *extra: str):
        return train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", gt, "--iam_path", crops, "--latent", "0",
            "--batch_size", str(tb), "--epochs", "2", "--ckpt_every_epochs", "2",
            "--preview_ddim", "10", "--save_path", os.path.join(work, save), "--seed", "0",
            "--device", "cuda", *extra])

    trainer = train_cli.build(args(f"pixel_run{tb}"))
    assert trainer.encode_fn is None and trainer.exp.unet.in_channels == 3
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    state = trainer.run(epochs=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    counts = all_counts()
    _, _, gn_bwd, conv_bwd = norm_counts()
    attn_bwd, ffn_bwd = attention.bwd_calls, ffn.bwd_launches
    preview = 10  # DDIM-10: 10 UNet calls, no decode
    log(f"pixel train B={tb}: {state.step} steps in {wall:.2f} s incl. one DDIM-10 preview; "
        f"launches {counts}; backwards: attention {attn_bwd}, B.3 {ffn_bwd}, B.5 {gn_bwd}, B.6 "
        f"{conv_bwd}; peak memory above the run's start {peak / 2 ** 30:.3f} GiB [{smi}]")
    assert state.step == steps, state.step
    want = dict(ffn=4 * (steps + preview), ffn_bwd=4 * steps, attn=8 * (steps + preview),
                gn=UNET_NORMS[0] * (steps + preview), conv=UNET_NORMS[1] * (steps + preview))
    assert all(counts[k] == v for k, v in want.items()), (counts, want)
    assert counts["fold"] == counts["fold_b7"] == counts["geglu"] == counts["probs"] == 0, counts
    assert (attn_bwd, gn_bwd, conv_bwd) == (8 * steps, *(n * steps for n in UNET_NORMS))
    changed = max((v - initial[k]).abs().max().item()
                  for k, v in state.model.state_dict().items())
    assert changed > 0 and all(torch.isfinite(p).all() for p in state.model.parameters())
    pngs = os.listdir(os.path.join(work, f"pixel_run{tb}", "images"))
    assert pngs == ["epoch_0001.png"], pngs
    s_per_step = trainer.epoch_seconds[1][0] / trainer.epoch_seconds[1][1]

    part = train_cli.build(args(f"pixel_resume{tb}")).run(epochs=2, max_steps=3)
    assert part.step == 3, part.step
    resumed = train_cli.build(args(f"pixel_resume{tb}", "--loadPrev", "1")).run(
        epochs=2, resume=True)
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    log(f"pixel train resume: stopped at step 3, resumed to {resumed.step}; max param diff vs "
        f"the uninterrupted run {diff:.6g}; must be bitwise 0. s/step (epoch 1) "
        f"{s_per_step:.4f} [{smi}]")
    assert resumed.step == steps and diff == 0, (resumed.step, diff)
    return dict(counts=dict(counts, ffn_bwd=ffn_bwd), s_per_step=s_per_step, peak_bytes=peak)


def phase24_higan(smi: str, work: str, cli, gt: str, corpus: tuple[str, str]) -> dict:
    """Phase 24: the HiGAN+ denoiser (``--hiGanArch 1``) at ``iam`` width:
    one call all-kernel vs plain B.5 (13 launches), the same in pixel space
    (B.5 at [16, 64, 256, 320]), the train CLI on the latent cache (13 B.5
    and 13 GroupNormFn backwards a step, bitwise resume), the regeneration
    CLI and the sampling CLI on its EMA weights."""
    import torch

    from worddiffusion_tpu_torch.cli import sample as sample_cli
    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.configs.pixel import pixel_space_exp
    from worddiffusion_tpu_torch.models.higan import HiGanDenoiserAdapter
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import groupnorm

    out = {}
    for space in ("latent", "pixel"):
        exp = presets.get("iam")
        if space == "pixel":
            exp = pixel_space_exp(exp)
        model = init_weights_(HiGanDenoiserAdapter(exp.unet), seed=0, zero_init=False).cuda()
        model = model.to(memory_format=torch.channels_last).eval()
        shape = (B, 8, 32, 4) if space == "latent" else (B, PIX_H, PIX_W, 3)
        g = torch.Generator().manual_seed(5)
        x = torch.randn(*shape, generator=g).cuda()
        t = torch.tensor([599, 400, 200, 10] * (B // 4)).cuda()
        ctx = torch.randint(1, 50, (B, 42), generator=g).cuda()
        wid = torch.arange(B).cuda()
        with torch.no_grad():
            reset_counts()
            got = model(x, t, ctx, wid)
            counts = all_counts()
            with plain_norms():
                want = model(x, t, ctx, wid)
                plain_ms = cuda_ms(lambda: model(x, t, ctx, wid), reps=10)
            ms = cuda_ms(lambda: model(x, t, ctx, wid), reps=10)
        rel = (got - want).abs().max().item() / want.abs().max().item()
        log(f"higan {space} B={B} {shape[1]}x{shape[2]}: launches {counts}; all kernels vs "
            f"plain B.5 max_rel_err {rel:.6g} (tol {UNET_REL_TOL}); call {ms:.3f} ms, with plain "
            f"B.5 {plain_ms:.3f} ms [{smi}]")
        assert counts == only_groupnorm(HIGAN_NORMS), counts
        assert bool(torch.isfinite(got).all()) and rel <= UNET_REL_TOL, rel
        out[f"{space}_ms"], out[f"{space}_plain_ms"] = ms, plain_ms
        del model

    # the train CLI on the latent cache: 2 epochs of 3 steps, then a bitwise resume
    lat_gt, cache = short_corpus(os.path.join(work, "higan_corpus"), corpus)
    steps = 6

    def args(save: str, *extra: str):
        return train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", lat_gt, "--latent_cache", cache, "--hiGanArch", "1",
            "--batch_size", str(TRAIN_B), "--epochs", "2", "--ckpt_every_epochs", "1",
            "--save_path", os.path.join(work, save), "--seed", "0", "--device", "cuda", *extra])

    trainer = train_cli.build(args("higan_run"))
    assert isinstance(trainer.model, HiGanDenoiserAdapter) and trainer.preview_fn is None
    reset_counts()
    state = trainer.run(epochs=2)
    torch.cuda.synchronize()
    counts, gn_bwd = all_counts(), groupnorm.bwd_calls
    log(f"higan train B={TRAIN_B}: {state.step} steps; launches {counts}; GroupNormFn backward "
        f"calls {gn_bwd} [{smi}]")
    assert state.step == steps and counts == only_groupnorm(HIGAN_NORMS * steps)
    assert gn_bwd == HIGAN_NORMS * steps, gn_bwd
    s_per_step = trainer.epoch_seconds[1][0] / trainer.epoch_seconds[1][1]
    part = train_cli.build(args("higan_resume")).run(epochs=2, max_steps=4)
    resumed = train_cli.build(args("higan_resume", "--loadPrev", "1")).run(epochs=2, resume=True)
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    log(f"higan train resume: stopped at {part.step}, resumed to {resumed.step}; max param diff "
        f"{diff:.6g}; must be bitwise 0; s/step (epoch 1) {s_per_step:.4f} [{smi}]")
    assert part.step == 4 and resumed.step == steps and diff == 0, (part.step, diff)
    ckpt = os.path.join(work, "higan_run", "ckpt", str(steps), "ema_unet.pt")

    # the regeneration CLI on those weights: 13 B.5 a call, the decode's and OCR's per batch
    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_higan"),
                                              "--hiGanArch", "1", "--torch_ckpt", ckpt))
    samples = samples[:B]
    reset_counts()
    t0 = time.perf_counter()
    stats = regen.run(samples, batch_size=B, seed=0)
    torch.cuda.synchronize()
    regen_s = time.perf_counter() - t0
    regen_counts = all_counts()
    want = dict(only_groupnorm(HIGAN_NORMS * 120 + DECODER_NORMS[0] + OCR_NORMS[0]),
                conv=DECODER_NORMS[1] + OCR_NORMS[1])
    log(f"higan regen: {stats.generated} generated in one batch of {B}, 120 calls, "
        f"{regen_s:.3f} s; launches {regen_counts} [{smi}]")
    assert stats.generated == B and regen_counts == want, (regen_counts, want)

    # the sampling CLI: DDIM-50 on the same weights
    reset_counts()
    names = sample_cli.main(["--words", ",".join(words_of(samples)[:6]), "--writer", "3",
                             "--hiGanArch", "1", "--torch_ckpt", ckpt, "--ddim", "50",
                             "--save_path", os.path.join(work, "sample_higan"), "--seed", "0"])
    sample_counts = all_counts()
    log(f"higan sample: {len(names)} PNGs, launches {sample_counts} [{smi}]")
    assert len(names) == 6 and sample_counts["gn"] == HIGAN_NORMS * 50 + DECODER_NORMS[0]
    assert sample_counts["conv"] == DECODER_NORMS[1], sample_counts
    return dict(out, train=dict(counts, ffn_bwd=0), regen=regen_counts, sample=sample_counts,
                s_per_step=s_per_step, regen_s=regen_s, resume_diff=diff)


def short_corpus(folder: str, corpus: tuple[str, str]) -> tuple[str, str]:
    """The first 3.5 batches of the phase-7 latent corpus in ``folder``
    (``train.filter27``, ``latents.npz``): 3 steps an epoch at B=128."""
    import shutil

    os.makedirs(folder)
    gt = os.path.join(folder, "train.filter27")
    with open(corpus[0]) as f:
        lines = f.readlines()[:3 * TRAIN_B + TRAIN_B // 2]
    with open(gt, "w") as f:
        f.writelines(lines)
    shutil.copy(corpus[1], os.path.join(folder, "latents.npz"))
    return gt, os.path.join(folder, "latents.npz")


def words_of(samples) -> list:
    return [s.word for s in samples]


DDP_WORKER_FLAG = "--ddp-worker"


def free_port() -> int:
    """A port on localhost that is free now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_worker(work: str) -> int:
    """Phase 25's process (started by ``phases25_28_32`` with torchrun's
    environment): the train CLI under ``DistributedDataParallel`` at world
    size 1 on NCCL, counts set to 0 before and read after each run, then a
    max_steps stop and a resume; writes what it saw as JSON."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.ops import attention, ffn

    gt, cache = os.path.join(work, "train.filter27"), os.path.join(work, "latents.npz")

    def args(save: str, *extra: str):
        return train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", gt, "--latent_cache", cache, "--mesh_data", "1",
            "--batch_size", str(TRAIN_B), "--epochs", "2", "--ckpt_every_epochs", "2",
            "--preview_ddim", "2", "--save_path", os.path.join(work, save), "--seed", "0",
            "--device", "cuda", *extra])

    trainer = train_cli.build(args("ddp_run"))
    import torch.distributed as dist

    assert dist.is_initialized() and dist.get_backend() == "nccl" and trainer.distributed
    reset_counts()
    state = trainer.run(epochs=2)
    torch.cuda.synchronize()
    counts = dict(all_counts(), attn_bwd=attention.bwd_calls, gn_bwd=norm_counts()[2],
                  conv_bwd=norm_counts()[3])
    assert type(trainer._ddp).__name__ == "DistributedDataParallel"
    part = train_cli.build(args("ddp_resume")).run(epochs=2, max_steps=3)
    resumed = train_cli.build(args("ddp_resume", "--loadPrev", "1")).run(epochs=2, resume=True)
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    torch.save(state.model.state_dict(), os.path.join(work, "ddp_final.pt"))
    with open(os.path.join(work, "ddp.json"), "w") as f:
        json.dump(dict(counts=counts, steps=state.step, part=part.step, resumed=resumed.step,
                       resume_diff=diff, ffn_bwd=ffn.bwd_launches,
                       epoch_seconds=trainer.epoch_seconds), f)
    dist.destroy_process_group()
    return 0


def phase25_ddp_check(smi: str, ddp: str, ref: dict, seconds: float) -> dict:
    """Phase 25: the trainer under ``DistributedDataParallel`` at world size
    1 on NCCL, in a process started with torchrun's environment (started by
    ``phases25_28_32``): kernel counts a step under DDP's hooks, a bitwise
    resume, and the result against ``ref``, the same run without a process
    group."""
    import torch

    with open(os.path.join(ddp, "ddp.json")) as f:
        got = json.load(f)
    steps, preview = 6, 2
    c = got["counts"]
    log(f"ddp world size 1 (NCCL, torchrun env, {seconds:.1f} s with the process's start, "
        f"beside phase 28's ranks): {got['steps']} steps, launches {c}; resume {got['part']} -> "
        f"{got['resumed']}, max param diff {got['resume_diff']:.6g} [{smi}]")
    want = dict(ffn=4 * (steps + preview), ffn_bwd=4 * steps, attn=8 * (steps + preview),
                gn=UNET_NORMS[0] * (steps + preview) + DECODER_NORMS[0],
                conv=UNET_NORMS[1] * (steps + preview) + DECODER_NORMS[1],
                attn_bwd=8 * steps, gn_bwd=UNET_NORMS[0] * steps, conv_bwd=UNET_NORMS[1] * steps,
                fold=0, fold_b7=0, geglu=0, probs=0)
    assert got["steps"] == steps and c == want, (c, want)
    assert got["part"] == 3 and got["resumed"] == steps and got["resume_diff"] == 0, got
    ddp_sd = torch.load(os.path.join(ddp, "ddp_final.pt"), map_location="cuda")
    diff = max((ddp_sd[k] - v).abs().max().item() for k, v in ref.items())
    log(f"ddp world size 1 vs no process group: max param diff {diff:.6g} [{smi}]")
    assert diff == 0, f"DDP at world size 1 is not the one-process run: {diff}"
    return dict(counts={k: v for k, v in c.items() if k in want}, resume_diff=got["resume_diff"],
                s_per_step=got["epoch_seconds"][1][0] / got["epoch_seconds"][1][1])


def phase26_maps(smi: str, words) -> dict:
    """Phase 26: ``return_attn``: the maps kernel against the plain maps at
    ``iam``'s shapes (latent and pixel, B=16), then a ``return_attn`` UNet
    call in each space: 8 maps from the kernel beside B.4, against the
    plain maps of the same call's attentions."""
    import dataclasses as dc

    import torch

    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.configs.pixel import pixel_space_exp
    from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import attention

    scale = D_HEAD ** -0.5
    rows = []
    for i, (b, nq, nk) in enumerate(MAPS_SHAPES):
        q, k, v = attn_inputs(b, nq, nk, seed=400 + i)
        with torch.no_grad():
            lse = attention.attention_lse(q, k, v, scale)[1]
            got = attention.attention_probs(q, k, lse, scale)
            again = attention.attention_probs(q, k, lse, scale)
            torch.cuda.synchronize()
            want = attention.attention_probs_reference(q, k, scale)
            err = (got - want).abs().max().item()
            rowsum = (got.sum(-1) - 1).abs().max().item()
            ms = launch_ms(lambda: attention.attention_probs(q, k, lse, scale))
            plain_ms = launch_ms(lambda: attention.attention_probs_reference(q, k, scale))
            # one PyTorch call of the same function: softmax of the fp32 scores
            sims = torch.matmul(q.float(), k.float().transpose(-1, -2))
            library_ms = launch_ms(lambda: torch.softmax(sims * scale, dim=-1))
        bound_ms, bound_by = bound(nbytes(q, k, lse, got), 2 * b * HEADS * nq * nk * D_HEAD)
        log(f"attention maps B={b} H={HEADS} Nq={nq} Nk={nk}: max_abs_err {err:.6g} (tol "
            f"{MAPS_ABS_TOL}), rows sum to 1 within {rowsum:.3g}; bitwise repeatable "
            f"{torch.equal(got, again)}; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"torch.softmax (on precomputed scores) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {bound_ms / ms:.1%} of the bound [{smi}]")
        assert got.dtype == torch.float32 and torch.equal(got, again), (b, nq, nk)
        assert err <= MAPS_ABS_TOL and rowsum <= 1e-3, (err, rowsum)
        rows.append(dict(b=b, nq=nq, nk=nk, err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
        del q, k, v, got, again, want, sims

    calls = {}
    tok = Tokenizer.from_name("eng_main", 42)
    for space in ("latent", "pixel"):
        exp = presets.get("iam")
        if space == "pixel":
            exp = pixel_space_exp(exp)
        cfg = dc.replace(exp.unet, return_attn=True)
        unet = init_weights_(UNet(cfg), seed=0, zero_init=False).cuda().eval()
        shape = (B, 8, 32, 4) if space == "latent" else (B, PIX_H, PIX_W, 3)
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(7)).cuda()
        inputs = (x, torch.tensor([599, 400, 200, 10] * (B // 4)).cuda(),
                  torch.from_numpy(tok.encode_batch(words[:B])).long().cuda(),
                  torch.arange(B).cuda())
        seen = {}
        fwd = attention.attention_with_probs

        def spy(q, k, v, s):  # keep each attention's q, k for the plain maps
            seen[len(seen)] = (q, k)
            return fwd(q, k, v, s)

        with torch.no_grad(), mock.patch.object(attention, "attention_with_probs", spy):
            reset_counts()
            eps, maps = unet(*inputs)
            counts = all_counts()
        errs = [(maps[name] - attention.attention_probs_reference(*seen[i], scale)).abs().max()
                .item() for i, (name, _) in enumerate(unet._attn_names)]
        log(f"return_attn UNet call ({space}, B={B}): {len(maps)} maps "
            f"{sorted({tuple(m.shape) for m in maps.values()})}; launches {counts}; maps vs the "
            f"plain softmax of the same q, k: max_abs_err {max(errs):.6g} (tol {MAPS_ABS_TOL}) "
            f"[{smi}]")
        assert len(maps) == 8 and bool(torch.isfinite(eps).all())
        assert counts == dict(ffn=4, ffn_bwd=0, attn=8, fold=0, fold_b7=0, gn=UNET_NORMS[0],
                              conv=UNET_NORMS[1], geglu=0, probs=8), counts
        assert max(errs) <= MAPS_ABS_TOL, errs
        calls[space] = counts
        del unet, maps, eps, seen
        torch.cuda.empty_cache()
    return dict(rows=rows, paths={f"unet_return_attn_{k}": dict(v) for k, v in calls.items()})


def phase27_host(smi: str, work: str) -> dict:
    """Phase 27: the host-side data code on this machine's CPU (numpy only;
    no Pillow and no OpenCV here): each augmentation op's and
    ``resize_dataset``'s ms per 64x256 image, and the PNG reader's ms per
    image by variant; whether this machine could decode JPEG
    (``torchvision.io``), for ROADMAP A.9's decision."""
    import numpy as np

    from worddiffusion_tpu_torch.data import augment
    from worddiffusion_tpu_torch.data.manipulate import resize_dataset
    from worddiffusion_tpu_torch.data.png import decode_png
    from worddiffusion_tpu_torch.data.synthetic import render_word
    from worddiffusion_tpu_torch.utils.images import encode_png

    img = render_word("Mississippi", PIX_H, PIX_W, seed=0)
    ops = {
        "noise": lambda r: augment.noise(img, r), "shear_x": lambda r: augment.shear_x(img, 0.2),
        "shear_y": lambda r: augment.shear_y(img, 0.03), "erode": lambda r: augment.erode(img),
        "dilate": lambda r: augment.dilate(img), "blur": lambda r: augment.blur(img, 1.1),
        "sharpness": lambda r: augment.sharpness(img, 1.7), "rotate": lambda r: augment.rotate(img, r),
        "random_perspective": lambda r: augment.random_perspective(img, r, 0.3),
        "random_erase": lambda r: augment.random_erase(img, r),
        "random_augment": lambda r: augment.random_augment(img, r),
        "resize_dataset": lambda r: resize_dataset([img])[0],
    }
    host_ms = {}
    for name, fn in ops.items():
        rng = np.random.default_rng(0)
        out = fn(rng)
        assert out.dtype == np.uint8 and out.shape[2] == 3, name
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            fn(rng)
        host_ms[name] = (time.perf_counter() - t0) / n * 1e3
    grey = np.ascontiguousarray(img[..., 0])
    variants = {"rgb8": encode_png(img), "grey8": encode_png(grey[..., None])}
    png_ms = {}
    for name, data in variants.items():
        assert (decode_png(data) == (img if name == "rgb8" else img[..., :1])).all(), name
        t0 = time.perf_counter()
        for _ in range(20):
            decode_png(data)
        png_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    try:
        import torchvision.io  # noqa: F401

        jpeg = "torchvision.io is importable"
    except Exception as e:  # the decision's input: what this machine has
        jpeg = f"no torchvision.io ({type(e).__name__})"
    log(f"host data, ms per 64x256 image on this machine's CPU: augmentation "
        + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items())
        + "; PNG decode " + ", ".join(f"{k} {v:.3f}" for k, v in png_ms.items())
        + f"; JPEG: {jpeg} [{smi}]")
    return dict(host_ms=host_ms, png_ms=png_ms, jpeg=jpeg)


def reference_layout(unet, seed: int) -> dict:
    """``unet``'s weights as a reference checkpoint holds them: the
    ``--attentionMaps`` ``middle_block1`` layout, the research UNetModel's
    dead ``to_kv`` / ``attnc`` / ``norm1`` tensors (seeded) and the
    ``{"state_dict": ...}`` wrapper."""
    import torch

    from worddiffusion_tpu_torch.models.convert import port_unet_to_reference

    g = torch.Generator().manual_seed(seed)
    dead = {}
    for k, v in unet.state_dict().items():
        if k.endswith(".attn2.to_q.weight"):
            tb, d = k[:-len(".attn2.to_q.weight")], v.shape[1]
            dead[tb + ".attn1.to_kv.weight"] = torch.randn(2 * d, d, generator=g)
            dead[tb + ".attnc.to_q.weight"] = torch.randn(d, d, generator=g)
            dead[tb + ".norm1.weight"] = torch.randn(d, generator=g)
            dead[tb + ".norm1.bias"] = torch.randn(d, generator=g)
    sd = port_unet_to_reference({k: v.cpu() for k, v in unet.state_dict().items()}, unet.cfg,
                                template=dead, middle_block1=True)
    return {"state_dict": sd}


def dump_files(dump: str) -> dict:
    """name -> bytes of every PNG a regeneration dump holds (accepted and
    rejected)."""
    out = {}
    for d in (dump, os.path.join(dump, "rejected")):
        if os.path.isdir(d):
            for n in sorted(os.listdir(d)):
                if n.endswith(".png"):
                    with open(os.path.join(d, n), "rb") as f:
                        out[os.path.relpath(os.path.join(d, n), dump)] = f.read()
    return out


def phase29_checkpoints(smi: str, work: str, cli, gt: str, corpus: tuple[str, str],
                        ocr_dir: str) -> dict:
    """Phase 29: checkpoints without the JAX package, and JPEG crops. (a) the
    seeded full-width ``iam`` weights written in the reference layout
    (``reference_layout``) and in the port's keys; 16 words through the
    regeneration CLI from each (``--torch_ckpt``): every PNG and the UNet's
    eps on a fixed input bitwise equal, 4 / 8 / 9 / 12 B.1 / B.4 / B.5 / B.6
    launches a UNet call, s/batch of both in turns; (b) ``--ckpt_dir`` on
    phase 7's checkpoint with ``--use_ema 0`` (the trained weights, bitwise;
    writers_dict_train.json found beside it), one batch; (c)
    ``cli.export_reference --middle_block1 1`` of that checkpoint, reloaded
    bitwise; (d) ``data/jpeg_check.npz`` decoded bitwise, the decoder's and
    the PNG reader's host ms per 64x256 crop; (e) ``cli.evaluate`` over a
    directory of 256 JPEG crops (32 renders written by the check set's numpy
    encoder, each under 8 names, every file decoded anew) with
    ``--ocr_ckpt`` (phase 22(e)'s directory), B.5 counted, against the same
    crops as PNGs, after a warm-up run: images/s of the whole call,
    and the loading (``evaluate._load_dir``) timed apart from the CLI's fixed
    set-up and the featurizers."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.cli import evaluate, export_reference
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.data.jpeg import decode_jpeg
    from worddiffusion_tpu_torch.data.make_jpeg_check import CHECK_FILE, encode_baseline
    from worddiffusion_tpu_torch.data.png import decode_png
    from worddiffusion_tpu_torch.data.synthetic import render_word
    from worddiffusion_tpu_torch.models.convert import reference_unet_to_port
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.utils.images import encode_png

    t_phase = time.perf_counter()
    unet = init_weights_(UNet(presets.get("iam").unet), seed=29, zero_init=False)
    ref_pt, port_pt = os.path.join(work, "ref_ema_ckpt.pt"), os.path.join(work, "port_ema.pt")
    ref = reference_layout(unet, seed=29)
    torch.save(ref, ref_pt)
    torch.save(unet.state_dict(), port_pt)
    n_ref = len(ref["state_dict"])
    with open(gt) as f:
        lines = f.readlines()[:B]
    gt16 = os.path.join(work, "words16.filter27")
    with open(gt16, "w") as f:
        f.writelines(lines)

    runs = {}
    for label, pt in (("reference", ref_pt), ("port", port_pt)):
        regen, samples = cli.build(regen_cli_args(cli, gt16, os.path.join(work, f"regen_{label}"),
                                                  "--torch_ckpt", pt))
        runs[label] = dict(regen=regen, counts=drive_regen(smi, regen, samples, seed=0,
                                                           label=f"29 {label} layout",
                                                           warm=False),
                           files=dump_files(regen.out_dir))
    a, b = runs["reference"]["regen"].sampler, runs["port"]["regen"].sampler
    sa, sb = a.model.state_dict(), b.model.state_dict()
    same_weights = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    words = [ln.split()[-1] for ln in lines]
    inputs = unet_inputs(a, words, phosc=False)
    with torch.no_grad():
        eps_a, eps_b = a.model(*inputs), b.model(*inputs)
    fa, fb = runs["reference"]["files"], runs["port"]["files"]
    same_pngs = fa.keys() == fb.keys() and all(fa[k] == fb[k] for k in fa)
    times = {"reference": [], "port": []}
    for r, label in enumerate(("reference", "port")):
        sampler = runs[label]["regen"].sampler
        gen = card_generator(300 + r)
        t0 = time.perf_counter()
        sampler.sample_async(words, list(range(B)), gen)[0].cpu()
        times[label].append(time.perf_counter() - t0)
    log(f"29 regeneration from a reference-layout checkpoint ({n_ref} tensors: middle_block1, "
        f"dead to_kv / attnc / norm1, state_dict wrapper) against the same weights in port keys: "
        f"weights bitwise {same_weights}, eps on a fixed input bitwise "
        f"{torch.equal(eps_a, eps_b)}, "
        f"{len(fa)} PNGs bitwise {same_pngs}; s/batch (drive) reference "
        f"{runs['reference']['counts']['s_per_batch']:.4f}, port "
        f"{runs['port']['counts']['s_per_batch']:.4f}; one batch each (reference, port): "
        f"{times} s [{smi}]")
    assert same_weights and torch.equal(eps_a, eps_b) and bool(torch.isfinite(eps_a).all())
    assert same_pngs and len(fa) == B, (len(fa), len(fb))
    ref_counts = runs["reference"]["counts"]
    s_per_batch = {k: v["counts"]["s_per_batch"] for k, v in runs.items()}
    del runs, a, b

    # (b) the train CLI's checkpoint directory, trained weights
    ckpt_dir = os.path.join(work, "run", "ckpt")
    newest = max(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
    saved = torch.load(os.path.join(ckpt_dir, str(newest), "state.pt"), map_location="cpu",
                       weights_only=True)
    regen, samples = cli.build(regen_cli_args(cli, corpus[0], os.path.join(work, "regen_ckpt_dir"),
                                              "--ckpt_dir", ckpt_dir, "--use_ema", "0",
                                              "--max_batches", "1"))
    got = regen.sampler.model.state_dict()
    assert all(torch.equal(got[k].cpu(), v) for k, v in saved["model"].items())
    assert len(got) == len(saved["model"])
    reset_counts()
    t0 = time.perf_counter()
    stats = regen.run(samples, batch_size=B, seed=0, max_batches=1)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    ckpt_counts = all_counts()
    log(f"29 regenerate --ckpt_dir {ckpt_dir} --use_ema 0 (step {newest}, trained weights "
        f"bitwise): {stats.generated} generated in {ckpt_s:.3f} s, launches {ckpt_counts} [{smi}]")
    per_batch = tuple(k * 120 + p for k, p in zip(
        (4, 8, *UNET_NORMS), (0, 0, DECODER_NORMS[0] + OCR_NORMS[0],
                              DECODER_NORMS[1] + OCR_NORMS[1])))
    assert stats.generated == B
    assert (ckpt_counts["ffn"], ckpt_counts["attn"], ckpt_counts["gn"],
            ckpt_counts["conv"]) == per_batch, (ckpt_counts, per_batch)
    del regen

    # (c) export to the reference layout and back
    out = os.path.join(work, "export_ref.pt")
    exported = export_reference.main(["--preset", "iam", "--ckpt_dir", ckpt_dir, "--out", out,
                                      "--middle_block1", "1"])
    back = reference_unet_to_port(torch.load(out, weights_only=True), presets.get("iam").unet)
    assert back.keys() == saved["ema"].keys()
    assert all(np.array_equal(back[k], saved["ema"][k].numpy()) for k in back)
    assert any(k.startswith("middle_block1.") for k in exported)
    log(f"29 export_reference --middle_block1 1 of step {newest}'s EMA: {len(exported)} "
        f"tensors, reloaded bitwise")

    # (d) the JPEG decoder: the check set bitwise, host ms per crop
    with np.load(CHECK_FILE) as z:
        n = sum(1 for k in z.files if k.startswith("name_"))
        files = [(str(z[f"name_{i}"]), z[f"jpeg_{i}"].tobytes(), z[f"rgb_{i}"]) for i in range(n)]
        made_by = str(z["pillow"])
    bad = [name for name, raw, want in files if not np.array_equal(decode_jpeg(raw, name), want)]
    log(f"29 jpeg_check.npz: {n - len(bad)} of {n} files decoded bitwise as {made_by} "
        f"decoded them; mismatches {bad}")
    assert not bad, bad
    crop = render_word("Mississippi", 64, 256, seed=0)
    samples_ms = {}
    timed = {"check 64x256 baseline 4:2:0 (noisy)": files[0][1],
             "check 64x256 progressive 4:2:0 (noisy)": files[4][1],
             "render 64x256 4:2:0 q75": encode_baseline(crop, factors=((2, 2), (1, 1), (1, 1))),
             "render 64x256 4:4:4 q95": encode_baseline(crop, quality=95)}
    for name, raw in timed.items():
        decode_jpeg(raw)
        t0 = time.perf_counter()
        for _ in range(20):
            decode_jpeg(raw)
        samples_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    png = encode_png(crop)
    t0 = time.perf_counter()
    for _ in range(20):
        decode_png(png)
    png_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"29 host ms per crop on this machine's CPU: JPEG decode "
        + ", ".join(f"{k} {v:.3f}" for k, v in samples_ms.items())
        + f"; PNG decode (render 64x256 rgb8) {png_ms:.3f} [{smi}]")

    # (e) evaluate over a directory of JPEG crops, and over the same crops as
    # PNGs. 256 files, so the per-image costs (decode, featurizers) outweigh
    # the CLI's fixed set-up (argument parsing, two model builds, ocr.pt)
    dirs = {"jpeg": os.path.join(work, "eval_jpeg"), "png": os.path.join(work, "eval_png")}
    eval_words = ("the of and to in is was that for it with as his on be at by had are but "
                  "from not this have which one were all they she you her").split()[:32]
    n_eval = 256
    encoded = {"jpeg": [], "png": []}
    for i, w in enumerate(eval_words):
        img = render_word(w, 64, 256, seed=i)
        encoded["jpeg"].append(encode_baseline(img, factors=((2, 2), (1, 1), (1, 1)),
                                               quality=75 + i % 20))
        encoded["png"].append(encode_png(img))
    for label, d in dirs.items():
        os.makedirs(d)
        for i in range(n_eval):
            name = f"{i:05d}_3_{eval_words[i % 32]}.{'jpg' if label == 'jpeg' else 'png'}"
            with open(os.path.join(d, name), "wb") as f:
                f.write(encoded[label][i % 32])
    load_dir, load_s = evaluate._load_dir, []

    def timed_load_dir(*a, **k):
        t0 = time.perf_counter()
        try:
            return load_dir(*a, **k)
        finally:
            load_s.append(time.perf_counter() - t0)

    evals = {}
    evaluate._load_dir = timed_load_dir
    try:
        evaluate.main(["--real_dir", dirs["png"], "--fake_dir", dirs["png"], "--ocr_ckpt",
                       ocr_dir, "--limit", "32", "--device", "cuda"])  # the first run's set-up
        for label in ("jpeg", "png"):
            load_s.clear()
            reset_counts()
            t0 = time.perf_counter()
            res = evaluate.main(["--real_dir", dirs[label], "--fake_dir", dirs[label],
                                 "--ocr_ckpt", ocr_dir, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            evals.setdefault(label, []).append(dict(
                res=res, counts=all_counts(), imgs_per_s=2 * n_eval / wall,
                load_ms=sum(load_s) / (2 * n_eval) * 1e3, rest_s=wall - sum(load_s)))
    finally:
        evaluate._load_dir = load_dir
    batches = -(-n_eval // 32)
    want_gn = STYLE_NORMS * 2 * batches + OCR_NORMS[0] * batches
    log(f"29 evaluate --ocr_ckpt {ocr_dir} over {n_eval} JPEG crops (real = fake), then "
        f"with the same crops as PNGs: JSON jpeg {evals['jpeg'][0]['res']}, png "
        f"{evals['png'][0]['res']}; images/s of the whole call (real + fake) jpeg "
        f"{[e['imgs_per_s'] for e in evals['jpeg']]}, png "
        f"{[e['imgs_per_s'] for e in evals['png']]}; loading ms per image jpeg "
        f"{[e['load_ms'] for e in evals['jpeg']]}, png {[e['load_ms'] for e in evals['png']]}; "
        f"the rest of the call (set-up, featurizers) s jpeg "
        f"{[e['rest_s'] for e in evals['jpeg']]}, png {[e['rest_s'] for e in evals['png']]}; "
        f"launches {evals['jpeg'][0]['counts']} [{smi}]")
    for e in evals["jpeg"] + evals["png"]:
        assert e["counts"] == only_groupnorm(want_gn), (e["counts"], want_gn)
        assert set(e["res"]) == {"fid_style_encoder", "ocr_exact_match"}, e["res"]
        assert all(v == v for v in e["res"].values())  # no NaN
    phase_s = time.perf_counter() - t_phase
    log(f"29 phase: {phase_s:.1f} s")
    keys = ("ffn", "attn", "fold", "gn", "conv", "geglu", "fold_b7", "probs")
    return dict(paths={"regenerate_reference_ckpt": dict({k: ref_counts[k] for k in keys},
                                                         ffn_bwd=0),
                       "regenerate_ckpt_dir": ckpt_counts,
                       "evaluate_jpeg": evals["jpeg"][0]["counts"]},
                s_per_batch=s_per_batch, turns=times, jpeg_ms=samples_ms, png_ms=png_ms,
                eval_imgs_per_s={k: [e["imgs_per_s"] for e in v] for k, v in evals.items()},
                eval_load_ms={k: [e["load_ms"] for e in v] for k, v in evals.items()},
                phase_s=phase_s)


def nest(flat: dict) -> dict:
    """{"a.b.c": leaf} -> nested dicts (the Flax trees the converters take)."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def zstd_rate(store) -> tuple[float, int]:
    """MB/s of ``utils.zstd`` over every zarr chunk of an OCDBT store (the
    decoded bytes over the decode time), and the bytes decoded."""
    from worddiffusion_tpu_torch.utils import zstd

    frames = [store.read(k) for k in store.keys() if not k.endswith("/.zarray")]
    t0 = time.perf_counter()
    n = sum(len(zstd.decompress(f)) for f in frames)
    return n / (time.perf_counter() - t0) / 1e6, n


def phase30_orbax(smi: str, work: str, cli, gt: str, corpus: tuple[str, str]) -> dict:
    """Phase 30: the JAX package's orbax checkpoints, read without JAX, orbax
    or zstandard (``train/orbax_check.npz``, the committed check set). (a)
    every set decoded bitwise to its expected arrays; the zstd decoder's MB/s
    on the narrow set's random chunks (Huffman-coded literals) and on the
    tiled full-width sets (long matches), the read time of the whole
    full-width ``iam`` TrainState; (b) ``cli.regenerate --ckpt_dir <iam orbax>
    --vae_ckpt <vae orbax> --ocr_ckpt <ocr orbax>`` on 16 words against the
    seed rule's weights written in the port's keys (``--torch_ckpt``,
    ``--vae_pt``, ``--ocr_pt``): every PNG and the UNet's eps on a fixed
    input bitwise, 4 / 8 / 9 / 12 B.1 / B.4 / B.5 / B.6 launches a UNet call,
    s/batch of both in turns; (c) ``cli.export_reference`` of the orbax
    directory, reloaded bitwise; (d) ``cli.train --loadPrev 1`` from the
    ``iam`` TrainState (step 8, zero moments) for 2 steps on phase 7's
    corpus: the restored step, parameters and moments, 4 B.1 and 4 B.3 a
    step; then ``ckpt/`` holds the JAX step and the port's, and
    ``read_unet`` reads the port's."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.cli import export_reference
    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.models.convert import (
        jax_ocr_to_torch, jax_unet_to_torch, jax_vae_to_torch, reference_unet_to_port,
        state_dict_to_torch,
    )
    from worddiffusion_tpu_torch.ops import ffn
    from worddiffusion_tpu_torch.train import orbax_check
    from worddiffusion_tpu_torch.train.checkpoint import locate, read_unet
    from worddiffusion_tpu_torch.train.orbax import read_orbax
    from worddiffusion_tpu_torch.utils.ocdbt import OcdbtStore

    t_phase = time.perf_counter()
    exp = presets.get("iam")
    # (a) the check set, bitwise; the decoder's rates
    dirs, expected, read_s = {}, {}, {}
    for name in orbax_check.SETS:
        dirs[name] = orbax_check.unpack(name, os.path.join(work, f"orbax_{name}"))
        expected[name] = orbax_check.expected(name)
        t0 = time.perf_counter()
        got = orbax_check.flatten(read_orbax(os.path.join(dirs[name], "ckpt")))
        read_s[name] = time.perf_counter() - t0
        want = expected[name]
        bad = sorted(k for k in want if k not in got or got[k].dtype != want[k].dtype
                     or got[k].tobytes() != want[k].tobytes())
        assert sorted(got) == sorted(want) and not bad, (name, bad[:5])
    rates = {}
    for name in ("narrow", "iam"):
        step = next(n for n in os.listdir(os.path.join(dirs[name], "ckpt")) if n.isdigit())
        rates[name] = zstd_rate(OcdbtStore(os.path.join(dirs[name], "ckpt", step, "default")))
    n_iam = sum(v.nbytes for v in expected["iam"].values())
    n_ema = sum(v.nbytes for k, v in expected["iam"].items() if k.startswith("ema_params."))
    log(f"30 orbax check set: {len(orbax_check.SETS)} sets decoded bitwise "
        f"({', '.join(f'{k} {len(v)} leaves' for k, v in expected.items())}); read_orbax s "
        + ", ".join(f"{k} {v:.3f}" for k, v in read_s.items())
        + f" (iam: the whole TrainState, {n_iam / 1e6:.1f} MB); zstd MB/s on this machine's "
        f"CPU: narrow random chunks (Huffman literals) {rates['narrow'][0]:.2f} over "
        f"{rates['narrow'][1]} bytes, tiled iam chunks (long matches) {rates['iam'][0]:.1f} "
        f"over {rates['iam'][1]} bytes; an iam EMA of real weights ({n_ema / 1e6:.1f} MB fp32, "
        f"Huffman-coded) would read in about {n_ema / 1e6 / rates['narrow'][0]:.1f} s [{smi}]")

    # (b) regeneration from the orbax directories against the same weights in port keys
    trees = {k: nest(v) for k, v in expected.items() if k != "narrow"}
    port = {"ema": state_dict_to_torch(jax_unet_to_torch(trees["iam"]["ema_params"], exp.unet)),
            "vae": state_dict_to_torch(jax_vae_to_torch(trees["vae"], exp.vae)),
            "ocr": state_dict_to_torch(jax_ocr_to_torch(trees["ocr"]))}
    files = {k: os.path.join(work, f"orbax_port_{k}.pt") for k in port}
    for k, sd in port.items():
        torch.save(sd, files[k])
    with open(gt) as f:
        lines = f.readlines()[:B]
    gt16 = os.path.join(work, "words16_orbax.filter27")
    with open(gt16, "w") as f:
        f.writelines(lines)
    ckpt = {k: os.path.join(dirs[k], "ckpt") for k in ("iam", "vae", "ocr")}
    sources = {"orbax": ("--ckpt_dir", ckpt["iam"], "--vae_ckpt", ckpt["vae"], "--ocr_ckpt",
                         ckpt["ocr"]),
               "port": ("--torch_ckpt", files["ema"], "--vae_pt", files["vae"], "--ocr_pt",
                        files["ocr"])}
    runs = {}
    for label, flags in sources.items():
        t0 = time.perf_counter()
        regen, samples = cli.build(regen_cli_args(cli, gt16, os.path.join(
            work, f"regen_orbax_{label}"), *flags))
        build_s = time.perf_counter() - t0
        runs[label] = dict(regen=regen, build_s=build_s, files=None,
                           counts=drive_regen(smi, regen, samples, seed=0, label=f"30 {label}",
                                              warm=False))
        runs[label]["files"] = dump_files(regen.out_dir)
    a, b = runs["orbax"]["regen"].sampler, runs["port"]["regen"].sampler
    for mod_a, mod_b in ((a.model, b.model), (a.vae, b.vae), (a.ocr_apply, b.ocr_apply)):
        sa, sb = mod_a.state_dict(), mod_b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    words = [ln.split()[-1] for ln in lines]
    inputs = unet_inputs(a, words, phosc=False)
    with torch.no_grad():
        eps_a, eps_b = a.model(*inputs), b.model(*inputs)
    fa, fb = runs["orbax"]["files"], runs["port"]["files"]
    same_pngs = fa.keys() == fb.keys() and all(fa[k] == fb[k] for k in fa)
    times = {"orbax": [], "port": []}
    for r, label in enumerate(("orbax", "port")):
        sampler = runs[label]["regen"].sampler
        gen = card_generator(400 + r)
        t0 = time.perf_counter()
        sampler.sample_async(words, list(range(B)), gen)[0].cpu()
        times[label].append(time.perf_counter() - t0)
    log(f"30 regenerate --ckpt_dir / --vae_ckpt / --ocr_ckpt on the orbax directories against "
        f"the seed rule's weights in port keys: UNet, VAE, OCR bitwise; eps on a fixed input "
        f"bitwise {torch.equal(eps_a, eps_b)}; {len(fa)} PNGs bitwise {same_pngs}; CLI build s "
        f"(weights read included) orbax {runs['orbax']['build_s']:.3f}, port "
        f"{runs['port']['build_s']:.3f}; s/batch (drive) orbax "
        f"{runs['orbax']['counts']['s_per_batch']:.4f}, port "
        f"{runs['port']['counts']['s_per_batch']:.4f}; one batch each (orbax, port): "
        f"{times} s [{smi}]")
    assert torch.equal(eps_a, eps_b) and bool(torch.isfinite(eps_a).all())
    assert same_pngs and len(fa) == B, (len(fa), len(fb))
    regen_counts = dict(runs["orbax"]["counts"])
    s_per_batch = {k: v["counts"]["s_per_batch"] for k, v in runs.items()}
    build_s = {k: v["build_s"] for k, v in runs.items()}
    del runs, a, b, sampler

    # (c) the export of the orbax directory, reloaded
    out = os.path.join(work, "export_orbax.pt")
    exported = export_reference.main(["--preset", "iam", "--ckpt_dir", ckpt["iam"], "--out", out])
    back = reference_unet_to_port(torch.load(out, weights_only=True), exp.unet)
    assert back.keys() == port["ema"].keys()
    assert all(np.array_equal(back[k], port["ema"][k].numpy()) for k in back)
    log(f"30 export_reference of the orbax iam TrainState's EMA: {len(exported)} tensors, "
        f"reloaded bitwise")

    # (d) resuming the JAX run: 2 steps on phase 7's corpus
    gt_train, cache = corpus
    args = train_cli.build_parser().parse_args([
        "--preset", "iam", "--gt_train", gt_train, "--latent_cache", cache, "--batch_size",
        str(TRAIN_B), "--epochs", "2", "--ckpt_every_epochs", "1", "--save_path", dirs["iam"],
        "--seed", "0", "--loadPrev", "1", "--device", "cuda"])
    trainer = train_cli.build(args)
    t0 = time.perf_counter()
    restored = trainer.ckpt.restore(trainer.init_state())
    restore_s = time.perf_counter() - t0
    want_p = jax_unet_to_torch(trees["iam"]["params"], exp.unet)
    opt = restored.optimizer.state_dict()["state"]
    assert restored.step == orbax_check.STEP, restored.step
    assert all(torch.equal(p.cpu(), torch.from_numpy(want_p[n]))
               for n, p in restored.model.named_parameters())
    assert all(st["step"].item() == orbax_check.STEP and not st["exp_avg"].any()
               and not st["exp_avg_sq"].any() for st in opt.values())
    assert len(opt) == len(want_p)
    reset_counts()
    t0 = time.perf_counter()
    state = trainer.run(epochs=2, resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = all_counts()
    steps = state.step - orbax_check.STEP
    log(f"30 train --loadPrev 1 from the orbax iam TrainState: restored step "
        f"{restored.step} (parameters and zero moments as written) in {restore_s:.3f} s, then "
        f"{steps} steps of B={TRAIN_B} to step {state.step} in {wall:.2f} s incl. a checkpoint "
        f"and a DDIM-50 preview; launches {train_counts} [{smi}]")
    assert steps == 2 and 2 * TRAIN_STEPS_PER_EPOCH == orbax_check.STEP + 2, steps
    assert train_counts["ffn_bwd"] == 4 * steps, train_counts
    assert train_counts["ffn"] == 4 * steps + 4 * 50, train_counts  # + the preview's 50 calls
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert trainer.ckpt.steps() == [state.step], trainer.ckpt.steps()
    # ckpt/ now holds the JAX step and the port's: every reader takes the port's
    ck_dir = os.path.join(dirs["iam"], "ckpt")
    assert locate(ck_dir)[:2] == (False, state.step), locate(ck_dir)
    assert locate(ck_dir, orbax_check.STEP)[:2] == (True, orbax_check.STEP)
    sd, ema = read_unet(ck_dir, cfg=exp.unet), state.ema.state_dict()
    assert sd.keys() == ema.keys() and all(torch.equal(sd[k], ema[k].cpu()) for k in ema)
    log(f"30 after the resume, ckpt/ holds orbax step {orbax_check.STEP} and port step "
        f"{state.step}: read_unet reads the port's EMA of step {state.step} bitwise")
    phase_s = time.perf_counter() - t_phase
    log(f"30 phase: {phase_s:.1f} s")
    return dict(paths={"regenerate_orbax": dict(regen_counts, ffn_bwd=0),
                       "train_resume_orbax": train_counts},
                rates={k: v[0] for k, v in rates.items()}, read_s=read_s,
                s_per_batch=s_per_batch, turns=times, build_s=build_s, phase_s=phase_s)


@contextlib.contextmanager
def random_init():
    """The Trainer's seeded initialisation with every layer random, the
    zero-initialised output convs too: from the first step the loss's
    gradient reaches every transformer block (with the zero convs it reaches
    them only from the third step)."""
    import functools

    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.train import loop

    with mock.patch.object(loop, "init_weights_", functools.partial(init_weights_,
                                                                    zero_init=False)):
        yield


def switch_run(smi: str, work: str, trainer, label: str, steps: int, timed: bool = False,
               **unet) -> dict:
    """``trainer``'s experiment with the UNet switches ``unet`` set, a new
    Trainer on its dataset (no previews) for ``steps`` steps from the same
    seeded, fully random weights: counts set to 0 just before the run and
    read just after, the attention's fast-mode launches and Function
    backwards apart; peak memory above the run's start; s/step (the epoch's
    wall time over its steps, host batch assembly included). ``timed``:
    then, on the run's state and its first batch, the step function alone:
    ms a step by CUDA events (the median of 3) and device busy ms of one
    step (``device_profile``)."""
    import torch

    from worddiffusion_tpu_torch.data.loader import epoch_batches
    from worddiffusion_tpu_torch.ops import attention, ffn
    from worddiffusion_tpu_torch.train.loop import Trainer
    from worddiffusion_tpu_torch.train.step import make_train_step

    exp = trainer.exp
    exp = exp.replace(unet=dataclasses.replace(exp.unet, **unet), train=dataclasses.replace(
        exp.train, save_path=os.path.join(work, label)))
    run = Trainer(exp, trainer.dataset, device="cuda", encode_fn=trainer.encode_fn)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    with random_init():
        state = run.run(epochs=1, max_steps=steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    counts = dict(all_counts(), attn_fast=attention.fast_launches)
    attn_bwd, ffn_bwd, gn_bwd = attention.bwd_calls, ffn.bwd_launches, norm_counts()[2]
    s_, n_ = run.epoch_seconds[0]
    assert state.step == steps, state.step
    params = [p.detach().clone() for p in state.model.parameters()]
    loss = torch.load(run.ckpt.path(steps), map_location="cpu",
                      weights_only=True)["metrics"]["loss"]
    step_ms = busy_ms = None
    if timed:
        step_fn = make_train_step(run.schedule, exp, run.encode_fn)
        batch = next(iter(epoch_batches(run.dataset, exp.data.batch_size, epoch=0,
                                        seed=exp.train.seed, map_fn=run._device_batch)))
        step_ms = cuda_ms(lambda: step_fn(state, batch), reps=3, warmup=0)
        busy_ms = device_profile(lambda: step_fn(state, batch), calls=1)["busy_ms"]
    log(f"{label}: {steps} steps of B={exp.data.batch_size} ({unet}), {s_ / n_:.4f} s/step, "
        f"peak memory above the run's start {peak / 2 ** 30:.3f} GiB; launches {counts}; "
        f"Function backwards: attention {attn_bwd}, B.3 {ffn_bwd}, B.5 {gn_bwd}; loss {loss:.6g}"
        + (f"; then the step alone {step_ms:.2f} ms by CUDA events, device busy {busy_ms:.2f} ms"
           if timed else "") + f" [{smi}]")
    assert n_ == steps, n_
    assert torch.isfinite(torch.tensor(loss)) and all(torch.isfinite(p).all() for p in params)
    assert (attn_bwd, gn_bwd) == (8 * steps, UNET_NORMS[0] * steps), (attn_bwd, gn_bwd)
    assert counts["fold"] == counts["fold_b7"] == counts["geglu"] == counts["probs"] == 0, counts
    del run, state
    return dict(counts=counts, attn_bwd=attn_bwd, params=params, peak_bytes=peak,
                s_per_step=s_ / n_, loss=loss, step_ms=step_ms, busy_ms=busy_ms)


def remat_pair(smi: str, work: str, trainer, label: str, steps: int = 2) -> dict:
    """Phase 31(c) for one trainer: ``steps`` steps with remat off, then on,
    from the same seed: the parameters bitwise equal; B.1 and B.4 forward
    launches doubled by the recompute (the checkpointed blocks' forward runs
    again in the backward), B.3, B.5, B.6 and the Function backwards
    unchanged."""
    import torch

    off = switch_run(smi, work, trainer, f"{label}_remat0", steps, True, remat=False)
    on = switch_run(smi, work, trainer, f"{label}_remat1", steps, True, remat=True)
    equal = all(torch.equal(a, b) for a, b in zip(off["params"], on["params"]))
    log(f"{label} remat: parameters after {steps} steps bitwise equal to remat off {equal}; "
        f"s/step {off['s_per_step']:.4f} off, {on['s_per_step']:.4f} on; the step alone "
        f"{off['step_ms']:.2f} / {on['step_ms']:.2f} ms, device busy {off['busy_ms']:.2f} / "
        f"{on['busy_ms']:.2f} ms off / on; peak memory {off['peak_bytes'] / 2 ** 30:.3f} GiB off, "
        f"{on['peak_bytes'] / 2 ** 30:.3f} GiB on [{smi}]")
    c0, c1 = off["counts"], on["counts"]
    assert c0["ffn"] == 4 * steps and c0["attn"] == 8 * steps, c0
    assert (c1["ffn"], c1["attn"]) == (2 * c0["ffn"], 2 * c0["attn"]), (c0, c1)
    assert all(c1[k] == c0[k] for k in ("ffn_bwd", "gn", "conv")) and c0["ffn_bwd"] == 4 * steps
    assert c0["attn_fast"] == c1["attn_fast"] == 0
    assert equal, f"{label}: the remat run's parameters differ from the run without it"
    assert off["loss"] == on["loss"], (off["loss"], on["loss"])
    assert on["peak_bytes"] < off["peak_bytes"], (on["peak_bytes"], off["peak_bytes"])
    for r in (off, on):
        del r["params"]
    return dict(off=off, on=on)


def phase31_switches(smi: str, work: str, cli, gt: str, words, corpus, default_eps,
                     pixel: dict) -> dict:
    """Phase 31: the UNet's last two switches. (b) ``fast_softmax=True`` at
    full width: one ``iam`` UNet call at B=16 against its all-plain fast
    version (8 B.4 launches, all in the fast mode) and against the default
    mode's eps on the same weights and inputs (phase 4's), the regeneration
    pipeline over one batch of 16 words, one Trainer step at B=128 (its
    backward through the plain fast recompute); (c) ``remat=True``: latent
    ``iam`` training at B=128 and pixel training at phase 23's batch, 2
    steps each against the same steps without it."""
    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import attention

    out = {}
    # (b) fast_softmax=True
    register_iam_preset("iam_fast", fast_softmax=True)
    regen, samples = cli.build(regen_cli_args(cli, gt, os.path.join(work, "regen_fast"),
                                              "--preset", "iam_fast"))
    sampler = regen.sampler
    assert sampler.model.cfg.fast_softmax is True and sampler.model.cfg.model_channels == 320
    init_weights_(sampler.model, seed=0, zero_init=False)  # phase 4's weights
    inputs = unet_inputs(sampler, words, phosc=False)
    reset_counts()
    with torch.no_grad():
        eps = sampler.model(*inputs)
    torch.cuda.synchronize()
    one_call = (attention.launches, attention.fast_launches)
    shift = (eps - default_eps).abs().max().item() / default_eps.abs().max().item()
    log(f"unet B={B} (iam fast_softmax): B.4 launches in one call {one_call[0]}, of them in the "
        f"fast mode {one_call[1]}; eps against the default mode's on the same weights and "
        f"inputs: max |diff| / max |eps| {shift:.6g} [{smi}]")
    assert one_call == (8, 8), one_call
    assert shift > 0, "fast_softmax=True gave the default mode's eps"
    unet = unet_check(smi, sampler.model, inputs, "iam fast_softmax")
    regen_fast = drive_regen(smi, regen, samples[:B], seed=0, label="iam fast_softmax",
                             warm=False)
    regen_fast["attn_fast"] = attention.fast_launches
    assert regen_fast["attn_fast"] == regen_fast["attn"] == 8 * 120, regen_fast
    del regen, sampler

    # the train CLI's trainer for the latent corpus (its dataset; its own
    # model is freed before the runs)
    gt_train, cache = corpus
    latent = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "iam", "--gt_train", gt_train, "--latent_cache", cache, "--batch_size",
        str(TRAIN_B), "--epochs", "1", "--save_path", os.path.join(work, "switches"),
        "--seed", "0", "--device", "cuda"]))
    latent.model = None
    train_fast = switch_run(smi, work, latent, "train_fast_softmax", 1, fast_softmax=True)
    c = train_fast["counts"]
    assert (c["ffn"], c["ffn_bwd"], c["attn"], c["attn_fast"]) == (4, 4, 8, 8), c
    del train_fast["params"]

    # (c) remat=True, latent B=128 and pixel space
    out["remat"] = remat_pair(smi, work, latent, "train")
    del latent
    crops, pgt = pixel["corpus"]
    px = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "iam", "--gt_train", pgt, "--iam_path", crops, "--latent", "0",
        "--batch_size", str(pixel["train_b"]), "--epochs", "1", "--save_path",
        os.path.join(work, "switches_pixel"), "--seed", "0", "--device", "cuda"]))
    px.model = None
    out["remat_pixel"] = remat_pair(smi, work, px, "train_pixel")
    del px
    gc.collect()
    torch.cuda.empty_cache()

    def path(counts):
        """A run's counts, the default-mode and the fast-mode B.4 launches apart."""
        return dict(counts, attn=counts["attn"] - counts["attn_fast"])

    regen_counts = {k: regen_fast[k] for k in ("ffn", "attn", "fold", "gn", "conv", "geglu",
                                               "fold_b7", "probs", "attn_fast")}
    out["paths"] = {
        "regenerate_fast_softmax": path(dict(regen_counts, ffn_bwd=0)),
        "train_fast_softmax": path(train_fast["counts"]),
        "train_remat": path(out["remat"]["on"]["counts"]),
        "train_pixel_remat": path(out["remat_pixel"]["on"]["counts"]),
    }
    out.update(unet=unet, regen=regen_fast, train_fast=train_fast, shift=shift)
    return out


TP_WORKER_FLAG = "--tp-worker"
# Parameters after 6 AdamW steps at lr 1e-4, the tensor-parallel run against
# the one-process run. Each rank's partials are summed in another order than
# one matmul's (bf16 products, fp32 sums), so gradients differ by rounding;
# AdamW's first updates are about lr * sign(g), so the few entries whose
# gradient is rounding noise on both sides may move by up to 2 lr a step
# however close the gradients. Each tensor on its own: the norm of its
# difference within a tenth of the norm of its movement in the one-process
# run (a tensor whose gradient is wrong, not rounded, differs by about its
# movement), and a tensor that run left unmoved equal; over all entries, 99%
# within lr / 10.
TP_KEY_REL, TP_P99_DIFF = 0.1, 1e-4 / 10
# Tensors whose gradient is 0 in exact arithmetic, so rounding noise in both
# runs, which AdamW turns into steps of up to lr: the character encoder's key
# bias (adding q . b to every score of a row leaves its softmax unchanged).
# Each entry within 2 lr x 6 steps of the one-process run.
TP_ZERO_GRAD, TP_ZERO_GRAD_DIFF = ("word_emb.attention.linear_key.bias",), 2 * 1e-4 * 6


def tp_param_check(got: dict, ref: dict, init: dict) -> dict:
    """``got`` (the gathered tensor-parallel state dict) against ``ref``
    (the one-process run's) after both moved from ``init``: per tensor
    |got - ref| / |ref - init| (2-norms), the largest three with their keys,
    the tensors left unmoved and the 99th percentile of every entry's
    |got - ref|. Raises AssertionError on a tensor beyond TP_KEY_REL, an
    unmoved tensor that differs, a TP_ZERO_GRAD entry beyond
    TP_ZERO_GRAD_DIFF, or a 99th percentile beyond TP_P99_DIFF."""
    import torch

    assert set(got) == set(ref) and all(got[k].shape == v.shape for k, v in ref.items())
    ratios, unmoved, zero_grad = {}, [], {}
    for k, v in ref.items():
        moved = (v.float() - init[k].float()).norm().item()
        diff = (got[k].float() - v.float()).norm().item()
        if k in TP_ZERO_GRAD:
            zero_grad[k] = ((got[k].float() - v.float()).abs().max().item(), diff / moved)
            assert zero_grad[k][0] <= TP_ZERO_GRAD_DIFF, (k, zero_grad[k])
        elif moved == 0:
            unmoved.append(k)
            assert diff == 0, f"{k}: the one-process run left it, tensor parallel moved it"
        else:
            ratios[k] = diff / moved
    diffs = torch.cat([(got[k].float() - v.float()).abs().flatten() for k, v in ref.items()])
    p99 = diffs.sort().values[int(0.99 * (diffs.numel() - 1))].item()
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
    bad = {k: r for k, r in ratios.items() if not r <= TP_KEY_REL}
    assert not bad, f"tensors beyond {TP_KEY_REL} of their movement: {bad}"
    assert p99 <= TP_P99_DIFF, p99
    return dict(worst=worst, unmoved=unmoved, p99=p99, max_diff=diffs.max().item(),
                tensors=len(ratios), zero_grad=zero_grad)


def record_shapes() -> dict:
    """Records the (M, inner) of every B.2 launch and the (B, H, Nq, Nk) of
    every B.4 launch from now on in this process (a wrapper around each
    launch function that notes the shape and calls it)."""
    from worddiffusion_tpu_torch.ops import attention, ffn

    seen = {"geglu": set(), "attn": set()}

    def wrap(fn, key, shape_of):
        def launch(*a, **kw):
            seen[key].add(shape_of(*a))
            return fn(*a, **kw)
        return launch

    ffn._launch_geglu = wrap(ffn._launch_geglu, "geglu",
                             lambda x, w1, b1, w2, b2: (x.numel() // x.shape[-1], w2.shape[-1]))
    attention._launch = wrap(attention._launch, "attn",
                             lambda q, k, *rest: (*q.shape[:3], k.shape[2]))
    return seen


def start_group(cmd, env, out_path: str):
    """``cmd`` as the leader of a new process group, its standard output
    and error into ``out_path`` (a file: two groups run at once, and a
    full pipe would stall one)."""
    with open(out_path, "w") as out:
        return subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)


def wait_group(proc, out_path: str, timeout: float) -> tuple[int, str]:
    """-> (returncode, output) of ``start_group``'s process; on the time
    limit every process of its group is killed, then it raises."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill_group(proc)
        raise
    with open(out_path) as f:
        return proc.returncode, f.read()


def kill_group(proc) -> None:
    """Every process of ``start_group``'s group, unless it has ended."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def tp_worker(work: str) -> int:
    """Phase 28's process, one of two that ``torchrun`` starts on the one card
    (gloo on CUDA tensors, ``WD_TORCH_SHARE_CARD=1``): the train CLI at
    ``--mesh_data 1 --mesh_model 2``, counts set to 0 before and read after
    the run; every replicated parameter against the other rank's; the
    gathered parameters for the parent; a max_steps stop and a resume; three
    profiled steps; then ``iam_fold`` under the same axis. Writes what it saw
    as JSON, one file a rank."""
    import torch
    import torch.distributed as dist

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.ops import attention
    from worddiffusion_tpu_torch.parallel.mesh import param_spec
    from worddiffusion_tpu_torch.parallel.tensor import gather_state_dict

    gt, cache = os.path.join(work, "train.filter27"), os.path.join(work, "latents.npz")
    shapes = record_shapes()

    def args(save: str, *extra: str, preset: str = "iam"):
        return train_cli.build_parser().parse_args([
            "--preset", preset, "--gt_train", gt, "--latent_cache", cache, "--mesh_data", "1",
            "--mesh_model", "2", "--batch_size", str(TRAIN_B), "--epochs", "2",
            "--ckpt_every_epochs", "2", "--preview_ddim", "2", "--save_path",
            os.path.join(work, save), "--seed", "0", "--device", "cuda", *extra])

    trainer = train_cli.build(args("tp_run"))
    mesh = trainer.mesh
    assert dist.get_backend() == "gloo" and (mesh.data, mesh.model) == (1, 2)
    reset_counts()
    state = trainer.run(epochs=2)
    torch.cuda.synchronize()
    counts = dict(all_counts(), attn_bwd=attention.bwd_calls, gn_bwd=norm_counts()[2],
                  conv_bwd=norm_counts()[3])

    replicated = 0
    for sd in (state.model.state_dict(), state.ema.state_dict()):
        for k, v in sd.items():
            if param_spec(k) is None:
                parts = [torch.empty_like(v) for _ in range(2)]
                dist.all_gather(parts, v.contiguous(), group=mesh.model_group)
                assert torch.equal(parts[0], parts[1]), f"replicated {k} differs across ranks"
                replicated += 1
    full = gather_state_dict(state.model.state_dict(), mesh)
    if mesh.rank == 0:
        torch.save(full, os.path.join(work, "tp_final.pt"))
    part = train_cli.build(args("tp_resume")).run(epochs=2, max_steps=3)
    resumed = train_cli.build(args("tp_resume", "--loadPrev", "1")).run(epochs=2, resume=True)
    diff = max((a - b).abs().max().item() for a, b in
               zip(resumed.model.parameters(), state.model.parameters()))
    prof = step_profile("", trainer, "tp", folds=0, ffn_bwd=0)

    register_iam_preset("iam_fold", attn_fold_context=True)
    fold = train_cli.build(args("tp_fold", "--epochs", "1", preset="iam_fold"))
    reset_counts()
    fold_state = fold.run(epochs=1)
    torch.cuda.synchronize()
    fold_counts = dict(all_counts(), attn_bwd=attention.bwd_calls)
    assert fold_state.step == 3 and all(bool(torch.isfinite(p).all())
                                        for p in fold_state.model.parameters())
    with open(os.path.join(work, f"tp_rank{mesh.rank}.json"), "w") as f:
        json.dump(dict(counts=counts, steps=state.step, part=part.step, resumed=resumed.step,
                       resume_diff=diff, replicated=replicated, busy_ms=prof["busy_ms"],
                       kernels=prof["kernels"], epoch_seconds=trainer.epoch_seconds,
                       fold_counts=fold_counts, fold_seconds=fold.epoch_seconds,
                       shapes={k: sorted(v) for k, v in shapes.items()}), f)
    dist.destroy_process_group()
    return 0


def phase28_tp_check(smi: str, tp: str, ref: dict, init: dict, one_s: float,
                     seconds: float) -> dict:
    """Phase 28: tensor parallel (``--mesh_model 2``) on the one card: two
    ranks under ``torchrun`` with gloo on CUDA tensors (started by
    ``phases25_28_32``); per rank and step 4 B.2 (the local GEGLU FFN, inner
    640) and 8 B.4 (2 local heads), no B.1 or B.3; B.5 / B.6 as one
    process; a bitwise resume; the replicated parameters bitwise equal
    across the ranks; the gathered parameters against ``ref``, the same run
    in one process (from ``init``); s/step against it; ``iam_fold`` under
    the same axis (B.8 on gathered weights)."""
    import torch

    got = []
    for r in range(2):
        with open(os.path.join(tp, f"tp_rank{r}.json")) as f:
            got.append(json.load(f))
    steps, preview = 6, 2
    c = got[0]["counts"]
    want = dict(ffn=0, ffn_bwd=0, geglu=4 * (steps + preview), attn=8 * (steps + preview),
                gn=UNET_NORMS[0] * (steps + preview) + DECODER_NORMS[0],
                conv=UNET_NORMS[1] * (steps + preview) + DECODER_NORMS[1],
                attn_bwd=8 * steps, gn_bwd=UNET_NORMS[0] * steps, conv_bwd=UNET_NORMS[1] * steps,
                fold=0, fold_b7=0, probs=0)
    fold_steps = 3
    want_fold = dict(ffn=0, ffn_bwd=0, geglu=4 * fold_steps, attn=0, fold=8 * fold_steps,
                     fold_b7=0, gn=UNET_NORMS[0] * fold_steps, conv=UNET_NORMS[1] * fold_steps,
                     probs=0, attn_bwd=0)
    s_per_step = [g["epoch_seconds"][1][0] / g["epoch_seconds"][1][1] for g in got]
    log(f"tensor parallel, 2 ranks on one card (gloo, torchrun, {seconds:.1f} s with the "
        f"processes' start, beside phase 25's): {got[0]['steps']} steps, launches per rank "
        f"{c}; iam_fold {got[0]['fold_counts']}; resume {got[0]['part']} -> "
        f"{got[0]['resumed']}, max param diff {max(g['resume_diff'] for g in got):.6g}; "
        f"{got[0]['replicated']} replicated tensors bitwise equal across the ranks; s/step "
        f"{s_per_step}; profiled device busy per rank "
        f"{[round(g['busy_ms'], 3) for g in got]} ms a step, {got[0]['kernels']:.0f} kernels "
        f"[{smi}]")
    # every shape B.2 and B.4 took on a rank was held against plain in
    # phases 3 and 8
    held = dict(geglu=set(GEGLU_SHAPES),
                attn={(b, HEADS, nq, nk) for b, nq, nk in ATTN_SHAPES} | set(TP_ATTN_SHAPES))
    log(f"tensor parallel shapes: B.2 (M, inner) {got[0]['shapes']['geglu']}, B.4 (B, H, Nq, "
        f"Nk) {got[0]['shapes']['attn']}")
    for g in got:
        assert g["steps"] == steps and g["counts"] == want, (g["counts"], want)
        assert g["fold_counts"] == want_fold, (g["fold_counts"], want_fold)
        assert g["part"] == 3 and g["resumed"] == steps and g["resume_diff"] == 0, g
        assert g["replicated"] > 0
        for key, seen in g["shapes"].items():
            unheld = {tuple(x) for x in seen} - held[key]
            assert seen and not unheld, f"{key} ran at shapes no phase checked: {unheld}"

    tp_sd = torch.load(os.path.join(tp, "tp_final.pt"), map_location="cuda")
    moved = torch.cat([(v - init[k]).abs().flatten() for k, v in ref.items()])
    log(f"tensor parallel vs one process, 6 steps: the one-process run moved the parameters by "
        f"up to {moved.max().item():.6g} (median {moved.median().item():.6g}); s/step tp "
        f"{s_per_step} vs one process {one_s:.4f} (the runs overlap on the card) [{smi}]")
    assert moved.median().item() > TP_P99_DIFF  # the steps moved most parameters
    check = tp_param_check(tp_sd, ref, init)
    log(f"tensor parallel vs one process, per tensor |diff| / |movement| (tol {TP_KEY_REL:g}) "
        f"over {check['tensors']} moved tensors, the largest "
        + ", ".join(f"{k} {r:.6g}" for k, r in check["worst"])
        + "; gradient 0 in exact arithmetic (max |diff| per entry, tol "
        f"{TP_ZERO_GRAD_DIFF:g}; |diff| / |movement|): "
        + ", ".join(f"{k} {d:.6g} {r:.6g}" for k, (d, r) in check["zero_grad"].items())
        + f"; {len(check['unmoved'])} unmoved tensors equal; every entry: max |diff| "
        f"{check['max_diff']:.6g}, 99th percentile {check['p99']:.6g} (tol {TP_P99_DIFF:g}) "
        f"[{smi}]")
    fold_s = got[0]["fold_seconds"][0][0] / got[0]["fold_seconds"][0][1]
    return dict(counts={k: v for k, v in c.items() if k in want},
                fold_counts={k: v for k, v in got[0]["fold_counts"].items() if k in want_fold},
                s_per_step=s_per_step, one_s_per_step=one_s, busy_ms=[g["busy_ms"] for g in got],
                kernels=got[0]["kernels"], max_diff=check["max_diff"], p99=check["p99"],
                worst_key_rel=check["worst"][0][1],
                fold_s_per_step=fold_s, seconds=seconds)


def phases25_28_32(smi: str, work: str, corpus: tuple[str, str]) -> dict:
    """Phases 25 (DDP at world size 1) and 28 (tensor parallel, two ranks)
    side by side: both process groups start together, each on its own copy
    of phase 25's short corpus; meanwhile this process runs the one-process
    run that both are held against (the same arguments, no process group),
    then phase 32 (its counts are this process's own). Every process they
    start is stopped before this returns or raises. -> each phase's result
    (``ddp``, ``tp``, ``chain``) and the paths' counts (``paths``)."""
    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.parallel.distributed import SHARE_CARD_ENV

    ddp, tp = os.path.join(work, "ddp"), os.path.join(work, "tp")
    short_corpus(ddp, corpus)
    short_corpus(tp, corpus)
    ports = [free_port()]
    while len(ports) < 2:  # one for each group's rendezvous
        ports += [p for p in [free_port()] if p not in ports]
    ddp_env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                   MASTER_ADDR="localhost", MASTER_PORT=str(ports[0]))
    tp_env = dict(os.environ, OMP_NUM_THREADS="4", **{SHARE_CARD_ENV: "1"})
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        tp_env.pop(k, None)
    script = os.path.abspath(__file__)
    cmds = {"ddp": ([sys.executable, script, DDP_WORKER_FLAG, ddp], ddp_env),
            "tp": ([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                    "--master_addr", "localhost", "--master_port", str(ports[1]), script,
                    TP_WORKER_FLAG, tp], tp_env)}
    outs = {k: os.path.join(work, f"{k}.log") for k in cmds}
    t0 = time.perf_counter()
    procs, seconds = {}, {}
    try:
        for k, (cmd, env) in cmds.items():
            procs[k] = start_group(cmd, env, outs[k])
        plain = train_cli.build(train_cli.build_parser().parse_args([
            "--preset", "iam", "--gt_train", os.path.join(tp, "train.filter27"),
            "--latent_cache", os.path.join(tp, "latents.npz"), "--batch_size", str(TRAIN_B),
            "--epochs", "2", "--ckpt_every_epochs", "2", "--preview_ddim", "2", "--save_path",
            os.path.join(work, "one_process"), "--seed", "0", "--device", "cuda"]))
        assert not plain.distributed
        init = {k: v.clone() for k, v in plain.init_state().model.state_dict().items()}
        ref = plain.run(epochs=2).model.state_dict()
        one_s = plain.epoch_seconds[1][0] / plain.epoch_seconds[1][1]
        del plain
        chain = phase32_chain(smi, work)
        for k, proc in procs.items():
            rc, out = wait_group(proc, outs[k], timeout=600)
            seconds[k] = time.perf_counter() - t0
            log(out[-3000:])
            phase = "25" if k == "ddp" else "28"
            assert rc == 0, f"phase {phase}'s {k} run failed (exit {rc}): {out[-6000:]}"
    finally:
        for proc in procs.values():
            kill_group(proc)
    out = dict(ddp=phase25_ddp_check(smi, ddp, ref, seconds["ddp"]),
               tp=phase28_tp_check(smi, tp, ref, init, one_s, seconds["tp"]), chain=chain)
    out["paths"] = {"train_ddp": out["ddp"]["counts"], "train_tp": out["tp"]["counts"],
                    "train_tp_iam_fold": out["tp"]["fold_counts"], **chain["paths"]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] not in ([DDP_WORKER_FLAG], [TP_WORKER_FLAG]):
        from worddiffusion_tpu_torch.ops import build  # no torch

        # the kernels compile (one nvcc a source) while phase 1 imports
        # torch and the port and starts the card
        builder = ThreadPoolExecutor(1)
        built = builder.submit(build.build)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU", file=sys.stderr)
        return 1
    if argv[:1] == [DDP_WORKER_FLAG]:
        return ddp_worker(argv[1])
    if argv[:1] == [TP_WORKER_FLAG]:
        return tp_worker(argv[1])

    from worddiffusion_tpu_torch.cli import regenerate as cli
    from worddiffusion_tpu_torch.generate.sample import phosc_ids
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.ops import ffn

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
    lib = built.result()
    builder.shutdown()
    log(f"build: {lib} in {time.perf_counter() - T_START:.2f} s from the run's start")

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

    for i, (m, d) in enumerate(FFN_WIDE_SHAPES):
        a = ffn_inputs(m, seed=20 + i, inner=4 * d, d=d)
        n0 = ffn.launches
        got, again = ffn.fused_ln_geglu_ffn(**a), ffn.fused_ln_geglu_ffn(**a)
        torch.cuda.synchronize()
        assert ffn.launches == n0 + 2, ffn.launches - n0
        want = ffn.ln_geglu_ffn_reference(**a)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = launch_ms(lambda: ffn.fused_ln_geglu_ffn(**a))
        plain_ms = launch_ms(lambda: ffn.ln_geglu_ffn_reference(**a))
        bound_ms, bound_by = ffn_bound(a, got)
        log(f"ffn M={m} d={d} inner={4 * d} (cluster of {ffn.cluster_size(m, 4 * d)}, plan "
            f"{ffn.plan(d)}): max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {FFN_REL_TOL}); "
            f"bitwise repeatable {torch.equal(got, again)}; kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
            f"bound [{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at d={d}"
        assert torch.equal(got, again), f"B.1 differs between two runs at M={m} d={d}"
        assert rel <= FFN_REL_TOL, f"kernel disagrees with plain at M={m} d={d}: rel {rel}"
        ffn_rows.append(dict(m=m, d=d, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
        del a, got, again, want

    geglu = phase3_geglu(smi)

    # The regeneration pipeline as the CLI builds it, on the card.
    work = tempfile.mkdtemp(prefix="wd_chip_smoke_")
    gt = os.path.join(work, "words.filter27")
    words = ("the of and to in is was that for it with as his on be at by had are "
             "but from not this have which one were all they she you her an there "
             "been their we him would so when more can said no").split()[:24]
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
    register_iam_preset("iam_fold", attn_fold_context=True)
    regen_fold = phase12_fold_regen(smi, cli, gt, work, words)

    stamp("12")
    # -- 34. channel_mult (1, 2): B.1 at d = 640 and B.4 at D = 160 on the main path ----------
    register_iam_preset("iam_wide", channel_mult=(1, 2))
    regen_wide = phase34_wide(smi, cli, gt, work, words)

    stamp("34")
    # -- 35. channel_mult (1, 2) training: B.3 at every width, the fold at C = 640 --------
    register_iam_preset("iam_wide_fold", channel_mult=(1, 2), attn_fold_context=True)
    wide35 = phase35_wide_train(smi, cli, gt, work, words, corpus)

    stamp("35")
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
    g_train = next(r for r in geglu["rows"] if r["m"] == TRAIN_B * 256 and r["inner"] == INNER)
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
    # -- 33. the host C pass, the denoiser's time by bucket, its roofline -------------------------
    host_tools = phase33_host_and_tools(smi)
    stamp("33")
    # -- 23, 24, 26, 27. pixel space, HiGAN+, attention maps, host data ----------------------
    new = new_phases(smi, work, cli, gt, words, corpus)
    px = new["pixel"]

    # -- 29. reference-layout and port checkpoints, the export, JPEG crops ---------------------
    ckpts = phase29_checkpoints(smi, work, cli, gt, corpus,
                                os.path.dirname(side["train_ocr"]["pt"]))
    stamp("29")
    # -- 30. the JAX package's orbax checkpoints: regeneration, export, resume ------------------
    orbax = phase30_orbax(smi, work, cli, gt, corpus)
    stamp("30")
    # -- 31. the last two UNet switches: fast_softmax=True and remat -----------------------------
    switches = phase31_switches(smi, work, cli, gt, words, corpus, unet["eps"], px)
    stamp("31")
    # -- 25, 28 and 32. DDP and tensor parallel in their own processes, the iam chain here ------
    par = phases25_28_32(smi, work, corpus)
    chain = par["chain"]
    stamp("25, 28 and 32")
    paths = ("regenerate", "regenerate_iam_phosc", "regenerate_iam_fold", "train",
             "train_iam_phosc", "train_iam_fold", "build_latent_cache", "train_from_images")
    # the paths of phases 18-20, each with its counts under chip_smoke's keys
    new_paths = {"regenerate_iam_wide": dict(
                     {k: regen_wide[k] for k in ("ffn", "attn", "fold", "gn", "conv", "geglu",
                                                 "fold_b7", "probs")}, ffn_bwd=0),
                 **{f"unet_{k}": dict(zip(("ffn", "attn", "fold", "gn", "conv"), v["counts"]),
                                      ffn_bwd=0, fold_b7=0, geglu=0, probs=v["probs"])
                    for k, v in variants.items()},
                 **{f"train_{k}": v for k, v in cond_train.items()},
                 **{k: dict(v, ffn_bwd=0) for k, v in sampled.items()},
                 **phosc["paths"], **side["paths"], **new["paths"], **par["paths"],
                 **ckpts["paths"],
                 **orbax["paths"], **switches["paths"], **wide35["paths"]}

    def by_path(*counts, key):
        """The earlier paths' counts in order, then the later paths' ``key``."""
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
    probs_paths = by_path(regen_iam["probs"], regen_phosc["probs"], regen_fold["probs"],
                          train["probs"], train_p["probs"], train_f["probs"], built["probs"],
                          train_i["probs"], key="probs")
    # B.4's fast mode (fast_softmax=True) runs on phase 31's paths alone; "attn"
    # counts the default mode's launches there
    fast_paths = {**dict.fromkeys(paths, 0),
                  **{p: c.get("attn_fast", 0) for p, c in new_paths.items()}}
    assert all(n == 0 for p, n in fast_paths.items() if "fast_softmax" not in p), fast_paths
    # the maps kernel runs on the return_attn paths alone
    assert all(n == 0 for p, n in probs_paths.items() if p not in new["maps"]["paths"]), probs_paths
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
        + f"; pixel: UNet call {px['unet']['ms']:.3f} ms (busy {px['unet']['busy_ms']:.3f} ms), "
        f"regen s/batch {px['regen']['s_per_batch']:.4f}, train B={px['train_b']} "
        f"{px['train']['s_per_step']:.4f} s/step (peak {px['train']['peak_bytes'] / 2 ** 30:.3f} "
        f"GiB); higan call B={B} {new['higan']['latent_ms']:.3f} ms, train "
        f"{new['higan']['s_per_step']:.4f} s/step; ddp world size 1 "
        f"{par['ddp']['s_per_step']:.4f} s/step; tensor parallel (2 ranks, one card) "
        f"{par['tp']['s_per_step']} s/step vs {par['tp']['one_s_per_step']:.4f} in one process"
        + f"; regen s/batch from the reference layout {ckpts['s_per_batch']['reference']:.4f} "
        f"vs port keys {ckpts['s_per_batch']['port']:.4f}; evaluate (256 crops) images/s over "
        f"JPEG {ckpts['eval_imgs_per_s']['jpeg']} vs PNG {ckpts['eval_imgs_per_s']['png']}, "
        f"loading ms/image JPEG {ckpts['eval_load_ms']['jpeg']} vs PNG "
        f"{ckpts['eval_load_ms']['png']}; JPEG "
        f"decode ms/crop " + ", ".join(f"{k} {v:.3f}" for k, v in ckpts["jpeg_ms"].items())
        + f"; zstd MB/s narrow (Huffman) {orbax['rates']['narrow']:.2f}, tiled iam (matches) "
        f"{orbax['rates']['iam']:.1f}; orbax iam TrainState read {orbax['read_s']['iam']:.3f} s; "
        f"regen s/batch from orbax {orbax['s_per_batch']['orbax']:.4f} vs port keys "
        f"{orbax['s_per_batch']['port']:.4f}"
        + f"; fast_softmax: UNet call {switches['unet']['ms']:.3f} ms, regen s/batch "
        f"{switches['regen']['s_per_batch']:.4f}, train step {switches['train_fast']['s_per_step']:.4f} "
        f"s; remat off / on: train B={TRAIN_B} {switches['remat']['off']['s_per_step']:.4f} / "
        f"{switches['remat']['on']['s_per_step']:.4f} s/step, peak "
        f"{switches['remat']['off']['peak_bytes'] / 2 ** 30:.3f} / "
        f"{switches['remat']['on']['peak_bytes'] / 2 ** 30:.3f} GiB; pixel B={px['train_b']} "
        f"{switches['remat_pixel']['off']['s_per_step']:.4f} / "
        f"{switches['remat_pixel']['on']['s_per_step']:.4f} s/step, peak "
        f"{switches['remat_pixel']['off']['peak_bytes'] / 2 ** 30:.3f} / "
        f"{switches['remat_pixel']['on']['peak_bytes'] / 2 ** 30:.3f} GiB"
        + f"; host C pass ms per batch of {TRAIN_B} (library / numpy) "
        + ", ".join(f"{k} {v['library']:.3f} / {v['numpy']:.3f}"
                    for k, v in host_tools["host_ms"].items())
        + f"; iam B={TRAIN_B} call {host_tools['profile']['measured_ms_per_call']:.3f} ms, device "
        f"{host_tools['profile']['device_leaf_total_ms_per_call']:.3f} ms"
        + f"; iam chain --smoke {chain['seconds']:.1f} s, resumed run {chain['again_s']:.2f} s, "
        + f"the split's six stages {chain['split_s']:.1f} s"
        + f"; whole run {time.perf_counter() - T_START:.1f} s")

    def entry(name, source, replaces, paths_, rows, row, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(paths_.values()), "launches_by_path": paths_,
                "max_abs_err": max(r["err"] for r in rows), "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": library_ms}

    rows_px = px["rows"]
    log(json.dumps({"kernels": [
        entry("ln_geglu_ffn", "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
              "worddiffusion_tpu/ops/ffn_pallas.py:48", ffn_paths,
              ffn_rows + bwd["fwd_rows"] + rows_px["ffn_rows"], main_row, None),
        entry("ln_geglu_ffn_bwd", "worddiffusion_tpu_torch/csrc/ln_geglu_ffn_bwd.cu",
              "worddiffusion_tpu/ops/ffn_pallas.py:397", bwd_paths,
              bwd["rows"] + rows_px["bwd_rows"] + wide35["bwd_rows"], bwd_row, None),
        entry("attention", "worddiffusion_tpu_torch/csrc/attention.cu",
              "bench_kernels/attention_pallas.py:25", attn_paths,
              attn["rows"] + rows_px["attn_rows"], attn_row, attn_row["library_ms"]),
        # B.4's fast mode (UNetConfig.fast_softmax=True: JAX's bf16 softmax order),
        # its launches apart from the default mode's
        dict(entry("attention_fast", "worddiffusion_tpu_torch/csrc/attention.cu",
                   "bench_kernels/attention_pallas.py:25", fast_paths,
                   attn["fast_rows"] + rows_px["attn_fast_rows"], attn["fast_rows"][0],
                   attn["fast_rows"][0]["library_ms"]), mode="fast"),
        # the maps kernel beside B.4 (return_attn): no TPU kernel of its own;
        # the JAX model forms the maps with XLA's softmax where it sows them
        entry("attention_probs", "worddiffusion_tpu_torch/csrc/attention.cu",
              "worddiffusion_tpu/models/attention.py:198", probs_paths, new["maps"]["rows"],
              new["maps"]["rows"][0], new["maps"]["rows"][0]["library_ms"]),
        entry("fold_attention", "worddiffusion_tpu_torch/csrc/fold_attention.cu",
              "bench_kernels/attn_fold_sublayer_pallas.py:100", fold_paths,
              fold["rows"] + wide35["fold_rows"], fold_row, None),
        # B.7: the same kernel through B.7's [B, C, H*L] folds; no path of the
        # port (or of the JAX package) calls that entry, as each path's count shows
        entry("fold_attention_flat", "worddiffusion_tpu_torch/csrc/fold_attention.cu",
              "bench_kernels/attn_fold_pallas.py:36", fold7_paths,
              fold["rows"] + wide35["fold_rows"], dict(fold_row, ms=fold_row["ms7"]), None),
        entry("groupnorm", "worddiffusion_tpu_torch/csrc/groupnorm.cu",
              "bench_kernels/groupnorm_pallas.py:26", gn_paths,
              norms["gn_rows"] + rows_px["gn_rows"], gn_row, gn_row["library_ms"]),
        entry("gn_silu_conv3x3", "worddiffusion_tpu_torch/csrc/gn_silu_conv3x3.cu",
              "bench_kernels/resblock_pallas.py:39", conv_paths,
              norms["conv_rows"] + rows_px["conv_rows"], conv_row, conv_row["library_ms"]),
        # B.2: the tensor-parallel FF's local GEGLU FFN (train_tp, at inner
        # 640); every other path read its count and asserted 0
        entry("geglu_ffn", "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
              "worddiffusion_tpu/ops/ffn_pallas.py:41", geglu_paths,
              geglu["rows"], geglu["rows"][0], None),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


CHAIN_EVALS = ("realfloor", "filtered", "unfilt", "accbal", "rejbal")


def phase32_chain(smi: str, work: str) -> dict:
    """The iam chain at ``--smoke`` from an empty runs directory, then again
    (every stage skipped), then the subsets and the five ``evaluate`` stages
    over a split of the ddim dump that stands in for a trained filter.
    -> its counts under ``paths``."""
    import numpy as np
    import torch

    from worddiffusion_tpu_torch.chains import run as chains

    runs = os.path.join(work, "chain_iam")
    argv = ["iam", "--runs_dir", runs, "--device", "cuda", "--smoke"]
    names = [s.name for s in chains.stages_of("iam")]
    reset_counts()
    t0 = time.perf_counter()
    first = chains.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = all_counts()
    assert [r["stage"] for r in first] == names, first
    assert not any(r["skipped"] for r in first), first
    for r in first:
        log(f"chain iam --smoke stage {r['stage']}: {r['seconds']:.2f} s, peak "
            f"{r['peak_bytes'] / 2 ** 30:.3f} GiB, launches {r['launches']} [{smi}]")
    for k in ("ffn", "ffn_bwd", "attn", "gn", "conv"):
        assert counts[k] > 0, f"the iam chain launched no {k} kernel: {counts}"
    assert counts["probs"] == counts["fold"] == counts["geglu"] == 0, counts
    n = int(chains.SMOKE["--vocab_size"]) * int(chains.SMOKE["--samples_per_word"])
    for f in ("ocr_syn/ocr.pt", "vae_syn/vae.pt", "demo_latent/ckpt/1/state.pt",
              "demo_latent/ckpt/1/ema_unet.pt", "phosc_syn3/best_params.pkl"):
        assert os.path.getsize(os.path.join(runs, f)) > 0, f
    with np.load(os.path.join(runs, "latents_demo.npz")) as z:
        assert len(z.files) == n, len(z.files)
        lat = z[z.files[0]]
        assert lat.shape == (8, 32, 4) and np.isfinite(lat).all(), lat.shape
    accepted = {}
    for d in ("regen_demo", "regen_full", "regen_ddim"):
        accepted[d] = sum(f.endswith(".png") for f in os.listdir(os.path.join(runs, d)))
    rejected = sum(f.endswith(".png")
                   for f in os.listdir(os.path.join(runs, "regen_ddim", "rejected")))
    assert accepted["regen_ddim"] + rejected == n, (accepted, rejected)
    evals = {}
    for k in CHAIN_EVALS:
        with open(os.path.join(runs, f"eval_fid_{k}.json")) as f:
            evals[k] = json.load(f)
        nums = [v for v in evals[k].values() if isinstance(v, (int, float))]
        assert all(np.isfinite(v) for v in nums), evals[k]
    assert "ocr_exact_match" in evals["filtered"], evals["filtered"]
    sizes = {d: len(os.listdir(os.path.join(runs, d)))
             for d in ("fid_floor_a", "fid_floor_b", "fid_unfilt", "fid_acc_bal", "fid_rej_bal")}
    log(f"chain iam --smoke: {seconds:.1f} s; accepted of {n} {accepted}, rejected (ddim) "
        f"{rejected}; subsets {sizes}; evaluate {evals}; counts {counts} [{smi}]")
    reset_counts()
    t0 = time.perf_counter()
    again = chains.main(argv)
    again_s = time.perf_counter() - t0
    assert [r["stage"] for r in again] == names and all(r["skipped"] for r in again), again
    assert not any(all_counts().values()), all_counts()
    log(f"chain iam --smoke again: every stage skipped in {again_s:.2f} s")
    # the untrained filter accepts none, so the subsets above are empty and
    # evaluate computes no FID: stand in for a trained filter with half the
    # ddim dump, then rerun the six stages that read it
    rej_dir = os.path.join(runs, "regen_ddim", "rejected")
    for f in sorted(f for f in os.listdir(rej_dir) if f.endswith(".png"))[::2]:
        os.rename(os.path.join(rej_dir, f), os.path.join(runs, "regen_ddim", f))
    rerun = ["subsets"] + [f"eval_{k}" for k in CHAIN_EVALS]
    for name in rerun:
        os.remove(os.path.join(runs, ".chains", "iam", f"{name}.done"))
    t0 = time.perf_counter()
    third = chains.main(argv)
    split_s = time.perf_counter() - t0
    assert [r["stage"] for r in third if not r["skipped"]] == rerun, third
    sizes = {d: len(os.listdir(os.path.join(runs, d)))
             for d in ("fid_floor_a", "fid_floor_b", "fid_unfilt", "fid_acc_bal", "fid_rej_bal")}
    assert all(v > 1 for v in sizes.values()), sizes
    for k in CHAIN_EVALS:
        with open(os.path.join(runs, f"eval_fid_{k}.json")) as f:
            evals[k] = json.load(f)
        assert np.isfinite(evals[k].get("fid_phosc", np.nan)), (k, evals[k])
    log(f"chain iam --smoke, half the ddim dump accepted: {split_s:.1f} s; subsets {sizes}; "
        f"evaluate {evals} [{smi}]")
    return {"paths": {"chain_iam": counts}, "seconds": seconds, "again_s": again_s,
            "split_s": split_s}


def new_phases(smi: str, work: str, cli, gt: str, words, corpus) -> dict:
    """Phases 23, 24, 26 and 27, each path's counts under its key
    (``paths``)."""
    out = {}
    out["pixel"] = phase23_pixel(smi, work, cli, gt, words)
    stamp("23")
    out["higan"] = phase24_higan(smi, work, cli, gt, corpus)
    stamp("24")
    # 25 and 28 run last, beside 32 (``phases25_28_32``)
    out["maps"] = phase26_maps(smi, words)
    stamp("26")
    out["host"] = phase27_host(smi, work)
    stamp("27")
    px, hg = out["pixel"], out["higan"]
    out["paths"] = {
        "regenerate_pixel": dict(zip(("ffn", "attn", "fold", "gn", "conv"),
                                     (px["regen"][k] for k in ("ffn", "attn", "fold", "gn",
                                                               "conv"))),
                                 ffn_bwd=0, fold_b7=px["regen"]["fold_b7"],
                                 geglu=px["regen"]["geglu"], probs=px["regen"]["probs"]),
        "train_pixel": px["train"]["counts"], "sample_pixel": px["sample"],
        "train_higan": hg["train"],
        "regenerate_higan": dict(hg["regen"], ffn_bwd=0), "sample_higan": hg["sample"],
        **out["maps"]["paths"],
    }
    return out


if __name__ == "__main__":
    sys.exit(main())
