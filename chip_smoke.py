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
4. whole UNet: one full-width ``iam`` UNet call with the kernel and with
   the plain FF (``use_pallas_ffn=False``) on the same weights and inputs.
5. main path: the regeneration CLI's pipeline (Regenerator + WordSampler,
   ``iam`` UNet, default VAE and CTC recognizer, seeded random weights)
   over 40 words in batches of 16, with the 600-step skip-step schedule
   and the deterministic update; checks shapes, finiteness, the PNGs and
   that every FF sub-layer went through the kernel.
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
   the plain FF.

The second-to-last line is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

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
        log(f"ffn fwd M={m}: max_abs_err {err:.6g} max_rel_err {rel:.6g} (tol {FFN_REL_TOL}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at M={m}"
        assert rel <= FFN_REL_TOL, f"forward kernel disagrees with plain at M={m}: rel {rel}"
        fwd_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms))
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
        log(f"ffn bwd M={m}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{smi}]")
        rows.append(dict(m=m, err=max(errs), ms=ms, plain_ms=plain_ms))

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


def phase7_train(smi: str, work: str) -> dict:
    """The training main path as the train CLI builds it."""
    import dataclasses

    import torch

    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.ops import ffn
    from worddiffusion_tpu_torch.train.checkpoint import CheckpointManager
    from worddiffusion_tpu_torch.train.loop import Trainer
    from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer

    n = TRAIN_B * TRAIN_STEPS_PER_EPOCH + TRAIN_B // 2  # a half batch to drop_remainder
    gt, cache = write_latent_corpus(work, n)
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
    preview_launches = []
    preview = trainer.preview_fn

    def counted_preview(state, epoch):
        n0 = ffn.launches
        imgs = preview(state, epoch)
        preview_launches.append(ffn.launches - n0)
        assert imgs.shape == (3, 64, 256, 3) and bool((imgs >= 0).all() & (imgs <= 1).all())
        return imgs

    trainer.preview_fn = counted_preview
    initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}

    ffn.launches = ffn.bwd_launches = 0
    t0 = time.perf_counter()
    state = trainer.run(epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = ffn.launches, ffn.bwd_launches

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
        f"{preview_launches} forward in previews; max param change {max(changed.values()):.4g}; "
        f"EMA == params: {ema_equal}")
    assert state.step == steps, state.step
    assert sorted(ck.steps()) == [TRAIN_STEPS_PER_EPOCH, steps], ck.steps()
    assert torch.isfinite(torch.tensor(loss)), loss
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert all(changed[k] > 0 for k in ff_keys) and len(ff_keys) == 8, ff_keys
    assert ema_equal, "the EMA must equal the parameters during warmup"
    assert bwd == 4 * steps, bwd
    assert preview_launches == [4 * 50] * 2, preview_launches
    assert fwd - sum(preview_launches) == 4 * steps, fwd
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
    return dict(fwd=fwd, bwd=bwd, s_per_step=k_s / k_n, plain_s_per_step=p_s / p_n,
                resume_diff=diff)


def png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", path
    return struct.unpack(">II", head[16:24])  # width, height


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU", file=sys.stderr)
        return 1

    from worddiffusion_tpu_torch.cli import regenerate as cli
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.unet import UNet
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
    dev = torch.device("cuda")

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
        log(f"ffn M={m} d={D} inner={INNER}: max_abs_err {err:.6g} max_rel_err {rel:.6g} "
            f"(tol {FFN_REL_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms [{smi}]")
        assert bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at M={m}"
        assert rel <= FFN_REL_TOL, f"kernel disagrees with plain at M={m}: rel {rel}"
        ffn_rows.append(dict(m=m, err=err, ms=ms, plain_ms=plain_ms))

    # The regeneration pipeline as the CLI builds it, on the card.
    work = tempfile.mkdtemp(prefix="wd_chip_smoke_")
    gt = os.path.join(work, "words.filter27")
    words = ("the of and to in is was that for it with as his on be at by had are "
             "but from not this have which one were all they she you her an there "
             "been their we him would so when more can said no").split()[:40]
    with open(gt, "w") as f:
        for i, w in enumerate(words):
            f.write(f"{i % 7:03d},a01-{i:03d}u-00 {w}\n")
    dump = os.path.join(work, "regen")
    args = cli.build_parser().parse_args([
        "--gt_file", gt, "--dump_path", dump, "--batch_size", str(B),
        "--keep_rejected", "1", "--seed", "0",
    ])
    regen, samples = cli.build(args)
    sampler = regen.sampler
    unet = sampler.model
    # every kernel random, the zero-initialised output convs too, so each FF
    # sub-layer reaches eps
    init_weights_(unet, seed=0, zero_init=False)

    # -- 4. whole UNet: kernel vs plain FF ---------------------------------
    plain = UNet(dataclasses.replace(unet.cfg, use_pallas_ffn=False)).to(dev).eval()
    plain.load_state_dict(unet.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, 8, 32, 4, generator=g).to(dev)
    t = torch.tensor([599, 400, 200, 10] * (B // 4), device=dev)
    ctx = torch.from_numpy(sampler.tokenizer.encode_batch(words[:B])).long().to(dev)
    wid = torch.arange(B, device=dev)
    with torch.no_grad():
        n0 = ffn.launches
        eps_k = unet(x, t, ctx, wid)
        n_ff = ffn.launches - n0
        eps_p = plain(x, t, ctx, wid)
        unet_err = (eps_k - eps_p).abs().max().item()
        unet_rel = unet_err / eps_p.abs().max().item()
        unet_ms = cuda_ms(lambda: unet(x, t, ctx, wid), reps=10)
        plain_unet_ms = cuda_ms(lambda: plain(x, t, ctx, wid), reps=10)
    log(f"unet B={B} (iam, {unet.cfg.model_channels} ch): eps max_abs_err {unet_err:.6g} "
        f"max_rel_err {unet_rel:.6g} (tol {UNET_REL_TOL}); FF launches per call {n_ff}; "
        f"call {unet_ms:.3f} ms, plain-FF call {plain_unet_ms:.3f} ms [{smi}]")
    assert n_ff == 4, n_ff
    assert bool(torch.isfinite(eps_k).all()), "non-finite eps"
    assert unet_rel <= UNET_REL_TOL, f"UNet kernel vs plain: rel {unet_rel}"
    del plain

    # -- 5. main path ------------------------------------------------------
    checks = []
    decode = sampler.decode

    def checked_decode(lat):
        img, ids = decode(lat)
        checks.append((torch.isfinite(lat).all(), tuple(img.shape), img.dtype,
                       tuple(ids.shape), ids.dtype))
        return img, ids

    sampler.decode = checked_decode
    calls = int(sampler.call_mask[1:].sum())
    warm = torch.Generator(device=dev).manual_seed(123)
    sampler.sample_async(words[:B], list(range(B)), warm)[0].cpu()  # warm-up batch
    checks.clear()

    ffn.launches = 0
    t0 = time.perf_counter()
    stats = regen.run(samples, batch_size=B, seed=args.seed)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ffn.launches

    n_batches = -(-len(samples) // B)
    log(f"regen: {stats.generated} generated, {stats.accepted} accepted, {n_batches} batches "
        f"of {B}, {calls} denoiser calls each; {elapsed / n_batches:.3f} s/batch, "
        f"{stats.generated / elapsed:.2f} imgs/s (incl. PNG writes) [{smi}]")
    log(f"ffn kernel launches in the main path: {launches} "
        f"(expect {n_ff} x {calls} x {n_batches} = {n_ff * calls * n_batches})")
    assert calls == 120, calls
    assert launches == n_ff * calls * n_batches, launches
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

    # -- 6. FFN forward + backward: kernel vs plain -------------------------
    bwd = phase6_ffn_backward(smi)

    # -- 7. training main path -----------------------------------------------
    train = phase7_train(smi, work)

    main_row, bwd_row = ffn_rows[0], bwd["rows"][0]
    log(json.dumps({"kernels": [{
        "name": "ln_geglu_ffn",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
        "replaces": "worddiffusion_tpu/ops/ffn_pallas.py:48",
        "launches": launches + train["fwd"],
        "launches_by_path": {"regenerate": launches, "train": train["fwd"]},
        "max_abs_err": max(r["err"] for r in ffn_rows + bwd["fwd_rows"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }, {
        "name": "ln_geglu_ffn_bwd",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/ln_geglu_ffn_bwd.cu",
        "replaces": "worddiffusion_tpu/ops/ffn_pallas.py:397",
        "launches": train["bwd"],
        "launches_by_path": {"train": train["bwd"]},
        "max_abs_err": max(r["err"] for r in bwd["rows"]),
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
