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
# bf16 keeps 8 significant bits (one rounding = 0.4% of a value). The kernel
# keeps the [M, 2*inner] hidden in fp32 where the plain version rounds the
# matmul output to bf16, so the two differ by a few ulps of the output.
FFN_REL_TOL = 1e-2
# One such difference per FF sub-layer (4 per call), carried through the
# bf16 layers after it: bound the eps difference at 3% of max |eps|.
UNET_REL_TOL = 3e-2


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

    main_row = ffn_rows[0]
    log(json.dumps({"kernels": [{
        "name": "ln_geglu_ffn",
        "route": "cuda",
        "source": "worddiffusion_tpu_torch/csrc/ln_geglu_ffn.cu",
        "replaces": "worddiffusion_tpu/ops/ffn_pallas.py:48",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in ffn_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
