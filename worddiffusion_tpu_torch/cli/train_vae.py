"""AutoencoderKL trainer (port of ``worddiffusion_tpu/cli/train_vae.py``):
a latent codec trained in-repo for runs without the SD checkpoint.

    python -m worddiffusion_tpu_torch.cli.train_vae --synthetic 1 --epochs 150 \\
        --save_dir ./runs/vae [--device cpu]

The preset's ``VAEConfig`` (SD's published widths by default) trained on
L1 + MSE + ``kl_weight`` x KL with ``torch.optim.AdamW`` at optax.adamw's
defaults and weight decay 1e-5, the posterior sampled with a seeded
``torch.Generator``. Its GroupNorms run kernel B.5 and its GN -> SiLU ->
conv3x3 prologues kernel B.6 on the card, forward and backward (their
Functions). ``vae.pt``, the full state dict in the port's keys (written at
``--save_every_epochs`` and at the end), is the ``--vae_pt`` of the cache,
train and regeneration CLIs (the JAX CLI writes an orbax checkpoint, which
their ``--vae_ckpt`` reads).
``recon_grid.png`` (held-out renders beside their reconstructions) is
written with ``utils.images.encode_png``; ``metrics.json`` has the JAX
CLI's keys. Without ``--gt_train``, or with ``--synthetic 1``, the corpus
is rendered by ``data.synthetic.render_word``; so is a missing crop.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    from ..configs import presets

    p = argparse.ArgumentParser(description="AutoencoderKL trainer")
    p.add_argument("--preset", default="iam", choices=sorted(presets.PRESETS))
    p.add_argument("--gt_train", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--kl_weight", type=float, default=1e-6)
    p.add_argument("--save_dir", default="./runs/vae")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--langs", default="eng",
                   help="comma-separated synthetic word-list languages (eng,nor,gw); each "
                        "contributes --vocab_size words so one codec covers every preset's "
                        "alphabet")
    p.add_argument("--vocab_size", type=int, default=100)
    p.add_argument("--samples_per_word", type=int, default=8)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--save_every_epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def vae_loss(vae, imgs: torch.Tensor, kl_weight: float, noise=None, generator=None):
    """-> (loss, mse, kl): L1 + MSE of the reconstruction (fp32) plus
    ``kl_weight`` x the mean KL to the unit normal."""
    recon, mean, logvar = vae(imgs, noise=noise, generator=generator)
    l1 = torch.mean(torch.abs(recon - imgs))
    mse = torch.mean((recon - imgs) ** 2)
    kl = -0.5 * torch.mean(1 + logvar - mean ** 2 - torch.exp(logvar))
    return l1 + mse + kl_weight * kl, mse, kl


def make_optimizer(vae, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=1e-5): b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.AdamW(vae.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-5)


def train_step(vae, optimizer, imgs, kl_weight: float, noise=None, generator=None):
    """One AdamW step; -> (loss, mse, kl), on the device."""
    loss, mse, kl = vae_loss(vae, imgs, kl_weight, noise, generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach(), mse.detach(), kl.detach()


def _save(vae, path: str) -> None:
    torch.save({k: v.cpu() for k, v in vae.state_dict().items()}, path + ".tmp")
    os.replace(path + ".tmp", path)


def heldout_eval(vae, h: int, w: int, device: torch.device, save_dir: str) -> tuple:
    """The held-out reconstruction of 8 word renders at unseen seeds: writes
    ``recon_grid.png`` (original | reconstruction strips) into ``save_dir``.
    -> (MSE in [-1, 1], PSNR in dB on the [0, 1] scale)."""
    from ..data.synthetic import render_word, word_list
    from ..utils.images import encode_png, normalize_to_unit

    probe = np.stack([render_word(wd, h, w, seed=77_000_000 + i)
                      for i, wd in enumerate(word_list(8))])
    probe_np = normalize_to_unit(probe)
    with torch.no_grad():
        recon, _, _ = vae(torch.from_numpy(probe_np).to(device),
                          generator=torch.Generator(device=device).manual_seed(1))
    recon = recon.float().cpu().numpy()
    eval_mse = float(np.mean((recon - probe_np) ** 2))
    eval_psnr = -10.0 * float(np.log10(max(eval_mse / 4.0, 1e-10)))
    strip = np.concatenate([np.concatenate([o, r], axis=1)
                            for o, r in zip(probe_np, np.clip(recon, -1, 1))], axis=0)
    with open(os.path.join(save_dir, "recon_grid.png"), "wb") as f:
        f.write(encode_png(((strip + 1) * 127.5).astype(np.uint8)))
    return eval_mse, eval_psnr


def main(argv=None):
    """-> {"vae", "metrics", "epoch_seconds"} (each epoch's seconds a step,
    host batches included, the checkpoint write not); writes vae.pt,
    recon_grid.png, metrics.json."""
    from ..configs import presets
    from ..data.gt import parse_gt
    from ..data.png import read_image
    from ..data.synthetic import render_word, stable_seed, synthetic_corpus, word_list
    from ..models.layers import init_weights_
    from ..models.vae import AutoencoderKL
    from ..utils.images import normalize_to_unit, resize_and_pad

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    exp = presets.get(args.preset)
    if args.synthetic or not args.gt_train:
        words: list[str] = []
        for lang in args.langs.split(","):
            words.extend(w for w in word_list(args.vocab_size, lang.strip()) if w not in words)
        samples = synthetic_corpus(words=words, samples_per_word=args.samples_per_word)
    else:
        samples, _ = parse_gt(args.gt_train)
    h, w = exp.data.img_height, exp.data.img_width

    def load(s) -> np.ndarray:
        path = os.path.join(args.image_dir, s.image) if args.image_dir else ""
        if path and os.path.exists(path):
            arr = read_image(path)
        else:
            arr = render_word(s.word, h, w, seed=stable_seed(s.image))
        return resize_and_pad(arr, h, w)

    logging.info("rendering %d training images once (uint8 cache)", len(samples))
    images = np.stack([load(s) for s in samples])  # uint8 [N, H, W, 3]

    vae = init_weights_(AutoencoderKL(exp.vae, with_encoder=True), seed=args.seed)
    vae = vae.to(device, memory_format=torch.channels_last)
    logging.info("VAE params: %.1fM", sum(p.numel() for p in vae.parameters()) / 1e6)
    optimizer = make_optimizer(vae, args.lr)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    ckpt = os.path.join(args.save_dir, "vae.pt")
    np_rng = np.random.default_rng(args.seed)
    gstep, last_mse, epoch_seconds = 0, float("nan"), []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        order = np_rng.permutation(len(images))
        for start in range(0, len(images) - args.batch_size + 1, args.batch_size):
            idx = order[start:start + args.batch_size]
            imgs = torch.from_numpy(normalize_to_unit(images[idx])).to(device)
            loss, mse, kl = train_step(vae, optimizer, imgs, args.kl_weight, generator=generator)
            if gstep % args.log_every == 0:
                last_mse = float(mse)
                # imgs are in [-1,1]; PSNR on the [0,1] scale
                psnr = -10.0 * np.log10(max(last_mse / 4.0, 1e-10))
                logging.info("step %d loss %.4f recon-mse %.5f psnr %.1fdB kl %.2f",
                             gstep, float(loss), last_mse, psnr, float(kl))
            gstep += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steps = (len(images) - args.batch_size) // args.batch_size + 1
        epoch_seconds.append((time.perf_counter() - t0) / max(steps, 1))
        if (epoch + 1) % args.save_every_epochs == 0 or epoch == args.epochs - 1:
            _save(vae, ckpt)

    eval_mse, eval_psnr = heldout_eval(vae, h, w, device, args.save_dir)
    metrics = {"train_mse_last": last_mse, "heldout_mse": eval_mse,
               "heldout_psnr_db": eval_psnr, "steps": gstep, "train_images": len(images)}
    with open(os.path.join(args.save_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    logging.info("saved VAE to %s (held-out recon PSNR %.1f dB)", ckpt, eval_psnr)
    return dict(vae=vae, metrics=metrics, epoch_seconds=epoch_seconds)


if __name__ == "__main__":
    main()
