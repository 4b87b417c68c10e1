"""Latent-cache CLI (port of
``worddiffusion_tpu/cli/build_latent_cache.py``): one VAE-encode pass over
a corpus of word crops on one GPU -> npz cache of ``image name -> [8, 32,
4]`` latents, which the train CLI's ``--latent_cache`` reads.

    python -m worddiffusion_tpu_torch.cli.build_latent_cache \\
        --gt_train ./gt/train.filter27 --iam_path ./crops \\
        --stable_dif_path ./vae.safetensors --out ./latents.npz

The VAE comes from a diffusers ``--stable_dif_path`` safetensors file or
a full ``--vae_pt`` state dict in the port's keys, or is seeded random
with a warning. Without ``--gt_train``, or with ``--synthetic 1``, the
corpus is the synthetic one (``--vocab_size`` words of the preset's list,
``--samples_per_word`` renders each), drawn by ``data.synthetic.render_word``
(in each writer's style with ``--writer_styled 1``, the cache a
``--wrdChrWrStyl`` training needs); so is any crop missing from
``--iam_path``. ``--vae_ckpt`` names ``cli.train_vae``'s ``--save_dir``
(its ``vae.pt``) or the JAX CLI's orbax ``<save_dir>/ckpt``
(``train.checkpoint.side_weights``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def build_parser() -> argparse.ArgumentParser:
    from ..configs import presets

    p = argparse.ArgumentParser(description="worddiffusion latent cache (PyTorch/CUDA)")
    p.add_argument("--preset", default="iam", choices=sorted(presets.PRESETS))
    p.add_argument("--gt_train", default="")
    p.add_argument("--iam_path", default="", help="word-crop image dir (PNG or JPEG)")
    p.add_argument("--stable_dif_path", default="", help="diffusers VAE (safetensors)")
    p.add_argument("--vae_ckpt", default="",
                   help="cli.train_vae's --save_dir (its vae.pt), or the JAX CLI's "
                        "orbax <save_dir>/ckpt")
    p.add_argument("--vae_pt", default="", help="full VAE state dict in the port's keys")
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--deterministic", type=int, default=0,
                   help="1: store the posterior mean instead of a sample")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--vocab_size", type=int, default=10)
    p.add_argument("--samples_per_word", type=int, default=8)
    p.add_argument("--writer_styled", type=int, default=0,
                   help="1: synthetic renders use per-writer styles "
                        "(required for a --wrdChrWrStyl training cache)")
    p.add_argument("--seed", type=int, default=0, help="seed of the posterior samples")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def build(args):
    """Everything but the pass: -> (dataset, VAE on the device)."""
    import torch

    from ..configs import presets
    from ..data.dataset import WordImageDataset
    from ..data.tokenizer import Tokenizer
    from ..models.vae import make_vae
    from ..models.convert import jax_vae_to_torch
    from ..train.checkpoint import side_weights
    from .train import corpus

    device = torch.device(args.device)
    exp = presets.get(args.preset)
    vae_sd = side_weights(args.vae_pt, args.vae_ckpt, "--vae_ckpt", "vae.pt",
                          lambda t: jax_vae_to_torch(t, exp.vae))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    exp = exp.replace(data=dataclasses.replace(exp.data, image_dir=args.iam_path))
    samples, registry = corpus(args, exp)
    tok = Tokenizer.from_name(exp.data.alphabet, exp.data.max_chars)
    dataset = WordImageDataset(samples, registry, tok, exp.data,
                               writer_styled=bool(args.writer_styled))
    vae = make_vae(exp.vae, args.stable_dif_path, vae_sd, with_encoder=True,
                   seed=args.seed)
    return dataset, vae.to(device).eval().requires_grad_(False)


def main(argv=None):
    from ..data.latent_cache import build_latent_cache

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    dataset, vae = build(args)
    cache = build_latent_cache(dataset, vae, batch_size=args.batch_size, seed=args.seed,
                               sample_posterior=not args.deterministic, out_path=args.out)
    logging.info("wrote %d latents to %s", len(cache), args.out)
    return cache


if __name__ == "__main__":
    main()
