"""Training CLI (port of ``worddiffusion_tpu/cli/train.py``): the same
flags and defaults, on one GPU, from a latent cache.

    python -m worddiffusion_tpu_torch.cli.train --preset iam \\
        --gt_train ./gt/gan.iam.tr_va.gt.filter27 --latent_cache latents.npz \\
        --epochs 1000 --batch_size 128 --save_path ./runs/iam

The latent cache is an npz of ``image name -> [8, 32, 4]`` VAE latents
(``worddiffusion_tpu.data.latent_cache.build_latent_cache`` writes one).
Checkpoints land in ``<save_path>/ckpt/<step>/``; ``ema_unet.pt`` there
is the regeneration CLI's ``--torch_ckpt``. Epoch previews are written
to ``<save_path>/images/``, decoded by ``--vae_pt`` (port keys) or a
seeded random VAE decoder.

Every flag whose path is not ported raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    from ..configs import presets

    p = argparse.ArgumentParser(description="worddiffusion trainer (PyTorch/CUDA)")
    p.add_argument("--preset", default="iam", choices=sorted(presets.PRESETS))
    p.add_argument("--gt_train", default="")
    p.add_argument("--iam_path", default="", help="word-crop image dir")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--img_size", default="64,256")
    p.add_argument("--save_path", default="./runs/default")
    p.add_argument("--latent", type=int, default=1)
    p.add_argument("--phosc", type=int, default=0)
    p.add_argument("--phos", type=int, default=0)
    p.add_argument("--ocrTraining", type=int, default=0)
    p.add_argument("--wrdChrWrStyl", type=int, default=0)
    p.add_argument("--charImages", type=int, default=0)
    p.add_argument("--imgConditioned", type=int, default=0)
    p.add_argument("--style_dict", default="")
    p.add_argument("--allow_random_style", type=int, default=0)
    p.add_argument("--augMaps", type=int, default=0)
    p.add_argument("--vaeFromDict", type=int, default=0)
    p.add_argument("--latent_cache", default="", help="npz of image name -> latent")
    p.add_argument("--preview_ddim", type=int, default=50,
                   help="DDIM steps for epoch previews; 0 = full DDPM "
                        "(the reference preview path)")
    p.add_argument("--vae_ckpt", default="", help="orbax VAE dir (not readable here)")
    p.add_argument("--stable_dif_path", default="", help="diffusers VAE (not ported)")
    p.add_argument("--vae_pt", default="",
                   help="VAE decoder state dict in the port's keys, for the previews")
    p.add_argument("--ckpt_every_epochs", type=int, default=0,
                   help="override the preset's checkpoint/preview cadence "
                        "(reference: every 5 epochs)")
    p.add_argument("--stopFlagFile", default="")
    p.add_argument("--loadPrev", type=int, default=0,
                   help="resume from the latest checkpoint; --epochs is the "
                        "TOTAL target, and the resumed run continues "
                        "bitwise like an uninterrupted one (Trainer.run)")
    p.add_argument("--partialLoad", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--vocab_size", type=int, default=10)
    p.add_argument("--samples_per_word", type=int, default=16)
    p.add_argument("--hiGanArch", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def _refuse_unported(args) -> None:
    unported = {
        "--synthetic": args.synthetic,
        "--ocrTraining": args.ocrTraining,
        "--wrdChrWrStyl": args.wrdChrWrStyl,
        "--charImages": args.charImages,
        "--imgConditioned": args.imgConditioned,
        "--hiGanArch": args.hiGanArch,
        "--augMaps": args.augMaps,
        "--vae_ckpt": args.vae_ckpt,
        "--stable_dif_path": args.stable_dif_path,
    }
    for flag, value in unported.items():
        if value:
            raise NotImplementedError(f"{flag} is not ported to PyTorch yet")
    if not args.latent:
        raise NotImplementedError("--latent 0 (pixel-space training) is not ported yet")
    if not args.latent_cache:
        raise NotImplementedError(
            "--latent 1 without --latent_cache needs the VAE encoder, which is not "
            "ported yet")
    if not args.gt_train:
        raise NotImplementedError(
            "training without --gt_train uses the synthetic corpus, which is not "
            "ported yet")
    if args.mesh_data > 1 or args.mesh_model > 1:
        raise NotImplementedError("a mesh larger than one device is not ported yet")


def experiment_from_args(args):
    """The JAX CLI's experiment for the ported flags."""
    from ..configs import presets

    exp = presets.get(args.preset)
    if args.phosc or args.phos:
        exp = presets.get("iam_phosc") if args.preset == "iam" else exp
    h, w = (int(v) for v in args.img_size.split(","))
    return exp.replace(
        data=dataclasses.replace(
            exp.data, gt_path=args.gt_train, image_dir=args.iam_path, img_height=h,
            img_width=w, latent=True, latent_cache=args.latent_cache,
            batch_size=args.batch_size,
        ),
        train=dataclasses.replace(
            exp.train, lr=args.lr, epochs=args.epochs, save_path=args.save_path,
            stop_flag_file=args.stopFlagFile or None, seed=args.seed,
            **({"ckpt_every_epochs": args.ckpt_every_epochs}
               if args.ckpt_every_epochs else {}),
        ),
    )


def _preview_fn(args, exp, device):
    """Epoch preview grids of the fixed probe words (reference
    ``train.py:298-313``), sampled with the EMA weights."""
    import numpy as np
    import torch

    from ..generate.sample import WordSampler
    from ..models.layers import init_weights_
    from ..models.vae import AutoencoderKL
    from ..utils.images import save_image_grid

    vae = AutoencoderKL(exp.vae)
    if args.vae_pt:
        vae.load_state_dict(torch.load(args.vae_pt, map_location="cpu", weights_only=True))
    else:
        logging.warning("no --vae_pt: previews decode with a seeded random VAE")
        init_weights_(vae, args.seed)
    vae = vae.to(device)

    def preview_fn(state, epoch):
        sampler = WordSampler(exp, state.ema, vae, ddim_steps=args.preview_ddim)
        gen = torch.Generator(device=device).manual_seed(epoch)
        imgs = sampler.sample_preview(gen).astype(np.float32) / 255.0
        save_image_grid(imgs, f"{args.save_path}/images/epoch_{epoch:04d}.png", ncol=3)
        return imgs

    return preview_fn


def build(args):
    """Everything but the run: -> Trainer."""
    import torch

    from ..data.dataset import LatentLookup, WordImageDataset
    from ..data.gt import parse_gt
    from ..data.tokenizer import Tokenizer
    from ..train.loop import Trainer

    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    exp = experiment_from_args(args)
    samples, registry = parse_gt(args.gt_train, partial_load=args.partialLoad)
    os.makedirs(args.save_path, exist_ok=True)
    # writers_dict_train.json compat (trainModifyCondition.py:1061-1064)
    registry.dump_json(f"{args.save_path}/writers_dict_train.json")
    tokenizer = Tokenizer.from_name(exp.data.alphabet, exp.data.max_chars)
    dataset = WordImageDataset(samples, registry, tokenizer, exp.data,
                               latent_cache=LatentLookup.load(args.latent_cache),
                               use_phosc=exp.unet.use_phosc)
    return Trainer(exp, dataset, preview_fn=_preview_fn(args, exp, device), device=device)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    trainer = build(args)
    return trainer.run(epochs=args.epochs, resume=bool(args.loadPrev))


if __name__ == "__main__":
    main()
