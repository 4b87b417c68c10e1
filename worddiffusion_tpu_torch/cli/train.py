"""Training CLI (port of ``worddiffusion_tpu/cli/train.py``): the same
flags and defaults, on one GPU, from a latent cache or from word images.

    python -m worddiffusion_tpu_torch.cli.train --preset iam \\
        --gt_train ./gt/gan.iam.tr_va.gt.filter27 --latent_cache latents.npz \\
        --epochs 1000 --batch_size 128 --save_path ./runs/iam

The latent cache is an npz of ``image name -> [8, 32, 4]`` VAE latents
(``cli.build_latent_cache`` writes one). Without ``--latent_cache`` the
word crops are read from ``--iam_path`` and each batch is encoded by the
frozen VAE encoder inside the step: the VAE comes from a diffusers
``--stable_dif_path`` file or a full ``--vae_pt`` state dict, or is
seeded random with a warning. Checkpoints land in
``<save_path>/ckpt/<step>/``; ``ema_unet.pt`` there is the regeneration
CLI's ``--torch_ckpt``. Epoch previews are written to
``<save_path>/images/``, decoded by that VAE (with a cache: ``--vae_pt``,
a full or decoder-only state dict in the port's keys, or
``--stable_dif_path``, or a seeded random decoder).

The conditioning variants: ``--ocrTraining 1`` adds the CTC aux head and
its loss (weight 0.1), with the words' labels in the preset's alphabet
after a reserved blank class 0; ``--wrdChrWrStyl 1 --style_dict S.npz``
replaces the character context with the writers' 4096-d style vectors
(an npz of writer id -> vector, as ``worddiffusion_tpu.cli.train_style``
writes); ``--imgConditioned 1`` conditions each sample on its own clean
latent, concatenated at ``conv_in``; ``--charImages 1`` conditions on
per-character glyph crops (``data.dataset.char_glyphs``). Without
``--gt_train``, or with ``--synthetic 1``, the corpus is the synthetic one
(``--vocab_size`` words of the preset's list, ``--samples_per_word``
renders each), drawn by ``data.synthetic.render_word`` (in each writer's
style under ``--wrdChrWrStyl 1``); so is any crop missing from
``--iam_path``. ``--allow_random_style 1`` builds the style vectors with a
random-init ``StyleEncoder`` (plumbing runs only). Every flag whose path is
not ported raises ``NotImplementedError`` naming the slice it waits for.
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
    p.add_argument("--stable_dif_path", default="", help="diffusers VAE (safetensors)")
    p.add_argument("--vae_pt", default="",
                   help="VAE state dict in the port's keys: full (encoder too), or "
                        "decoder-only when training from a latent cache")
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


SLICE_12 = "slice 12 of the port (ROADMAP A)"  # what the refusals wait for


def _refuse_unported(args) -> None:
    unported = {
        "--hiGanArch": (args.hiGanArch,
                        f"the HiGAN+ denoiser is not ported; it waits for {SLICE_12}"),
        "--augMaps": (args.augMaps, "the augmentation (PIL, OpenCV) is not ported; it waits "
                                    f"for {SLICE_12}"),
        "--vae_ckpt": (args.vae_ckpt, "an orbax VAE checkpoint is not readable here; convert "
                                      "it with models.convert.jax_vae_to_torch (--vae_pt)"),
    }
    for flag, (value, why) in unported.items():
        if value:
            raise NotImplementedError(f"{flag} is not ported to PyTorch yet: {why}")
    if not args.latent:
        raise NotImplementedError(f"--latent 0 (pixel-space training) is not ported yet; it "
                                  f"waits for {SLICE_12}")
    if args.mesh_data > 1 or args.mesh_model > 1:
        raise NotImplementedError("a mesh larger than one device is not ported yet; it waits "
                                  f"for {SLICE_12}")
    if args.wrdChrWrStyl and not args.style_dict and not args.allow_random_style:
        raise SystemExit("--wrdChrWrStyl 1 needs --style_dict (train one: python -m "
                         "worddiffusion_tpu_torch.cli.train_style). Random-init style vectors "
                         "train a model conditioned on noise; pass --allow_random_style 1 only "
                         "for plumbing tests.")


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
            img_width=w, latent=True, latent_cache=args.latent_cache or None,
            batch_size=args.batch_size,
        ),
        train=dataclasses.replace(
            exp.train, lr=args.lr, epochs=args.epochs, save_path=args.save_path,
            stop_flag_file=args.stopFlagFile or None, seed=args.seed,
            ctc_weight=0.1 if args.ocrTraining else 0.0,
            **({"ckpt_every_epochs": args.ckpt_every_epochs}
               if args.ckpt_every_epochs else {}),
        ),
        unet=dataclasses.replace(
            exp.unet, ocr_head=bool(args.ocrTraining),
            style_vec_dim=4096 if args.wrdChrWrStyl else 0,
            # --wrdChrWrStyl 1: the projected style REPLACES the char context
            # (reference unet.py:1616-1618)
            style_replace_context=bool(args.wrdChrWrStyl),
            use_char_images=bool(args.charImages),
            img_conditioned=bool(args.imgConditioned),
        ),
    )


def ocr_alphabet(exp) -> str:
    """The CTC targets' alphabet: the preset's characters after a reserved
    class 0, the aux loss's blank. (The JAX CLI passes no alphabet, so its
    batches carry no targets; its preset alphabet's first character would
    be class 0, the blank.)"""
    from ..data.alphabets import ALPHABETS

    alphabet = "\0" + ALPHABETS[exp.data.alphabet]
    if len(alphabet) > exp.unet.ocr_classes:
        raise SystemExit(
            f"--ocrTraining with the {exp.data.alphabet!r} alphabet needs {len(alphabet)} CTC "
            f"classes (a blank and {len(alphabet) - 1} characters); the UNet's aux head has "
            f"ocr_classes {exp.unet.ocr_classes}")
    return alphabet


def style_lookup(path: str) -> dict:
    """writer id -> style vector, from a ``--style_dict`` npz."""
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def random_style_lookup(exp, samples, registry, tokenizer, device) -> dict:
    """``--allow_random_style 1``: writer id -> the mean of a random-init
    ``StyleEncoder(out_dim=4096)`` over up to 4 of the writer's images (the
    JAX CLI's ``_build_style_dict`` without ``--style_dict``)."""
    import numpy as np
    import torch

    from ..data.dataset import WordImageDataset
    from ..models.layers import init_weights_
    from ..models.style import StyleEncoder, build_style_dict

    logging.warning("--allow_random_style: building writer style vectors with a randomly "
                    "initialised StyleEncoder (NOT meaningful styles)")
    probe = WordImageDataset(samples, registry, tokenizer, exp.data)
    by_writer: dict = {}
    for i, s in enumerate(samples):
        if len(by_writer.setdefault(s.writer, [])) < 4:
            by_writer[s.writer].append(np.asarray(probe[i]["image"], np.float32))
    enc = init_weights_(StyleEncoder(out_dim=4096), seed=0)
    enc = enc.to(device, memory_format=torch.channels_last).eval()
    return build_style_dict(enc, {w: np.stack(v) for w, v in by_writer.items()})


def corpus(args, exp):
    """(samples, writer registry): the gt file's (``--partialLoad`` where the
    CLI has it), or without one (or with ``--synthetic``) the synthetic
    corpus of the preset's word list: the train and cache CLIs' corpus."""
    from ..data.gt import WriterRegistry, parse_gt
    from ..data.synthetic import corpus_lang, synthetic_corpus, word_list

    if args.synthetic or not args.gt_train:
        samples = synthetic_corpus(words=word_list(args.vocab_size, lang=corpus_lang(exp.data)),
                                   samples_per_word=args.samples_per_word)
        registry = WriterRegistry()
        for s in samples:
            registry.add(s.writer)
        return samples, registry
    return parse_gt(args.gt_train, partial_load=getattr(args, "partialLoad", 0.0))


def _vae(args, exp, device, with_encoder: bool):
    """The frozen VAE on ``device``: the full codec when the steps encode
    images, the decode half for the previews of latent-cache training."""
    from ..models.vae import make_vae

    vae = make_vae(exp.vae, args.stable_dif_path, args.vae_pt, with_encoder=with_encoder,
                   seed=args.seed)
    return vae.to(device).eval().requires_grad_(False)


def _preview_fn(args, exp, vae, device):
    """Epoch preview grids of the fixed probe words (reference
    ``train.py:298-313``), sampled with the EMA weights."""
    import numpy as np
    import torch

    from ..generate.sample import WordSampler
    from ..utils.images import save_image_grid

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
    from ..data.tokenizer import Tokenizer
    from ..models.vae import encode_to_latent
    from ..train.loop import Trainer

    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    exp = experiment_from_args(args)
    samples, registry = corpus(args, exp)
    os.makedirs(args.save_path, exist_ok=True)
    # writers_dict_train.json compat (trainModifyCondition.py:1061-1064)
    registry.dump_json(f"{args.save_path}/writers_dict_train.json")
    tokenizer = Tokenizer.from_name(exp.data.alphabet, exp.data.max_chars)
    cache = LatentLookup.load(args.latent_cache) if args.latent_cache else None
    styles = None
    if exp.unet.style_vec_dim:
        styles = (style_lookup(args.style_dict) if args.style_dict else
                  random_style_lookup(exp, samples, registry, tokenizer, device))
    dataset = WordImageDataset(
        samples, registry, tokenizer, exp.data, latent_cache=cache, use_phosc=exp.unet.use_phosc,
        ocr_alphabet=ocr_alphabet(exp) if exp.train.ctc_weight > 0 else None,
        style_lookup=styles, char_images=exp.unet.use_char_images,
        char_image_size=exp.unet.char_image_size,
        # synthetic corpora carry a writer-style signal only when asked for
        writer_styled=bool(args.wrdChrWrStyl and (args.synthetic or not args.gt_train)))
    vae = _vae(args, exp, device, with_encoder=cache is None)
    encode_fn = None
    if cache is None:
        def encode_fn(images, generator):
            return encode_to_latent(vae, images, generator)

    return Trainer(exp, dataset, preview_fn=_preview_fn(args, exp, vae, device), device=device,
                   encode_fn=encode_fn)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    trainer = build(args)
    return trainer.run(epochs=args.epochs, resume=bool(args.loadPrev))


if __name__ == "__main__":
    main()
