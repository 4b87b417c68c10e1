"""Regeneration CLI (port of ``worddiffusion_tpu/cli/regenerate.py``):
OCR-filtered, resumable dataset regeneration on one GPU.

    python -m worddiffusion_tpu_torch.cli.regenerate --gt_file words.filter27 \\
        --torch_ckpt unet.pt --vae_pt vae.pt --ocr_pt ocr.pt --dump_path ./regen

The UNet comes from ``--torch_ckpt``, a checkpoint in the reference
layout (the reference's own ``ckpt_*.pt`` / ``ema_*.pt`` and their
``--attentionMaps`` layout, the port train CLI's ``ema_unet.pt``,
``cli.export_reference`` output; ``models.convert.reference_unet_to_port``
reads it as JAX's ``sample --torch_ckpt`` does), or from ``--ckpt_dir``, the
port train CLI's checkpoint directory (``<save_path>/ckpt``: its newest
step's EMA weights, or the trained ones with ``--use_ema 0``), or the JAX
package's orbax directory (the JAX CLI's ``--ckpt_dir``, read without JAX:
``train.orbax``, ``models.convert.jax_unet_to_torch``); its
``writers_dict_train.json`` is looked for beside it and in its parent, as
the JAX CLI does. The VAE's decode half comes from a diffusers
``--stable_dif_path`` safetensors file, from ``--vae_pt``, a
``torch.save``d state dict in the port's keys (full or decoder-only,
``models.convert.jax_vae_to_torch``), or from ``--vae_ckpt``, the
``--save_dir`` of ``cli.train_vae`` (its ``vae.pt``) or the JAX CLI's orbax
``<save_dir>/ckpt`` (``jax_vae_to_torch``); the CTC recognizer from
``--ocr_pt`` (``jax_ocr_to_torch``) or ``--ocr_ckpt`` (``cli.train_ocr``'s
``--save_dir``: its ``ocr.pt``; or the JAX CLI's orbax ``<save_dir>/ckpt``).
Each weight set that is not given is a seeded random initialisation, with a
warning.
``--ddim N`` samples with N deterministic DDIM steps instead of the DDPM
schedules.

``--latent 0`` regenerates with a pixel-space (3-channel) checkpoint and
builds no VAE; ``--hiGanArch 1`` with the HiGAN+ denoiser (``--torch_ckpt``
in the port's keys).

Every option of the JAX CLI is here. ``--use_ema 0`` without ``--ckpt_dir``
exits (a ``--torch_ckpt`` file holds one parameter set).

Under ``torchrun --nproc_per_node N`` each process regenerates its
``data.loader.host_shard`` of the corpus on its own card; the file names
are the (image, writer, word) triples', so the processes' outputs together
are the one-process output set.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="worddiffusion regeneration (PyTorch/CUDA)")
    p.add_argument("--preset", default="iam")
    p.add_argument("--torch_ckpt", default="",
                   help="UNet checkpoint in the reference layout (the reference's "
                        "ema_*.pt, the train CLI's ema_unet.pt, cli.export_reference's)")
    p.add_argument("--gt_file", required=True)
    p.add_argument("--writers_dict", default="",
                   help="writers_dict_train.json from training; default: looked for "
                        "next to --ckpt_dir and in its parent, else writer ids rebuilt "
                        "first-seen from the gt file")
    p.add_argument("--dump_path", default="./regen")
    p.add_argument("--prior_dump_paths", default="",
                   help="comma-separated previous dump folders (globs ok): crops "
                        "already present there are skipped")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--fullSampling", type=int, default=0,
                   help="1: full 599 model calls, stochastic; 0: skip-step schedule")
    p.add_argument("--ddim", type=int, default=0,
                   help="DDIM with N steps instead of the DDPM schedules")
    p.add_argument("--keep_rejected", type=int, default=0,
                   help="also write OCR-rejected images under <dump_path>/rejected")
    p.add_argument("--epoch", type=int, default=0, help="skip-schedule epoch knob")
    p.add_argument("--sidChange", type=int, default=0)
    p.add_argument("--stable_dif_path", default="", help="diffusers VAE (safetensors)")
    p.add_argument("--vae_pt", default="",
                   help="VAE state dict in the port's keys (full or decoder-only)")
    p.add_argument("--ocr_pt", default="", help="CTCRecognizer state dict (port keys)")
    p.add_argument("--no_ocr_filter", type=int, default=0)
    p.add_argument("--flagGen", default="", help="stop-flag file")
    p.add_argument("--ckpt_dir", default="",
                   help="the train CLI's checkpoint directory (<save_path>/ckpt), the "
                        "port's or the JAX package's (orbax)")
    p.add_argument("--use_ema", type=int, default=1,
                   help="--ckpt_dir's EMA weights (1) or trained ones (0)")
    p.add_argument("--ocr_ckpt", default="",
                   help="cli.train_ocr's --save_dir (its ocr.pt), or the JAX CLI's "
                        "orbax <save_dir>/ckpt")
    p.add_argument("--vae_ckpt", default="",
                   help="cli.train_vae's --save_dir (its vae.pt), or the JAX CLI's "
                        "orbax <save_dir>/ckpt")
    p.add_argument("--hiGanArch", type=int, default=0)
    p.add_argument("--latent", type=int, default=1)
    p.add_argument("--partialLoad", type=float, default=0.0)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def _load_or_init(module, src, what: str, seed: int):
    """``src``: a state dict (``side_weights``), or None."""
    from ..models.layers import init_weights_

    if src is not None:
        module.load_state_dict(src)
    else:
        logging.warning("no %s weights given: seeded random initialisation (seed %d)",
                        what, seed)
        init_weights_(module, seed)
    return module


def build(args):
    """Everything but the run: -> (Regenerator, samples)."""
    import torch

    from ..configs import presets
    from ..data.alphabets import OCR_CVL, OCR_ENG, OCR_NOR
    from ..data.gt import parse_gt
    from ..diffusion.sampler import regen_call_mask
    from ..generate.regenerate import Regenerator
    from ..generate.sample import WordSampler
    from ..data.loader import host_shard
    from ..models.ocr import CTCRecognizer
    from ..models.vae import make_vae
    from ..parallel.distributed import initialize_multihost, local_device
    from ..configs.pixel import pixel_space_exp
    from ..models.higan import refuse_conditioning
    from ..models.convert import jax_ocr_to_torch, jax_vae_to_torch
    from ..train.checkpoint import side_weights
    from .sample import check_weight_flags, load_unet, resolve_writer_registry

    check_weight_flags(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    rank, world = initialize_multihost(args.device)  # no-op in one process
    device = local_device(args.device)

    exp = presets.get(args.preset)
    if not args.latent:
        exp = pixel_space_exp(exp)
    if args.hiGanArch:
        refuse_conditioning(exp.unet, "--hiGanArch 1", SystemExit)
    unet = load_unet(exp, args, bool(args.hiGanArch)).to(device)
    vae = None
    if exp.data.latent:
        vae_sd = side_weights(args.vae_pt, args.vae_ckpt, "--vae_ckpt", "vae.pt",
                              lambda t: jax_vae_to_torch(t, exp.vae))
        vae = make_vae(exp.vae, args.stable_dif_path, vae_sd, with_encoder=False,
                       seed=args.seed).to(device)
    mask = regen_call_mask(exp.diffusion.num_steps, epoch=args.epoch,
                           full_sampling=bool(args.fullSampling))
    # the JAX CLI's log of the reference's modelCall counter
    if args.ddim:
        logging.info("denoiser calls per batch: %d (DDIM)", args.ddim)
    else:
        logging.info("denoiser calls per batch: %d of %d steps",
                     int(mask[1:].sum()), exp.diffusion.num_steps - 1)

    ocr_alphabet = {"nor": OCR_NOR, "cvl": OCR_CVL}.get(exp.data.alphabet, OCR_ENG)
    ocr, ocr_sd = None, side_weights(args.ocr_pt, args.ocr_ckpt, "--ocr_ckpt", "ocr.pt",
                                     jax_ocr_to_torch)
    if not args.no_ocr_filter:
        if ocr_sd is None:
            logging.warning("an untrained OCR filter accepts almost nothing; "
                            "--no_ocr_filter 1 keeps every image")
        ocr = _load_or_init(CTCRecognizer(num_classes=len(ocr_alphabet)), ocr_sd,
                            "OCR", args.seed).to(device).eval()

    sampler = WordSampler(exp, unet, vae, call_mask=None if args.ddim else mask,
                          stochastic=bool(args.fullSampling), ocr_apply=ocr,
                          ddim_steps=args.ddim)
    samples, gt_registry = parse_gt(args.gt_file, partial_load=args.partialLoad)
    registry = resolve_writer_registry(args.writers_dict, args.ckpt_dir, samples, gt_registry)
    if world > 1:
        samples = host_shard(samples, rank, world)
        logging.info("data parallel regeneration: process %d of %d, %d samples", rank, world,
                     len(samples))
    regen = Regenerator(
        sampler,
        ocr_alphabet=ocr_alphabet,
        out_dir=args.dump_path,
        writer_lookup=lambda w: registry[w],
        sid_change=args.sidChange,
        stop_flag=args.flagGen or None,
        keep_rejected=bool(args.keep_rejected),
        prior_dirs=[d.strip() for d in args.prior_dump_paths.split(",") if d.strip()],
    )
    return regen, samples


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    regen, samples = build(args)
    stats = regen.run(samples, batch_size=args.batch_size, seed=args.seed,
                      max_batches=args.max_batches or None)
    logging.info(
        "accept rate %.3f (%d/%d), %d skipped as existing",
        stats.accept_rate, stats.accepted, stats.generated, stats.skipped_existing,
    )
    return stats


if __name__ == "__main__":
    main()
