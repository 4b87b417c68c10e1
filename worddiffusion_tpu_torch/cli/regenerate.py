"""Regeneration CLI (port of ``worddiffusion_tpu/cli/regenerate.py``):
OCR-filtered, resumable dataset regeneration on one GPU.

    python -m worddiffusion_tpu_torch.cli.regenerate --gt_file words.filter27 \\
        --torch_ckpt unet.pt --vae_pt vae.pt --ocr_pt ocr.pt --dump_path ./regen

``--torch_ckpt`` is a reference-keyed UNet state dict, as
``worddiffusion_tpu.cli.export_torch`` writes from a JAX run (or the
``ema_unet.pt`` of the port's train CLI). The VAE's decode half comes
from a diffusers ``--stable_dif_path`` safetensors file or from
``--vae_pt``, a ``torch.save``d state dict in the port's keys (full or
decoder-only, ``models.convert.jax_vae_to_torch``); ``--ocr_pt`` is one
of the CTC recognizer (``jax_ocr_to_torch``). Each weight set that is
not given is a seeded random initialisation, with a warning.
``--ddim N`` samples with N deterministic DDIM steps instead of the DDPM
schedules.

Every option of the JAX CLI is here. The orbax directories
(``--ckpt_dir``, ``--vae_ckpt``, ``--ocr_ckpt``) are converted offline
by the JAX package, so they, ``--use_ema 0`` (the exported file is one
parameter set) and the unported model paths (``--hiGanArch 1``,
``--latent 0``) raise with the reason.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="worddiffusion regeneration (PyTorch/CUDA)")
    p.add_argument("--preset", default="iam")
    p.add_argument("--torch_ckpt", default="",
                   help="reference-keyed UNet state dict (cli.export_torch output)")
    p.add_argument("--gt_file", required=True)
    p.add_argument("--writers_dict", default="",
                   help="writers_dict_train.json from training; default: writer "
                        "ids rebuilt first-seen from the gt file")
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
    p.add_argument("--ckpt_dir", default="", help="orbax checkpoint (not readable here)")
    p.add_argument("--use_ema", type=int, default=1,
                   help="the --torch_ckpt file holds one parameter set; 0 is refused")
    p.add_argument("--ocr_ckpt", default="", help="orbax OCR checkpoint (not readable here)")
    p.add_argument("--vae_ckpt", default="", help="orbax VAE checkpoint (not readable here)")
    p.add_argument("--hiGanArch", type=int, default=0)
    p.add_argument("--latent", type=int, default=1)
    p.add_argument("--partialLoad", type=float, default=0.0)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def _load_or_init(module, path: str, what: str, seed: int):
    import torch

    from ..models.layers import init_weights_

    if path:
        module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    else:
        logging.warning("no %s weights given: seeded random initialisation (seed %d)",
                        what, seed)
        init_weights_(module, seed)
    return module


def _writer_registry(writers_dict: str, samples, gt_registry):
    from ..data.gt import WriterRegistry

    if not writers_dict:
        logging.warning(
            "no --writers_dict: writer ids rebuilt first-seen from the gt file; "
            "conditioning matches training only if the corpora list writers in "
            "the same order"
        )
        return gt_registry
    registry = WriterRegistry.from_json(writers_dict)
    unknown = sorted({s.writer for s in samples if s.writer not in registry})
    if unknown:
        raise SystemExit(
            f"{len(unknown)} writer id(s) in the gt file are not in the training "
            f"writers dict (first few: {unknown[:10]})"
        )
    return registry


_CONVERT = "python -m worddiffusion_tpu.cli.export_torch (the JAX package)"


def _refuse_unported(args) -> None:
    """The JAX CLI's options that this one cannot honour, with the reason."""
    from .train import SLICE_12

    offline = {
        "--ckpt_dir": (args.ckpt_dir, f"convert it with {_CONVERT} and pass --torch_ckpt"),
        "--vae_ckpt": (args.vae_ckpt, "convert it with models.convert.jax_vae_to_torch and "
                                      "pass --vae_pt"),
        "--ocr_ckpt": (args.ocr_ckpt, "convert it with models.convert.jax_ocr_to_torch and "
                                      "pass --ocr_pt"),
    }
    for flag, (value, how) in offline.items():
        if value:
            raise SystemExit(f"{flag} is an orbax checkpoint, which the port does not read: {how}")
    if not args.use_ema:
        raise SystemExit(f"--use_ema 0: --torch_ckpt holds one parameter set; pick it when "
                         f"exporting ({_CONVERT} --use_ema 0)")
    if args.hiGanArch:
        raise NotImplementedError("--hiGanArch 1 (the HiGAN+ denoiser) is not ported yet; "
                                  f"it waits for {SLICE_12}")
    if not args.latent:
        raise NotImplementedError("--latent 0 (pixel-space sampling) is not ported yet; it "
                                  f"waits for {SLICE_12}")


def build(args):
    """Everything but the run: -> (Regenerator, samples)."""
    import torch

    from ..configs import presets
    from ..data.alphabets import OCR_CVL, OCR_ENG, OCR_NOR
    from ..data.gt import parse_gt
    from ..diffusion.sampler import regen_call_mask
    from ..generate.regenerate import Regenerator
    from ..generate.sample import WordSampler
    from ..models.ocr import CTCRecognizer
    from ..models.unet import UNet
    from ..models.vae import make_vae

    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    exp = presets.get(args.preset)
    unet = _load_or_init(UNet(exp.unet), args.torch_ckpt, "UNet", args.seed).to(device)
    vae = make_vae(exp.vae, args.stable_dif_path, args.vae_pt, with_encoder=False,
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
    ocr = None
    if not args.no_ocr_filter:
        if not args.ocr_pt:
            logging.warning("an untrained OCR filter accepts almost nothing; "
                            "--no_ocr_filter 1 keeps every image")
        ocr = _load_or_init(CTCRecognizer(num_classes=len(ocr_alphabet)), args.ocr_pt,
                            "OCR", args.seed).to(device).eval()

    sampler = WordSampler(exp, unet, vae, call_mask=None if args.ddim else mask,
                          stochastic=bool(args.fullSampling), ocr_apply=ocr,
                          ddim_steps=args.ddim)
    samples, gt_registry = parse_gt(args.gt_file, partial_load=args.partialLoad)
    registry = _writer_registry(args.writers_dict, samples, gt_registry)
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
