"""Sampling CLI (port of ``worddiffusion_tpu/cli/sample.py``): word images
from a checkpoint for a word list or a whole gt file, on one GPU.

    python -m worddiffusion_tpu_torch.cli.sample --words hello,world --writer 3 \\
        --torch_ckpt unet.pt --stable_dif_path vae.safetensors --n 2 \\
        [--writer2 7 --mix_rate 0.5] [--cfg_scale 3] [--ddim 50 --ddim_eta 0] \\
        [--wrdChrWrStyl 1 --style_dict styles.npz] \\
        [--imgConditioned 1 --cond_image ref.png] [--crop_whitespace 1]

``--torch_ckpt`` is a reference-keyed UNet state dict (the ``ema_unet.pt``
of the port's train CLI, or ``worddiffusion_tpu.cli.export_torch``
output); the CTC aux head of an ``--ocrTraining`` checkpoint is left
unread, as sampling does not run it. The VAE comes from a diffusers
``--stable_dif_path`` file or ``--vae_pt`` (the port's keys; a full one
with ``--imgConditioned``, whose ``--cond_image`` is encoded to its
posterior mean). Weights not given are seeded random, with a warning.
``--writer -1`` draws a writer per word, and a negative ``--mix_rate``
draws one uniform(0, 1) per sample, from ``numpy.random.default_rng
(--seed)`` in the JAX CLI's order. The files are
``{index:05d}_{writer}_{word}[_mix{rate:.3f}].png``, as the JAX CLI
names them.

Every option of the JAX CLI is here. The orbax checkpoints
(``--ckpt_dir``, ``--vae_ckpt``) are converted offline by the JAX
package, so they and ``--use_ema 0`` exit with the conversion to run;
``--charImages 1`` conditions on the words' glyph crops
(``data.dataset.char_glyphs``, as the training renders them);
``--hiGanArch 1`` and ``--latent 0`` raise ``NotImplementedError`` naming
slice 12 of the port.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

B = 16  # samples per batch, as the JAX CLI's


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="worddiffusion sampler (PyTorch/CUDA)")
    p.add_argument("--preset", default="iam")
    p.add_argument("--ckpt_dir", default="", help="orbax checkpoint (not readable here)")
    p.add_argument("--torch_ckpt", default="",
                   help="reference-keyed UNet state dict (the train CLI's ema_unet.pt)")
    p.add_argument("--words", default="", help="comma-separated words")
    p.add_argument("--gt_file", default="", help="regenerate every (writer,word) pair")
    p.add_argument("--writers_dict", default="",
                   help="writers_dict_train.json from training; default: looked for next "
                        "to --torch_ckpt")
    p.add_argument("--writer", type=int, default=-1, help="-1: random per word")
    p.add_argument("--writer2", type=int, default=-1,
                   help="second writer id: interpolate between --writer and --writer2")
    p.add_argument("--mix_rate", type=float, default=-1.0,
                   help="interpolation weight towards --writer2; negative draws a "
                        "uniform(0,1) per sample")
    p.add_argument("--n", type=int, default=1, help="samples per word")
    p.add_argument("--save_path", default="./samples")
    p.add_argument("--use_ema", type=int, default=1,
                   help="the --torch_ckpt file holds one parameter set; 0 is refused")
    p.add_argument("--cfg_scale", type=float, default=0.0)
    p.add_argument("--ddim", type=int, default=0,
                   help="use DDIM with N steps instead of full DDPM")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--stable_dif_path", default="", help="diffusers VAE (safetensors)")
    p.add_argument("--vae_pt", default="",
                   help="VAE state dict in the port's keys (full with --imgConditioned)")
    p.add_argument("--vae_ckpt", default="", help="orbax VAE checkpoint (not readable here)")
    p.add_argument("--crop_whitespace", type=int, default=0)
    p.add_argument("--wrdChrWrStyl", type=int, default=0,
                   help="model trained with 4096-d writer-style replacement (needs "
                        "--style_dict)")
    p.add_argument("--charImages", type=int, default=0)
    p.add_argument("--imgConditioned", type=int, default=0,
                   help="model trained with reference-latent conditioning (needs "
                        "--cond_image)")
    p.add_argument("--cond_image", default="",
                   help="PNG whose VAE posterior mean conditions every sample")
    p.add_argument("--style_dict", default="", help="writer -> style-vector npz")
    p.add_argument("--hiGanArch", type=int, default=0)
    p.add_argument("--latent", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def load_writers_dict(path: str, ckpt_dir: str):
    """Copy of ``worddiffusion_tpu/cli/sample.py::load_writers_dict`` (that
    module's ``main`` imports jax). Training-time writer-identity dict:
    explicit ``--writers_dict`` wins; otherwise it is looked for in
    ``<ckpt_dir>`` and its parent. Returns a WriterRegistry, or None when
    nothing is found.
    """
    from ..data.gt import WriterRegistry

    if path:
        if not os.path.exists(path):
            raise SystemExit(f"--writers_dict {path} not found")
        candidates = [path]
    elif ckpt_dir:
        base = os.path.abspath(ckpt_dir).rstrip("/")
        candidates = [
            os.path.join(base, "writers_dict_train.json"),
            os.path.join(os.path.dirname(base), "writers_dict_train.json"),
        ]
    else:
        candidates = []
    for c in candidates:
        if os.path.exists(c):
            logging.info("writer ids from training dict %s", c)
            return WriterRegistry.from_json(c)
    return None


def resolve_writer_registry(args_writers_dict, ckpt_dir, samples, gt_registry):
    """Copy of ``worddiffusion_tpu/cli/sample.py::resolve_writer_registry``.
    Training dict if available; refuses unknown writers. Falls back to the
    gt-file first-seen registry only with a loud warning."""
    registry = load_writers_dict(args_writers_dict, ckpt_dir)
    if registry is None:
        logging.warning(
            "no writers_dict_train.json found near %r: writer ids rebuilt "
            "first-seen from the inference gt file — conditioning will NOT "
            "match training unless the corpora enumerate writers in the "
            "same order. Pass --writers_dict to pin the training mapping.",
            ckpt_dir,
        )
        return gt_registry
    unknown = sorted({s.writer for s in samples if s.writer not in registry})
    if unknown:
        raise SystemExit(
            f"{len(unknown)} writer id(s) in the gt file are not in the "
            f"training writers dict (first few: {unknown[:10]}); the model "
            f"was never conditioned on them. Remove them or sample with an "
            f"explicit --writer id."
        )
    return registry


_CONVERT = "python -m worddiffusion_tpu.cli.export_torch (the JAX package)"


def _refuse_unported(args) -> None:
    """The JAX CLI's options that this one cannot honour, with the reason."""
    from .train import SLICE_12

    if args.ckpt_dir:
        raise SystemExit(f"--ckpt_dir is an orbax checkpoint, which the port does not read: "
                         f"convert it with {_CONVERT} and pass --torch_ckpt")
    if args.vae_ckpt:
        raise SystemExit("--vae_ckpt is an orbax checkpoint, which the port does not read: "
                         "convert it with models.convert.jax_vae_to_torch and pass --vae_pt")
    if not args.use_ema:
        raise SystemExit(f"--use_ema 0: --torch_ckpt holds one parameter set; pick it when "
                         f"exporting ({_CONVERT} --use_ema 0)")
    if args.hiGanArch:
        raise NotImplementedError("--hiGanArch 1 (the HiGAN+ denoiser) is not ported yet; "
                                  f"it waits for {SLICE_12}")
    if not args.latent:
        raise NotImplementedError("--latent 0 (pixel-space sampling) is not ported yet; it "
                                  f"waits for {SLICE_12}")
    if args.imgConditioned and not args.cond_image:
        raise SystemExit("--imgConditioned 1 needs --cond_image")
    if args.wrdChrWrStyl and not args.style_dict:
        raise SystemExit("--wrdChrWrStyl 1 needs --style_dict (from "
                         "worddiffusion_tpu.cli.train_style)")


def experiment(args):
    """The preset with the model variant the flags name."""
    import dataclasses

    from ..configs import presets

    exp = presets.get(args.preset)
    return dataclasses.replace(exp, unet=dataclasses.replace(
        exp.unet, img_conditioned=bool(args.imgConditioned),
        use_char_images=bool(args.charImages) or exp.unet.use_char_images,
        style_vec_dim=4096 if args.wrdChrWrStyl else exp.unet.style_vec_dim,
        # match training: the style REPLACES the char context
        style_replace_context=bool(args.wrdChrWrStyl) or exp.unet.style_replace_context,
    ))


def load_unet(exp, path: str, seed: int):
    """The UNet from a reference-keyed state dict (less an aux head's keys:
    sampling does not run the head), or seeded random with a warning."""
    import torch

    from ..models.layers import init_weights_
    from ..models.unet import UNet

    unet = UNet(exp.unet)
    if not path:
        logging.warning("no --torch_ckpt: seeded random UNet (seed %d)", seed)
        return init_weights_(unet, seed)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    dropped = [k for k in sd if k.startswith("auxhead.")]
    if dropped:
        logging.info("%d CTC aux head tensors in %s left unread", len(dropped), path)
    unet.load_state_dict({k: v for k, v in sd.items() if k not in dropped}, strict=True)
    return unet


def cond_latent(vae, path: str, exp, device):
    """The SD-scaled posterior mean [1, h, w, 4] of the PNG at ``path``,
    resized and padded to the preset's image size (the space the training's
    reference latents live in)."""
    import torch

    from ..data.png import read_png
    from ..models.vae import encode_to_latent
    from ..utils.images import normalize_to_unit, resize_and_pad

    img = resize_and_pad(read_png(path), exp.data.img_height, exp.data.img_width)
    x = torch.from_numpy(normalize_to_unit(img)[None]).to(device)
    with torch.no_grad():
        return encode_to_latent(vae, x, sample=False).cpu().numpy()


def build(args):
    """Everything but the sampling loop: -> (sampler, pairs, style lookup or
    None, the reference latent [1, h, w, 4] or None, the numpy generator
    the mix rates are drawn from), pairs [(word, dense writer id, raw
    writer id)]."""
    import torch

    from ..generate.sample import WordSampler
    from ..models.vae import make_vae

    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    exp = experiment(args)
    style_lookup = None
    if args.wrdChrWrStyl:
        from .train import style_lookup as read_style_dict

        style_lookup = read_style_dict(args.style_dict)
    unet = load_unet(exp, args.torch_ckpt, args.seed).to(device)
    vae = make_vae(exp.vae, args.stable_dif_path, args.vae_pt,
                   with_encoder=bool(args.imgConditioned), seed=args.seed)
    vae = vae.to(device).eval().requires_grad_(False)
    sampler = WordSampler(exp, unet, vae, cfg_scale=args.cfg_scale, ddim_steps=args.ddim,
                          ddim_eta=args.ddim_eta)
    cond_lat1 = cond_latent(vae, args.cond_image, exp, device) if args.imgConditioned else None

    rng_np = np.random.default_rng(args.seed)
    ckpt_dir = os.path.dirname(args.torch_ckpt) if args.torch_ckpt else ""
    if args.gt_file:
        from ..data.gt import parse_gt

        samples, gt_registry = parse_gt(args.gt_file)
        registry = resolve_writer_registry(args.writers_dict, ckpt_dir, samples, gt_registry)
        pairs = [(s.word, registry[s.writer], s.writer) for s in samples]
    else:
        words = [w for w in args.words.split(",") if w]
        # --writer takes the DENSE embedding index; the style dict is keyed by
        # RAW training writer ids, so invert the training writers_dict
        registry = load_writers_dict(args.writers_dict, ckpt_dir)
        raw_by_dense = {v: k for k, v in registry.mapping.items()} if registry else {}
        pairs = []
        for w in words:
            for _ in range(args.n):
                wid = (args.writer if args.writer >= 0
                       else int(rng_np.integers(0, exp.unet.num_writers)))
                pairs.append((w, wid, raw_by_dense.get(wid, str(wid))))
    return sampler, pairs, style_lookup, cond_lat1, rng_np


def main(argv=None) -> list[str]:
    """-> the written file names, in order."""
    import torch

    from ..data.dataset import char_glyphs
    from ..generate.sample import phosc_ids
    from ..utils.images import crop_whitespace, encode_png, save_single_images

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    sampler, pairs, style_lookup, cond_lat1, rng_np = build(args)
    exp = sampler.exp
    os.makedirs(args.save_path, exist_ok=True)
    written, glyph_cache = [], {}
    for start in range(0, len(pairs), B):
        chunk = pairs[start : start + B]
        words_b = [w for w, _, _ in chunk]
        wids_b = [i for _, i, _ in chunk]
        cond = {}
        if exp.unet.use_phosc:
            cond["phosc"] = phosc_ids(words_b, exp.data.phos_version)
        if style_lookup is not None:
            missing = [n for _, _, n in chunk if n not in style_lookup]
            if missing:
                raise SystemExit(f"writers {sorted(set(missing))[:10]} not in --style_dict "
                                 f"(keys: {sorted(style_lookup)[:10]}...)")
            cond["style_vec"] = np.stack([style_lookup[n] for _, _, n in chunk])
        mix = None
        if args.writer2 >= 0:
            mix = (np.full((len(chunk),), args.mix_rate, np.float32) if args.mix_rate >= 0
                   else rng_np.uniform(0.0, 1.0, len(chunk)).astype(np.float32))
            cond.update(writer_ids2=[args.writer2] * len(chunk), mix_rate=mix)
        if exp.unet.use_char_images:
            cond["char_images"] = np.stack([char_glyphs(w, exp.data.max_chars,
                                                        exp.unet.char_image_size, glyph_cache)
                                            for w in words_b])
        if cond_lat1 is not None:
            cond["cond_latents"] = np.repeat(cond_lat1, len(chunk), axis=0)
        seed = int(np.random.SeedSequence([args.seed, start]).generate_state(1)[0])
        gen = torch.Generator(device=sampler.device).manual_seed(seed)
        imgs = sampler.sample_async(words_b, wids_b, gen, **cond).cpu().numpy()
        names = [f"{start + i:05d}_{wid}_{w}" + (f"_mix{mix[i]:.3f}" if mix is not None else "")
                 + ".png" for i, (w, wid, _) in enumerate(chunk)]
        if args.crop_whitespace:
            for img, name in zip(imgs, names):
                with open(os.path.join(args.save_path, name), "wb") as f:
                    f.write(encode_png(crop_whitespace(img)))
        else:
            save_single_images(imgs, names, args.save_path)
        written += names
        logging.info("wrote %d images", start + len(chunk))
    return written


if __name__ == "__main__":
    main()
