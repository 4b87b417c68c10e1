"""Evaluation CLI (port of ``worddiffusion_tpu/cli/evaluate.py``): FID, OCR
exact match and PHOSC zero-shot accuracy over a directory of generated word
images against a real set.

    python -m worddiffusion_tpu_torch.cli.evaluate --real_dir ./crops \\
        --fake_dir ./regen [--ocr_pt ./runs/ocr/ocr.pt] \\
        [--phosc_params ./runs/phosc/best_params.pkl] \\
        [--inception_weights inception_v3.pt] [--device cpu]

It prints (and with ``--out`` writes) the JAX CLI's JSON keys:
``fid_inception`` with ``--inception_weights``; ``fid_phosc`` with
``--phosc_params``; else ``fid_style_encoder`` from a random-init
``StyleEncoder`` (relative comparisons only; warned); ``ocr_exact_match``
with ``--ocr_pt``; ``phosc_zsl_accuracy`` (with ``phosc_zsl_n`` where only
some filename words embed, or a ``phosc_zsl_note``). The word of each image
is parsed from the regeneration name ``{img}_{writer}_{word}.png``.

The images are the ``.png`` and ``.jpg`` files, as the JAX CLI lists them,
each read by its signature (``data.png.read_image``: PNG or JPEG, bitwise
as PIL decodes them). The OCR is ``--ocr_pt`` (the recognizer's state dict,
as ``cli.train_ocr`` writes it) or ``--ocr_ckpt``, that CLI's
``--save_dir`` (its ``ocr.pt``), or the JAX CLI's orbax ``--ocr_ckpt``
(``<save_dir>/ckpt``, read without JAX: ``train.orbax``,
``models.convert.jax_ocr_to_torch``). Where the port differs: the random-init style
encoder, fp32 in JAX, runs fp32 on the CPU and bf16 on
the card (B.5 takes bf16), which the log says. Its numbers cannot match
JAX's either way: the inits differ.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch


def _load_dir(path: str, height: int, width: int, limit: int = 0):
    """Images + the word parsed from the regeneration name
    ``{img}_{writer}_{word}.png`` (falls back to the stem)."""
    from ..data.png import read_image
    from ..utils.images import normalize_to_unit, resize_and_pad

    names = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg")))
    if limit:
        names = names[:limit]
    imgs, words = [], []
    for n in names:
        imgs.append(normalize_to_unit(resize_and_pad(read_image(os.path.join(path, n)),
                                                     height, width)))
        stem = os.path.splitext(n)[0]
        words.append(stem.rsplit("_", 1)[-1] if "_" in stem else stem)
    return (np.stack(imgs) if imgs else np.zeros((0, height, width, 3), np.float32)), words


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FID + OCR exact match + PHOSC ZSL")
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--ocr_ckpt", default="",
                   help="cli.train_ocr's --save_dir (its ocr.pt), or the JAX CLI's "
                        "orbax <save_dir>/ckpt")
    p.add_argument("--ocr_pt", default="", help="CTCRecognizer state dict (port keys), as "
                                                "cli.train_ocr writes it")
    p.add_argument("--phosc_params", default="",
                   help="best_params.pkl from cli.train_phosc; enables the default "
                        "PHOSC-feature FID + ZSL accuracy")
    p.add_argument("--phosc_trunk", default="vgg")
    p.add_argument("--inception_weights", default="",
                   help="torchvision inception_v3 state dict (.pt/.npz); enables classic "
                        "Inception FID")
    p.add_argument("--language", default="eng")
    p.add_argument("--out", default="", help="write results json here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def _features(name: str, fn, arr: np.ndarray, batch_size: int) -> np.ndarray:
    """fn over ``arr`` in batches -> [N, D] numpy; logs images/s."""
    from ..eval.fid import compute_features

    t0 = time.perf_counter()
    out = compute_features(fn, (arr[s:s + batch_size] for s in range(0, len(arr), batch_size)))
    dt = time.perf_counter() - t0
    logging.info("featurizer %s: %d images in %.3f s (%.1f images/s)", name, len(arr), dt,
                 len(arr) / max(dt, 1e-9))
    return out


def main(argv=None) -> dict:
    from ..data.alphabets import OCR_CVL, OCR_ENG, OCR_NOR
    from ..eval.fid import fid_score, load_phosc_net, phosc_resize
    from ..models.convert import jax_ocr_to_torch
    from ..train.checkpoint import side_weights

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    ocr_sd = side_weights(args.ocr_pt, args.ocr_ckpt, "--ocr_ckpt", "ocr.pt", jax_ocr_to_torch)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    real, real_words = _load_dir(args.real_dir, args.height, args.width, args.limit)
    fake, fake_words = _load_dir(args.fake_dir, args.height, args.width, args.limit)
    logging.info("loaded %d real / %d generated", len(real), len(fake))
    results: dict = {}

    phosc_fn = None
    if args.phosc_params:
        if not os.path.exists(args.phosc_params):
            raise SystemExit(f"--phosc_params {args.phosc_params} not found")
        phosc_fn, _ = load_phosc_net(args.phosc_params, args.language, args.phosc_trunk, device)

    # FID featurizer preference: Inception > trained PHOSCNet trunk > random
    # StyleEncoder (relative-only, warned)
    if len(real) > 1 and len(fake) > 1:
        if args.inception_weights:
            if not os.path.exists(args.inception_weights):
                raise SystemExit(f"--inception_weights {args.inception_weights} not found")
            from ..eval.inception import load_inception_featurizer

            feat = load_inception_featurizer(args.inception_weights, device)
            results["fid_inception"] = fid_score(
                _features("inception", feat, real, args.batch_size),
                _features("inception", feat, fake, args.batch_size))
        if phosc_fn is not None:
            def feat(im):
                return phosc_fn(phosc_resize(im))["features"].cpu().numpy()

            results["fid_phosc"] = fid_score(_features("phosc", feat, real, args.batch_size),
                                             _features("phosc", feat, fake, args.batch_size))
        if not results:
            from ..models.layers import init_weights_
            from ..models.style import StyleEncoder

            dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
            logging.warning("no --inception_weights / --phosc_params: FID uses a RANDOM-INIT "
                            "StyleEncoder (relative comparisons only), in %s%s", dtype,
                            "" if device.type == "cpu" else
                            " on the card (the JAX CLI's is fp32; B.5 takes bf16)")
            enc = init_weights_(StyleEncoder(dtype=dtype), seed=0)
            enc = enc.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)

            def feat(im):
                with torch.no_grad():
                    return enc(torch.from_numpy(np.asarray(im)).to(device)).cpu().numpy()

            results["fid_style_encoder"] = fid_score(
                _features("style_encoder", feat, real, args.batch_size),
                _features("style_encoder", feat, fake, args.batch_size))

    if ocr_sd is not None:
        from ..models.ocr import CTCRecognizer
        from ..ops.ctc import collapse_and_decode, greedy_frame_ids

        # the alphabet follows --language (the nor/cvl recognizers have more classes)
        alphabet = {"nor": OCR_NOR, "cvl": OCR_CVL}.get(args.language, OCR_ENG)
        ocr = CTCRecognizer(num_classes=len(alphabet))
        ocr.load_state_dict(ocr_sd)
        ocr = ocr.to(device, memory_format=torch.channels_last).eval().requires_grad_(False)
        hits, t0 = 0, time.perf_counter()
        for s in range(0, len(fake), args.batch_size):
            chunk = fake[s:s + args.batch_size]
            with torch.no_grad():
                logits = ocr(torch.from_numpy(chunk[..., :1]).to(device))
            decoded = collapse_and_decode(greedy_frame_ids(logits).cpu().numpy(), alphabet)
            hits += sum(d == w for d, w in zip(decoded, fake_words[s:s + len(chunk)]))
        dt = time.perf_counter() - t0
        logging.info("featurizer ocr: %d images in %.3f s (%.1f images/s)", len(fake), dt,
                     len(fake) / max(dt, 1e-9))
        results["ocr_exact_match"] = hits / max(len(fake), 1)

    if phosc_fn is not None:
        _zsl(args, phosc_fn, fake, fake_words, results)

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    return results


def _zsl(args, phosc_fn, fake, fake_words, results) -> None:
    """``phosc_zsl_accuracy`` over the generated images whose filename word
    the language's PHOS tables embed (the JAX CLI's rules and notes)."""
    from ..data.phosc import phosc_vector
    from ..eval.fid import phosc_resize
    from ..eval.zsl import zsl_accuracy

    try:
        phosc_vector("a", args.language)
        version_ok = True
    except KeyError:
        version_ok = False
        results["phosc_zsl_note"] = (
            f"no PHOS tables for language '{args.language}'; ZSL skipped")
    cache: dict[str, bool] = {}

    def embeddable(w: str) -> bool:
        if w not in cache:
            try:
                phosc_vector(w, args.language)
                cache[w] = True
            except KeyError:
                cache[w] = False
        return cache[w]

    keep = [i for i, w in enumerate(fake_words) if embeddable(w)] if version_ok else []
    if keep:
        vfake = fake[keep]
        vwords = [fake_words[i] for i in keep]

        def phosc_batches():
            for s in range(0, len(vfake), args.batch_size):
                chunk = vfake[s:s + args.batch_size]
                yield phosc_resize(chunk), vwords[s:s + len(chunk)]

        acc, _ = zsl_accuracy(phosc_fn, phosc_batches(), list(dict.fromkeys(vwords)),
                              args.language)
        results["phosc_zsl_accuracy"] = acc
        if len(keep) < len(fake_words):
            results["phosc_zsl_n"] = len(keep)
    elif version_ok:
        results["phosc_zsl_note"] = "no PHOS-embeddable filename words; ZSL skipped"


if __name__ == "__main__":
    main()
