"""CTC OCR recognizer trainer (port of ``worddiffusion_tpu/cli/train_ocr.py``):
the frozen recognizer of the regeneration accept filter.

    python -m worddiffusion_tpu_torch.cli.train_ocr --synthetic 1 --epochs 5 \\
        --save_dir ./runs/ocr [--device cpu]

Adam after a global-norm clip at 1.0 (optax's ``chain(clip_by_global_norm(1),
adam(lr))``: a norm under 1 leaves the gradients as they are, else each is
divided by the norm; no epsilon is added to it, unlike
``torch.nn.utils.clip_grad_norm_``), the CTC loss with the language's blank
over the W/4 = 64 frames, the recognizer's dropout drawn from a seeded
``torch.Generator``. Each epoch reports the exact match on held-out renders
(the vocabulary at unseen seeds) and writes ``ocr.pt``, the recognizer's
state dict in the port's keys, which ``cli.regenerate --ocr_pt`` and
``cli.evaluate --ocr_pt`` read (the JAX CLI writes an orbax checkpoint,
which their ``--ocr_ckpt`` reads).
``metrics.json`` has the JAX CLI's keys. Without ``--gt_train``, or with
``--synthetic 1``, the corpus is ``--vocab_size`` words of the language's
list rendered by ``data.synthetic.render_word``; so is a missing crop.
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
    p = argparse.ArgumentParser(description="CTC OCR recognizer trainer")
    p.add_argument("--gt_train", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--save_dir", default="./runs/ocr")
    p.add_argument("--lang", default="eng", choices=["eng", "nor", "cvl"])
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--vocab_size", type=int, default=100,
                   help="synthetic mode: number of distinct words")
    p.add_argument("--samples_per_word", type=int, default=32)
    p.add_argument("--eval_renders", type=int, default=4,
                   help="held-out renders per vocab word (unseen seeds)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def alphabet_and_blank(lang: str) -> tuple[str, int]:
    from ..data.alphabets import (OCR_CVL, OCR_CVL_BLANK, OCR_ENG, OCR_ENG_BLANK, OCR_NOR,
                                  OCR_NOR_BLANK)

    return {"eng": (OCR_ENG, OCR_ENG_BLANK), "nor": (OCR_NOR, OCR_NOR_BLANK),
            "cvl": (OCR_CVL, OCR_CVL_BLANK)}[lang]


def grey(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of uint8 RGB: ITU-R 601-2 luma in 16-bit fixed
    point, rounded. -> [H, W, 1]."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)[..., None]


def clip_by_global_norm_(params, max_norm: float = 1.0) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: g / norm * max_norm where the global
    norm is not below ``max_norm``, in place. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def make_optimizer(model, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) at its defaults: b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model, optimizer, imgs, labels, lens, blank: int,
               generator: torch.Generator | None = None, keep=None) -> torch.Tensor:
    """One step: the mean CTC loss with dropout (a mask from ``generator``,
    or ``keep``), the clip, Adam. Returns the loss, on the device."""
    from ..ops.ctc import ctc_loss

    logits = model(imgs, deterministic=False, generator=generator, keep=keep)
    loss = torch.mean(ctc_loss(logits, labels, lens, blank_id=blank))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    clip_by_global_norm_(list(model.parameters()), 1.0)
    optimizer.step()
    return loss.detach()


def heldout_set(words, renders: int) -> tuple[np.ndarray, list[str]]:
    """Each word rendered ``renders`` times at seeds the training never
    uses: [N, 64, 256, 1] in [-1, 1], and the targets."""
    from ..data.synthetic import render_word, stable_seed
    from ..utils.images import normalize_to_unit

    imgs, targets = [], []
    for w in words:
        for j in range(renders):
            arr = render_word(w, 64, 256, seed=10_000_000 + stable_seed(f"{w}|{j}") % 2**20)
            imgs.append(normalize_to_unit(arr[..., :1]))
            targets.append(w)
    return np.stack(imgs), targets


def exact_match(model, imgs: np.ndarray, targets: list[str], alphabet: str,
                device: torch.device, bs: int = 128) -> float:
    from ..ops.ctc import collapse_and_decode, greedy_frame_ids

    decoded: list[str] = []
    with torch.no_grad():
        for start in range(0, len(imgs), bs):
            logits = model(torch.from_numpy(imgs[start:start + bs]).to(device))
            decoded.extend(collapse_and_decode(greedy_frame_ids(logits).cpu().numpy(), alphabet))
    return sum(d == t for d, t in zip(decoded, targets)) / len(targets)


def main(argv=None):
    """-> {"model", "metrics", "history"}; writes ocr.pt and metrics.json."""
    from ..data.gt import parse_gt
    from ..data.png import read_image
    from ..data.synthetic import render_word, stable_seed, synthetic_corpus, word_list
    from ..models.layers import init_weights_
    from ..models.ocr import CTCRecognizer
    from ..ops.ctc import encode_ocr_labels
    from ..utils.images import normalize_to_unit, resize_and_pad

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    alphabet, blank = alphabet_and_blank(args.lang)
    if args.synthetic or not args.gt_train:
        samples = synthetic_corpus(words=word_list(args.vocab_size, lang=args.lang),
                                   samples_per_word=args.samples_per_word)
    else:
        samples, _ = parse_gt(args.gt_train)

    def load(s):
        path = os.path.join(args.image_dir, s.image) if args.image_dir else ""
        if path and os.path.exists(path):
            arr = grey(read_image(path))
        else:
            arr = render_word(s.word, 64, 256, seed=stable_seed(s.image))[..., :1]
        return normalize_to_unit(resize_and_pad(arr, 64, 256))

    model = init_weights_(CTCRecognizer(num_classes=len(alphabet)), seed=args.seed)
    model = model.to(device, memory_format=torch.channels_last)
    optimizer = make_optimizer(model, args.lr)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    eval_words = sorted({s.word for s in samples})
    eval_imgs, eval_targets = heldout_set(eval_words, args.eval_renders)

    np_rng = np.random.default_rng(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    ckpt = os.path.join(args.save_dir, "ocr.pt")
    acc, history = float("nan"), []
    for epoch in range(args.epochs):
        order = np_rng.permutation(len(samples))
        losses, t0 = [], time.perf_counter()
        for start in range(0, len(samples) - args.batch_size + 1, args.batch_size):
            batch = [samples[i] for i in order[start:start + args.batch_size]]
            imgs = torch.from_numpy(np.stack([load(s) for s in batch])).to(device)
            labels, lens = encode_ocr_labels([s.word for s in batch], alphabet, 42)
            losses.append(train_step(model, optimizer, imgs, torch.from_numpy(labels).to(device),
                                     torch.from_numpy(lens).to(device), blank, generator))
        mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
                     if losses else float("nan"))
        seconds = time.perf_counter() - t0
        acc = exact_match(model, eval_imgs, eval_targets, alphabet, device)
        logging.info("epoch %d loss %.4f held-out exact-match %.3f (%d imgs)",
                     epoch, mean_loss, acc, len(eval_targets))
        history.append(dict(epoch=epoch, loss=mean_loss, heldout_exact_match=acc,
                            steps=len(losses), train_seconds=seconds))
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt + ".tmp")
        os.replace(ckpt + ".tmp", ckpt)
    metrics = {"heldout_exact_match": acc, "eval_images": len(eval_targets),
               "vocab_size": len(eval_words), "epochs": args.epochs,
               "train_samples": len(samples)}
    with open(os.path.join(args.save_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f)
    logging.info("saved OCR recognizer to %s (held-out %.3f)", ckpt, acc)
    return dict(model=model, metrics=metrics, history=history)


if __name__ == "__main__":
    main()
