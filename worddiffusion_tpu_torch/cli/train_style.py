"""Writer-style encoder trainer (port of ``worddiffusion_tpu/cli/train_style.py``).

    python -m worddiffusion_tpu_torch.cli.train_style --synthetic 1 --epochs 20 \\
        --save_dir ./runs/style [--device cpu]

Trains ``models.style.StyleEncoder`` with a writer-identity triplet loss
(anchor and positive from one writer, the negative from another; triplets
drawn from ``numpy.random.default_rng(seed)`` in the JAX CLI's order) with
``torch.optim.AdamW`` at optax.adamw's defaults (weight decay 1e-4, eps
1e-8), and reports leave-one-out nearest-centroid writer retrieval each
epoch. ``best_params.pkl`` (written atomically at each best retrieval) is
the JAX CLI's: a pickled tree of numpy arrays under flax's names, which
either package reads. ``style_dict.npz`` (writer id -> mean style vector of
the best weights) is the ``--style_dict`` of ``cli.train --wrdChrWrStyl 1``.
Without ``--gt_train``, or with ``--synthetic 1``, the corpus is rendered by
``data.synthetic.render_word`` in each writer's style; real crops are PNGs
(``data.png``).
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="writer-style encoder trainer")
    p.add_argument("--gt_train", default="", help="annotation file (real data)")
    p.add_argument("--image_dir", default="")
    p.add_argument("--synthetic", type=int, default=0,
                   help="writer-styled synthetic renders")
    p.add_argument("--writers", type=int, default=16, help="synthetic writers")
    p.add_argument("--samples_per_writer", type=int, default=24)
    p.add_argument("--img_size", default="64,256")
    p.add_argument("--out_dim", type=int, default=4096,
                   help="style vector size (UNet wrd_proj expects 4096)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=16, help="triplets/step")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--save_dir", default="./runs/style")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def corpus(args) -> dict[str, list[np.ndarray]]:
    """writer -> list of [-1, 1] float32 HWC crops (writers with >= 2)."""
    from ..data.native import batch_normalize

    h, w = (int(v) for v in args.img_size.split(","))
    by_writer: dict[str, list[np.ndarray]] = {}
    if args.synthetic or not args.gt_train:
        from ..data.synthetic import render_word, stable_seed, word_list, writer_style

        words = word_list(max(10, args.samples_per_writer))
        for wi in range(args.writers):
            wid = str(wi)
            style = writer_style(wid)
            crops = [render_word(words[k % len(words)], h, w, seed=stable_seed(f"{wid}|{k}"),
                                 style=style) for k in range(args.samples_per_writer)]
            by_writer[wid] = list(batch_normalize(np.stack(crops)))
    else:
        from ..data.gt import parse_gt
        from ..data.png import read_png
        from ..utils.images import resize_and_pad

        samples, _ = parse_gt(args.gt_train)
        for s in samples:
            p = os.path.join(args.image_dir, s.image) if args.image_dir else ""
            if not (p and os.path.exists(p)):
                continue
            arr = resize_and_pad(read_png(p), h, w)
            by_writer.setdefault(s.writer, []).append(batch_normalize(arr))
    return {k: v for k, v in by_writer.items() if len(v) >= 2}


def retrieval_accuracy(vecs_by_writer: dict[str, np.ndarray]) -> float:
    """Leave-one-out nearest-centroid writer identification over the
    encoded corpus (copy of the JAX CLI's ``_retrieval_accuracy``)."""
    writers = sorted(vecs_by_writer)
    correct = total = 0
    sums = {w: vecs_by_writer[w].sum(axis=0) for w in writers}
    counts = {w: len(vecs_by_writer[w]) for w in writers}
    for w in writers:
        for v in vecs_by_writer[w]:
            cents = np.stack([
                (sums[u] - (v if u == w else 0))
                / (counts[u] - (1 if u == w else 0) or 1)
                for u in writers
            ])
            cents = cents / (np.linalg.norm(cents, axis=-1, keepdims=True) + 1e-8)
            vn = v / (np.linalg.norm(v) + 1e-8)
            total += 1
            correct += writers[int((cents @ vn).argmax())] == w
    return correct / max(total, 1)


def make_optimizer(encoder, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr) at its defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(encoder.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def train_step(encoder, optimizer, anchor, positive, negative, margin: float) -> torch.Tensor:
    """One triplet step (three forwards, as the JAX step applies the encoder
    three times). Returns the loss, on the device."""
    from ..models.style import triplet_loss

    loss = triplet_loss(encoder(anchor), encoder(positive), encoder(negative), margin)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(argv=None):
    """-> {"encoder", "best_acc", "history"}; writes best_params.pkl,
    style_dict.npz and log.csv under --save_dir."""
    from ..models.convert import (jax_style_to_torch, read_params_pickle, state_dict_to_torch,
                                  torch_style_to_jax, write_params_pickle)
    from ..models.layers import init_weights_
    from ..models.style import StyleEncoder

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    os.makedirs(args.save_dir, exist_ok=True)
    by_writer = corpus(args)
    writers = sorted(by_writer)
    if len(writers) < 2:
        raise SystemExit("need at least 2 writers with >=2 crops each")
    logging.info("%d writers, %d crops total", len(writers),
                 sum(len(v) for v in by_writer.values()))

    enc = init_weights_(StyleEncoder(out_dim=args.out_dim), seed=args.seed)
    enc = enc.to(device, memory_format=torch.channels_last)
    optimizer = make_optimizer(enc, args.lr)
    stacks = {wid: torch.from_numpy(np.stack(crops)) for wid, crops in by_writer.items()}

    def encode_corpus() -> dict[str, np.ndarray]:
        with torch.no_grad():
            return {wid: enc(x.to(device)).cpu().numpy() for wid, x in stacks.items()}

    np_rng = np.random.default_rng(args.seed)
    steps_per_epoch = max(1, sum(len(v) for v in by_writer.values()) // args.batch_size)
    log_path = os.path.join(args.save_dir, "log.csv")
    with open(log_path, "a", newline="") as f:
        csv.writer(f).writerow(["epoch", "loss", "retrieval_acc"])
    best_path = os.path.join(args.save_dir, "best_params.pkl")
    best_acc, history = -1.0, []
    for epoch in range(args.epochs):
        losses, t0 = [], time.perf_counter()
        for _ in range(steps_per_epoch):
            anc, pos, neg = [], [], []
            for _ in range(args.batch_size):
                wa, wn = np_rng.choice(len(writers), 2, replace=False)
                ca = by_writer[writers[wa]]
                i, j = np_rng.choice(len(ca), 2, replace=False)
                cn = by_writer[writers[wn]]
                anc.append(ca[i])
                pos.append(ca[j])
                neg.append(cn[np_rng.integers(len(cn))])
            a, p, n = (torch.from_numpy(np.stack(t)).to(device) for t in (anc, pos, neg))
            losses.append(train_step(enc, optimizer, a, p, n, args.margin))
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
        seconds = time.perf_counter() - t0
        acc = retrieval_accuracy(encode_corpus())
        logging.info("epoch %d triplet %.4f retrieval %.3f", epoch, mean_loss, acc)
        with open(log_path, "a", newline="") as f:
            csv.writer(f).writerow([epoch, mean_loss, acc])
        history.append(dict(epoch=epoch, loss=mean_loss, retrieval=acc, steps=len(losses),
                            train_seconds=seconds))
        if acc > best_acc:
            best_acc = acc
            write_params_pickle(torch_style_to_jax(enc.state_dict()), best_path)

    # writer -> vector dict with the best weights; the --style_dict format
    enc.load_state_dict(state_dict_to_torch(jax_style_to_torch(read_params_pickle(best_path))))
    style_dict = {wid: v.mean(axis=0).astype(np.float32) for wid, v in encode_corpus().items()}
    np.savez(os.path.join(args.save_dir, "style_dict.npz"), **style_dict)
    logging.info("style dict (%d writers, %d-d) -> %s ; best retrieval %.3f", len(style_dict),
                 args.out_dim, os.path.join(args.save_dir, "style_dict.npz"), best_acc)
    return dict(encoder=enc, best_acc=best_acc, history=history)


if __name__ == "__main__":
    main()
