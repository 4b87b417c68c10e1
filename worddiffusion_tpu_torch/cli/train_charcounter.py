"""Character-counter trainer (port of
``worddiffusion_tpu/cli/train_charcounter.py``): a CNN classifying word
length 1..17 from the word image, trained with Adam (optax's defaults).

    python -m worddiffusion_tpu_torch.cli.train_charcounter --gt_train T \\
        --image_dir DIR --save_dir OUT [--balance N] [--device cpu]

``params.pkl`` is the JAX CLI's: a pickled tree of numpy arrays under
flax's names, which ``train_phosc --len_counter`` of either package reads.
The crops are PNGs or JPEGs (``data.png.read_image``); without
``--gt_train``, or with ``--synthetic 1``, the corpus is the JAX CLI's
synthetic one, and a missing crop is drawn by ``data.synthetic.render_word``.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--gt_train", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--outputs", type=int, default=17)
    p.add_argument("--save_dir", default="./runs/charcounter")
    p.add_argument("--balance", type=int, default=0,
                   help="balance samples per word length")
    p.add_argument("--synthetic", type=int, default=0,
                   help="the synthetic corpus (rendered words)")
    p.add_argument("--samples_per_word", type=int, default=16,
                   help="synthetic mode: renders per vocabulary word")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def main(argv=None):
    """-> the trained model (its parameters also in ``save_dir/params.pkl``)."""
    from ..data.gt import parse_gt
    from ..data.manipulate import balance_by_length
    from ..data.synthetic import synthetic_corpus
    from ..models.charcounter import CharacterCounterNet, counter_loss, length_onehot
    from ..models.convert import torch_charcounter_to_jax, write_params_pickle
    from ..models.layers import init_weights_
    from ..utils.images import normalize_to_unit
    from .train_phosc import _load_crop

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    if args.synthetic or not args.gt_train:
        samples = synthetic_corpus(samples_per_word=args.samples_per_word)
    else:
        samples, _ = parse_gt(args.gt_train)
    if args.balance:
        samples = balance_by_length(samples, args.balance, args.seed)

    def load(s):
        path = os.path.join(args.image_dir, s.image) if args.image_dir else ""
        return normalize_to_unit(_load_crop(path, s))

    model = init_weights_(CharacterCounterNet(outputs=args.outputs), seed=args.seed)
    model = model.to(device, memory_format=torch.channels_last)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    np_rng = np.random.default_rng(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    for epoch in range(args.epochs):
        order = np_rng.permutation(len(samples))
        losses, correct, total = [], 0, 0
        for start in range(0, len(samples) - args.batch_size + 1, args.batch_size):
            batch = [samples[i] for i in order[start:start + args.batch_size]]
            imgs = torch.from_numpy(np.stack([load(s) for s in batch])).to(device)
            onehot = length_onehot([s.word for s in batch], args.outputs).to(device)
            loss = counter_loss(model(imgs), onehot)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            with torch.no_grad():  # the accuracy of the updated parameters, as JAX's
                pred = torch.argmax(model(imgs), dim=-1)
            correct += int((pred == torch.argmax(onehot, dim=-1)).sum())
            total += len(batch)
        mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
                     if losses else float("nan"))
        logging.info("epoch %d loss %.4f len-acc %.3f", epoch, mean_loss,
                     correct / max(total, 1))
    write_params_pickle(torch_charcounter_to_jax(model.state_dict()),
                        os.path.join(args.save_dir, "params.pkl"))
    logging.info("saved to %s", args.save_dir)
    return model


if __name__ == "__main__":
    main()
