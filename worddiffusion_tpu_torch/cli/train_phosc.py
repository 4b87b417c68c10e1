"""PHOSC recognizer train/test CLI (port of
``worddiffusion_tpu/cli/train_phosc.py``): AdamW + reduce-on-plateau,
per-epoch ZSL validation, best-checkpoint retention, csv log, ZSL/GZSL
testing, stop flag.

    python -m worddiffusion_tpu_torch.cli.train_phosc --train_csv T --valid_csv V \\
        --image_dir DIR --model resnet18 --save_dir OUT [--device cpu]
    python -m worddiffusion_tpu_torch.cli.train_phosc --mode test --train_csv T \\
        --test_csv S --image_dir DIR --model resnet18 --save_dir OUT [--len_counter P]

Checkpoints are the JAX CLI's: ``best_params.pkl`` is a pickled tree of
numpy arrays under flax's names (``models.convert``), so a checkpoint of
either package evaluates in the other. The word crops are PNGs read with
``data.png``; batches are uint8 [B, 50, 250, 3] in the JAX CLI's order, and
the [-1, 1] normalisation runs on the device. Without a gt file, or with
``--synthetic 1``, the splits are the JAX CLI's synthetic zero-shot split,
and a missing crop is drawn by ``data.synthetic.render_word`` (in its
writer's style with ``--writer_styles 1``). The augmentation (PIL and
OpenCV) and non-PNG crops raise: they wait for slice 12 of the port.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import time

import numpy as np
import torch

from .train import SLICE_12


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PHOSC recognizer trainer")
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--model", default="vgg", choices=["vgg", "resnet18"])
    p.add_argument("--train_csv", default="", help="gt file (any supported format)")
    p.add_argument("--valid_csv", default="")
    p.add_argument("--test_csv", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--phos_size", type=int, default=165,
                   help="unused, as in the JAX CLI: --language sets the sizes")
    p.add_argument("--phoc_size", type=int, default=604,
                   help="unused, as in the JAX CLI: --language sets the sizes")
    p.add_argument("--language", default="eng", choices=["eng", "gw", "nor"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save_dir", default="./runs/phosc")
    p.add_argument("--flagFile", default="")
    p.add_argument("--prompt", type=int, default=0,
                   help="visual prompt tuning: refused (the JAX CLI initialises a "
                        "prompter and never applies or trains it)")
    p.add_argument("--plateau", type=int, default=1,
                   help="0: plain AdamW (no reduce-on-plateau)")
    p.add_argument("--plateau_patience", type=int, default=5,
                   help="reduce-on-plateau patience in EPOCHS (reference "
                        "ReduceLROnPlateau patience=5)")
    p.add_argument("--n_synth", type=int, default=200,
                   help="synthetic mode: training-set size")
    p.add_argument("--synthetic", type=int, default=0,
                   help="synthetic zero-shot split (rendered words)")
    p.add_argument("--renders_per_word", type=int, default=8,
                   help="synthetic mode: renders per vocabulary word")
    p.add_argument("--augment", type=int, default=0,
                   help="train-time augmentation probability in percent: only 0 "
                        f"is ported ({SLICE_12})")
    p.add_argument("--writer_styles", type=int, default=0,
                   help="render each synthetic sample in its writer's style")
    p.add_argument("--len_counter", default="",
                   help="test mode: charcounter params.pkl; adds the "
                        "length-estimation evaluation")
    p.add_argument("--counter_outputs", type=int, default=17)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gamma_points", type=int, default=51,
                   help="test mode: points on the [0, 0.5] GZSL margin grid swept "
                        "for calibrated stacking and the valmargin choice")
    p.add_argument("--calib_words_fraction", type=float, default=0.0,
                   help="hold this fraction of the TRAIN vocabulary out of training "
                        "as an unseen calibration split (calib_words.json), which "
                        "--mode test uses to choose the GZSL seen-class margin")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    return p


def _refuse_unported(args) -> None:
    if args.prompt:
        raise NotImplementedError(
            "--prompt 1 is refused: the JAX CLI initialises a FixedPatchPrompter and "
            "never applies or trains it, so its visual prompt tuning is a silent "
            "no-op (ROADMAP C)")
    if args.augment:
        raise NotImplementedError("--augment > 0 is not ported: the augmentation uses "
                                  f"PIL and OpenCV ({SLICE_12})")


def _load_split(path: str, synthetic: int, language: str, n_synth: int = 200,
                split: str = "train", renders_per_word: int = 8):
    """The samples of a gt file; without one, or with ``synthetic``, the JAX
    CLI's zero-shot split: the first 80% of ``word_list(max(10, n_synth //
    8))`` trains (``renders_per_word`` renders each, capped at ``n_synth *
    renders_per_word // 8``), the rest validates and tests (8 renders each)."""
    from ..data.gt import parse_gt
    from ..data.synthetic import synthetic_corpus, word_list

    if synthetic or not path:
        vocab = word_list(max(10, n_synth // 8), language)
        cut = max(1, int(len(vocab) * 0.8))
        words = vocab[:cut] if split == "train" else vocab[cut:]
        per_word = renders_per_word if split == "train" else 8
        samples = synthetic_corpus(words=words, samples_per_word=per_word)
        if split == "train":
            samples = samples[: n_synth * renders_per_word // 8]
        return samples
    samples, _ = parse_gt(path)
    return samples


def _split(args, path: str, split: str):
    return _load_split(path, args.synthetic, args.language, n_synth=args.n_synth, split=split,
                       renders_per_word=args.renders_per_word)


# key (image, word, writer when styled): split image names can collide.
# Bounded: on a real corpus (100k+ crops at 50x250x3 each) an unbounded
# cache grows to several GB; past the cap the oldest-inserted entry goes.
_RENDER_CACHE: dict = {}
_RENDER_CACHE_CAP = 20_000


def _load_crop(path: str, sample=None, style: dict | None = None) -> np.ndarray:
    """The crop at ``path`` resize-padded to 50 x 250; where there is no
    file, ``sample``'s word drawn by the synthetic renderer (seeded by its
    image name, in ``style``)."""
    from ..data.png import read_png
    from ..data.synthetic import render_word, stable_seed
    from ..utils.images import resize_and_pad

    if path and os.path.exists(path):
        try:
            arr = read_png(path)
        except ValueError as e:
            raise NotImplementedError(f"{e}: the port reads 8-bit PNG crops only (other "
                                      f"formats: {SLICE_12})") from e
    elif sample is None:
        raise FileNotFoundError(f"no crop at {path!r} (--image_dir names the crops' folder)")
    else:
        arr = render_word(sample.word, 50, 250, seed=stable_seed(sample.image), style=style)
    return resize_and_pad(arr, 50, 250)


def _image_batches(samples, image_dir: str, batch_size: int,
                   rng: np.random.Generator | None = None, writer_styles: bool = False,
                   drop_remainder: bool = True):
    """Yield (images uint8 [B, 50, 250, 3], words) in the JAX CLI's order
    (one ``rng.shuffle`` of the sample order). ``drop_remainder=False``
    (every evaluation) also yields the last partial batch. A sample without
    a crop is rendered, in its writer's style with ``writer_styles``."""
    from ..data.synthetic import writer_style

    order = np.arange(len(samples))
    if rng is not None:
        rng.shuffle(order)
    stop = len(samples) - batch_size + 1 if drop_remainder else len(samples)
    for start in range(0, max(stop, 0), batch_size):
        imgs, words = [], []
        for i in order[start:start + batch_size]:
            s = samples[int(i)]
            key = (s.image, s.word, s.writer if writer_styles else "")
            arr = _RENDER_CACHE.get(key)
            if arr is None:
                path = os.path.join(image_dir, s.image) if image_dir else ""
                arr = _load_crop(path, s, writer_style(s.writer) if writer_styles else None)
                if len(_RENDER_CACHE) >= _RENDER_CACHE_CAP:
                    _RENDER_CACHE.pop(next(iter(_RENDER_CACHE)))
                _RENDER_CACHE[key] = arr
            imgs.append(arr)
            words.append(s.word)
        yield np.stack(imgs), words


def dev_norm(imgs: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 NHWC on the host -> [-1, 1] float32 on ``device`` (the host ships
    uint8: a quarter of the bytes)."""
    return torch.from_numpy(imgs).to(device).float() / 127.5 - 1.0


def eval_fn(model, device: torch.device):
    """uint8 image batches -> the model's {"phos", "phoc"}, without dropout or
    a gradient (every evaluation's ``apply_fn``)."""
    def apply(imgs):
        with torch.no_grad():
            return model(dev_norm(imgs, device))

    return apply


def train_step(model, optimizer, imgs: torch.Tensor, tp: torch.Tensor, tc: torch.Tensor,
               generator: torch.Generator, plateau=None, base_lr: float = 0.0,
               value: float = 0.0) -> torch.Tensor:
    """One AdamW step on ``phosc_loss`` with dropout (masks from
    ``generator``); with ``plateau`` the step's lr is ``base_lr`` x its scale
    after ``plateau.update(value)``, as optax's chain scales the update.
    Returns the loss (on the device)."""
    from ..models.phoscnet import phosc_loss

    loss = phosc_loss(model(imgs, deterministic=False, generator=generator), tp, tc)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if plateau is not None:
        plateau.apply(optimizer, base_lr, value)
    optimizer.step()
    return loss.detach()


def build_model(args, device: torch.device, params: dict | None = None):
    """The CLI's PHOSCNet on ``device`` in channels_last memory: seeded
    flax-default init, or ``params`` (a JAX-layout tree)."""
    from ..data.alphabets import phoc_dim, phos_dim
    from ..models.convert import jax_phoscnet_to_torch, state_dict_to_torch
    from ..models.layers import init_weights_
    from ..models.phoscnet import PHOSCNet

    model = PHOSCNet(phos_size=phos_dim(args.language), phoc_size=phoc_dim(args.language),
                     trunk=args.model)
    if params is None:
        init_weights_(model, seed=args.seed)
    else:
        model.load_state_dict(state_dict_to_torch(jax_phoscnet_to_torch(params)))
    return model.to(device, memory_format=torch.channels_last)


def _save_best(model, save_dir: str, calib_payload) -> None:
    """``best_params.pkl`` (atomic, the JAX layout) and, in lockstep with it,
    the calibration record it was trained with (or none)."""
    from ..models.convert import torch_phoscnet_to_jax, write_params_pickle

    write_params_pickle(torch_phoscnet_to_jax(model.state_dict()),
                        os.path.join(save_dir, "best_params.pkl"))
    calib_path = os.path.join(save_dir, "calib_words.json")
    if calib_payload is not None:
        with open(calib_path + ".tmp", "w") as f:
            json.dump(calib_payload, f)
        os.replace(calib_path + ".tmp", calib_path)
    elif os.path.exists(calib_path):
        os.remove(calib_path)
        logging.info("removed stale calib_words.json (trained with "
                     "--calib_words_fraction 0)")


def _train(args, model, train_samples, valid_samples, calib_payload, device) -> list[dict]:
    from ..data.phoc import phoc_labels
    from ..data.phos import phos_labels
    from ..eval.zsl import zsl_accuracy
    from ..train.plateau import ReduceOnPlateau
    from ..train.state import make_optimizer
    from ..utils.stop_flag import StopFlag

    # reduce-on-plateau on the validation ZSL accuracy, as the JAX CLI
    # configures optax's (the reference's ReduceLROnPlateau(opt, 'max',
    # factor=0.25, patience=5, threshold=1e-4, cooldown=2) in steps): one
    # value a step, the last validation accuracy negated, +1e9 before the
    # first validation
    steps_per_epoch = max(1, len(train_samples) // args.batch_size)
    optimizer = make_optimizer(model.parameters(), args.lr, weight_decay=5e-5)
    plateau = ReduceOnPlateau(factor=0.25, patience=args.plateau_patience * steps_per_epoch,
                              cooldown=2 * steps_per_epoch, atol=1e-4) if args.plateau else None
    words = sorted({s.word for s in train_samples})
    phos_map = phos_labels(words, args.language)
    phoc_map = phoc_labels(words, args.language)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    stop = StopFlag(args.flagFile or None)
    log_path = os.path.join(args.save_dir, "log.csv")
    with open(log_path, "a", newline="") as f:
        csv.writer(f).writerow(["epoch", "loss", "zsl_acc", "lr"])
    np_rng = np.random.default_rng(args.seed)
    plateau_value, best_acc, history = 1e9, -1.0, []
    for epoch in range(args.epochs):
        if stop.should_stop():
            logging.info("flag stop at epoch %d", epoch)
            break
        t0 = time.perf_counter()
        losses = []
        for imgs, batch_words in _image_batches(train_samples, args.image_dir, args.batch_size,
                                                np_rng, writer_styles=bool(args.writer_styles)):
            tp = torch.from_numpy(np.stack([phos_map[w] for w in batch_words])).to(device)
            tc = torch.from_numpy(np.stack([phoc_map[w] for w in batch_words])).to(device)
            losses.append(train_step(model, optimizer, dev_norm(imgs, device), tp.float(),
                                     tc.float(), generator, plateau, args.lr, plateau_value))
        mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
                     if losses else 0.0)
        seconds = time.perf_counter() - t0
        valid = _image_batches(valid_samples, args.image_dir, args.batch_size,
                               drop_remainder=False)
        acc, _ = zsl_accuracy(eval_fn(model, device), valid, [s.word for s in valid_samples],
                              args.language)
        plateau_value = -acc
        lr_now = args.lr * (float(plateau.scale) if plateau is not None else 1.0)
        logging.info("epoch %d loss %.4f zsl %.4f lr %.2e", epoch, mean_loss, acc, lr_now)
        with open(log_path, "a", newline="") as f:
            csv.writer(f).writerow([epoch, mean_loss, acc, lr_now])
        history.append(dict(epoch=epoch, loss=mean_loss, zsl=acc, lr=lr_now, steps=len(losses),
                            train_seconds=seconds))
        if acc > best_acc:
            best_acc = acc
            _save_best(model, args.save_dir, calib_payload)
    return history


def _test(args, model, train_samples, test_samples, device) -> dict:
    from ..eval.zsl import (gzsl_accuracy, gzsl_accuracy_with_margin,
                            gzsl_calibrated_stacking, zsl_accuracy, zsl_gzsl_with_length)

    fn = eval_fn(model, device)

    def batches(samples):
        return _image_batches(samples, args.image_dir, args.batch_size, drop_remainder=False)

    # the margin-calibration construct: the held-out words of calib_words.json
    # (never trained, disjoint from the test split), else pseudo-unseen words
    # drawn from the trained vocabulary
    calib_path = os.path.join(args.save_dir, "calib_words.json")
    if os.path.exists(calib_path):
        with open(calib_path) as f:
            calib_words = set(json.load(f))
        seen_samples = [s for s in train_samples if s.word not in calib_words]
        pu = [s for s in train_samples if s.word in calib_words]
        ps = seen_samples
    else:
        seen_samples = train_samples
        seen_vocab = sorted({s.word for s in train_samples})
        np.random.default_rng(args.seed).shuffle(seen_vocab)
        ps_words = set(seen_vocab[:max(1, int(len(seen_vocab) * 0.8))])
        ps = [s for s in train_samples if s.word in ps_words]
        pu = [s for s in train_samples if s.word not in ps_words]

    seen_words, test_words = [s.word for s in seen_samples], [s.word for s in test_samples]
    acc, by_len = zsl_accuracy(fn, batches(test_samples), test_words, args.language)
    gz = gzsl_accuracy(fn, batches(seen_samples), batches(test_samples), seen_words, test_words,
                       args.language)
    gammas = np.linspace(0.0, 0.5, max(2, args.gamma_points))
    cal = gzsl_calibrated_stacking(fn, batches(seen_samples), batches(test_samples), seen_words,
                                   test_words, args.language, gammas=gammas)
    # the margin chosen on the calibration construct, applied to the test
    # decision: a lookup on cal's curve (the same grid), else one evaluation
    val_best = gzsl_calibrated_stacking(fn, batches(ps), batches(pu), [s.word for s in ps],
                                        [s.word for s in pu], args.language,
                                        gammas=gammas)["best"]
    hit = next((r for r in cal["curve"] if abs(r["gamma"] - val_best["gamma"]) < 1e-9), None)
    if hit is not None:
        vm = {"gamma": float(val_best["gamma"]), "seen": hit["seen"], "unseen": hit["unseen"],
              "harmonic_mean": hit["harmonic_mean"]}
    else:
        vm = gzsl_accuracy_with_margin(fn, batches(seen_samples), batches(test_samples),
                                       seen_words, test_words, gamma=val_best["gamma"],
                                       version=args.language)
    with_len = None
    if args.len_counter:
        counter_fn = _counter_fn(args, device)
        seen_vocab = sorted(set(seen_words))
        union_vocab = sorted(set(seen_words) | set(test_words))
        with_len = zsl_gzsl_with_length(fn, batches(test_samples), seen_vocab, union_vocab,
                                        counter_fn=counter_fn, version=args.language)
    logging.info("ZSL test acc %.4f by-len %s GZSL %s calibrated-best %s val-margin %s "
                 "with-length %s", acc, by_len, gz, cal["best"], vm, with_len)
    with open(os.path.join(args.save_dir, "testresults.txt"), "a") as f:
        f.write(f"zsl={acc}\nby_len={by_len}\n")
        f.write(f"gzsl_seen={gz['seen']}\ngzsl_unseen={gz['unseen']}\n"
                f"gzsl_harmonic={gz['harmonic_mean']}\n")
        b = cal["best"]
        f.write(f"gzsl_calibrated_gamma={b['gamma']}\n"
                f"gzsl_calibrated_seen={b['seen']}\n"
                f"gzsl_calibrated_unseen={b['unseen']}\n"
                f"gzsl_calibrated_harmonic={b['harmonic_mean']}\n")
        f.write(f"gzsl_valmargin_gamma={vm['gamma']}\n"
                f"gzsl_valmargin_seen={vm['seen']}\n"
                f"gzsl_valmargin_unseen={vm['unseen']}\n"
                f"gzsl_valmargin_harmonic={vm['harmonic_mean']}\n")
        if with_len is not None:
            f.write(f"len_zsl={with_len['zsl']}\n"
                    f"len_gzsl={with_len['gzsl']}\n"
                    f"length_accuracy={with_len['length_accuracy']}\n"
                    f"length_fuzzy_accuracy={with_len['length_fuzzy_accuracy']}\n")
    return dict(zsl=acc, by_len=by_len, gzsl=gz, calibrated=cal["best"], valmargin=vm,
                with_length=with_len)


def _counter_fn(args, device: torch.device):
    """The trained character counter (``--len_counter``, a JAX-layout
    params.pkl) as the reference's thresholded multi-hot length vector:
    ``(lv > 0.5).sum(-1) == argmax + 1``."""
    from ..models.charcounter import CharacterCounterNet
    from ..models.convert import jax_charcounter_to_torch, read_params_pickle, state_dict_to_torch

    counter = CharacterCounterNet(outputs=args.counter_outputs)
    counter.load_state_dict(state_dict_to_torch(jax_charcounter_to_torch(
        read_params_pickle(args.len_counter))))
    counter = counter.to(device, memory_format=torch.channels_last).requires_grad_(False)
    slots = torch.arange(args.counter_outputs, device=device)

    def counter_fn(images):
        with torch.no_grad():
            pred = torch.argmax(counter(dev_norm(images, device)), dim=-1) + 1
        return (slots[None, :] < pred[:, None]).float()

    return counter_fn


def main(argv=None):
    """Train mode returns the model and a record per epoch; test mode the
    results it writes to testresults.txt."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)

    os.makedirs(args.save_dir, exist_ok=True)
    best_path = os.path.join(args.save_dir, "best_params.pkl")
    if args.mode == "test" and not os.path.exists(best_path):
        # fail fast: test mode evaluates the best checkpoint, never fresh init
        raise SystemExit(f"--mode test needs trained weights: {best_path} not found "
                         f"(run --mode train with the same --save_dir first)")
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    train_samples = _split(args, args.train_csv, "train")
    if args.mode == "test":
        from ..models.convert import read_params_pickle

        model = build_model(args, device, read_params_pickle(best_path))
        return _test(args, model, train_samples, _split(args, args.test_csv, "test"), device)

    # GZSL margin-calibration holdout: a fraction of the TRAIN vocabulary kept
    # out of training entirely (calib_words.json). The record on disk always
    # describes the checkpoint on disk: it changes only with a best_params.pkl
    # write (``_save_best``), so a run stopped before its first checkpoint
    # leaves the previous pair intact.
    calib_payload = None
    if args.calib_words_fraction > 0:
        vocab = sorted({s.word for s in train_samples})
        np.random.default_rng(args.seed).shuffle(vocab)
        k = max(1, int(len(vocab) * args.calib_words_fraction))
        calib_payload = sorted(vocab[:k])
        held = set(calib_payload)
        train_samples = [s for s in train_samples if s.word not in held]
        logging.info("calibration holdout: %d words held out, %d words trained",
                     len(held), len({s.word for s in train_samples}))
    valid_samples = _split(args, args.valid_csv, "valid")
    model = build_model(args, device)
    return dict(model=model, history=_train(args, model, train_samples, valid_samples,
                                            calib_payload, device))


if __name__ == "__main__":
    main()
