"""The ``python - <<'PYEOF'`` blocks of the JAX repo's chain scripts, as
functions of the paths and sizes the scripts write into them. They use the
port's renderer (``data.synthetic``), PNG writer and reader
(``utils.images``, ``data.png``): no Pillow. Each names its block.
"""

from __future__ import annotations

import collections
import json
import os
import random
import shutil

import numpy as np


def write_gt(out: str, vocab_size: int, samples_per_word: int, lang: str = "eng",
             special_only: bool = False) -> list:
    """The regeneration gt file of the synthetic corpus
    (``iam_chain.sh:45-51``, ``gw_chain.sh:43-50``, ``cvl_chain.sh:42-49``,
    ``nor_chain.sh:28-35``, ``higan_chain.sh:49-56``): one ``writer,image
    word`` row a sample. ``special_only`` keeps the words with an
    æ/ø/å (``nor_special_chain.sh:24-33``). -> the samples."""
    from ..data.synthetic import synthetic_corpus, word_list

    words = word_list(vocab_size, lang)
    if special_only:
        words = [w for w in words if any(c in w for c in "æøåÆØÅ")]
        print("special words:", words)
    samples = synthetic_corpus(words=words, samples_per_word=samples_per_word)
    with open(out, "w") as f:
        for s in samples:
            f.write(f"{s.writer},{s.image.removesuffix('.png')} {s.word}\n")
    print("wrote", len(samples), "rows")
    return samples


def write_real_renders(out_dir: str, vocab_size: int, samples_per_word: int) -> None:
    """The real-render comparison set (``iam_chain.sh:52-58``): each sample
    of the gt file's corpus rendered at 64x256, seeded by its image name."""
    from ..data.synthetic import render_word, stable_seed, synthetic_corpus, word_list
    from ..utils.images import encode_png

    samples = synthetic_corpus(words=word_list(vocab_size), samples_per_word=samples_per_word)
    os.makedirs(out_dir, exist_ok=True)
    for s in samples:
        arr = render_word(s.word, 64, 256, seed=stable_seed(s.image))
        with open(os.path.join(out_dir, s.image), "wb") as f:
            f.write(encode_png(arr))
    print("wrote", len(samples), "real renders")


def _word_of(f: str) -> str:
    return f.rsplit("_", 1)[-1].removesuffix(".png")


def _fill(dst: str, src_dir: str, files) -> None:
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for f in files:
        os.link(os.path.join(src_dir, f), os.path.join(dst, f))


def comparison_subsets(acc_dir: str, rej_dir: str, real_dir: str, floor_a: str, floor_b: str,
                       unfilt: str, acc_bal: str, rej_bal: str) -> dict:
    """The FID rows' subsets (``iam_chain.sh:88-135``), hard links as there:
    ``floor_a`` / ``floor_b`` disjoint halves of the real renders (a
    ``random.Random(0)`` shuffle), each of ``min(accepted, len(real) // 2)``;
    ``unfilt`` the accepted and rejected names sorted, cut to the accepted
    count (an accepted copy wins over a rejected one of the same name);
    ``acc_bal`` / ``rej_bal`` accepted and rejected under the per-word
    minimum of both histograms, in name order. -> the counts it prints."""
    acc = sorted(f for f in os.listdir(acc_dir) if f.endswith(".png"))
    acc_set = set(acc)
    # a resumed regeneration can accept a crop it once rejected: the accepted copy wins
    rej = sorted(f for f in os.listdir(rej_dir) if f.endswith(".png") and f not in acc_set)
    real = sorted(f for f in os.listdir(real_dir) if f.endswith(".png"))
    n = len(acc)
    random.Random(0).shuffle(real)
    half = min(n, len(real) // 2)  # disjoint halves cap at len(real) / 2
    _fill(floor_a, real_dir, real[:half])
    _fill(floor_b, real_dir, real[half:2 * half])
    shutil.rmtree(unfilt, ignore_errors=True)
    os.makedirs(unfilt)
    for f in sorted(acc + rej)[:n]:
        os.link(os.path.join(acc_dir if f in acc_set else rej_dir, f), os.path.join(unfilt, f))
    ha = collections.Counter(_word_of(f) for f in acc)
    hr = collections.Counter(_word_of(f) for f in rej)
    common = {w: min(ha[w], hr[w]) for w in set(ha) & set(hr)}

    def balanced(files):
        left, out = dict(common), []
        for f in files:
            w = _word_of(f)
            if left.get(w, 0) > 0:
                left[w] -= 1
                out.append(f)
        return out

    _fill(acc_bal, acc_dir, balanced(acc))
    _fill(rej_bal, rej_dir, balanced(rej))
    print(f"accepted={n} rejected={len(rej)} balanced={sum(common.values())} "
          f"per-word={common}")
    return dict(accepted=n, rejected=len(rej), balanced=sum(common.values()), half=half)


def montage(regen_dir: str, metrics: str, out: str) -> None:
    """Up to 24 accepted crops in a 4-column grid and the loss curve's ends
    (``higan_chain.sh:66-83``; the JAX block writes the grid into
    ``docs/``, the port's under the runs directory)."""
    from ..data.png import read_image
    from ..utils.images import save_image_grid

    files = sorted(f for f in os.listdir(regen_dir) if f.endswith(".png"))[:24]
    imgs = np.stack([read_image(os.path.join(regen_dir, f)).astype(np.float32) / 255.0
                     for f in files])
    save_image_grid(imgs, out, ncol=4)
    with open(metrics) as f:
        losses = [r for r in map(json.loads, f) if "loss" in r]
    print("montage:", len(files), "accepted crops;",
          f"loss {losses[0]['loss']:.4f} -> {losses[-1]['loss']:.4f} over",
          len(losses), "logged steps")
