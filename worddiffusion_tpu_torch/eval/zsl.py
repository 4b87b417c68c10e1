"""Zero-shot / generalized zero-shot word recognition accuracy (port of
``worddiffusion_tpu/eval/zsl.py``).

Each prediction is decoded by cosine similarity against a lexicon of PHOSC
descriptors: one normalised [B, D] x [D, W] product and an argmax, on the
prediction's device (JAX computes it outside any Pallas kernel, so
``torch.matmul`` computes it here). ``apply_fn(images) -> {"phos", "phoc"}``
returns tensors; batches yield (images, target words). Accuracies are
fractions; the per-length accuracies are percentages, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..data.phosc import lexicon_matrix


def _normalize(m: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + eps)


def _similarity(pred: torch.Tensor, lexicon: torch.Tensor) -> torch.Tensor:
    return _normalize(pred) @ _normalize(lexicon).T


def cosine_decode_indices(pred: torch.Tensor, lexicon: torch.Tensor) -> torch.Tensor:
    """pred [B, D], lexicon [W, D] -> the index [B] of the word of largest
    cosine similarity (the first of equals)."""
    return torch.argmax(_similarity(pred, lexicon), dim=-1)


def decode_words(pred_phosc: np.ndarray, words: Sequence[str],
                 lexicon: np.ndarray) -> list[str]:
    idx = cosine_decode_indices(torch.as_tensor(pred_phosc), torch.as_tensor(lexicon))
    return [words[i] for i in idx.tolist()]


def _pred(out: dict) -> torch.Tensor:
    return torch.cat([out["phos"], out["phoc"]], dim=-1)


class _Lexicon:
    """A lexicon's words and its descriptor matrix, moved once to the device
    of the first prediction it decodes."""

    def __init__(self, words: Sequence[str], version: str):
        self.words, self._mat = lexicon_matrix(list(words), version)
        self._on: torch.Tensor | None = None

    def on(self, pred: torch.Tensor) -> torch.Tensor:
        if self._on is None:
            self._on = torch.from_numpy(self._mat).to(pred.device)
        return self._on


def zsl_accuracy(
    apply_fn: Callable[[np.ndarray], dict],
    batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    lexicon_words: Sequence[str],
    version: str = "eng",
) -> tuple[float, dict[int, float]]:
    """Accuracy of the cosine decode against the lexicon of candidate words
    -> (accuracy, per-length accuracy in percent)."""
    lex = _Lexicon(lexicon_words, version)
    correct = total = 0
    by_len_correct: dict[int, int] = {}
    by_len_total: dict[int, int] = {}
    for images, targets in batches:
        pred = _pred(apply_fn(images))
        idx = cosine_decode_indices(pred, lex.on(pred)).tolist()
        for i, target in enumerate(targets):
            L = len(target)
            by_len_total[L] = by_len_total.get(L, 0) + 1
            total += 1
            if lex.words[idx[i]] == target:
                correct += 1
                by_len_correct[L] = by_len_correct.get(L, 0) + 1
    acc_by_len = {L: 100.0 * by_len_correct.get(L, 0) / n for L, n in by_len_total.items()}
    return correct / max(total, 1), acc_by_len


def _harmonic(a_s: float, a_u: float) -> float:
    return 2 * a_s * a_u / (a_s + a_u) if (a_s + a_u) > 0 else 0.0


def gzsl_accuracy(
    apply_fn: Callable[[np.ndarray], dict],
    seen_batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    unseen_batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    seen_words: Sequence[str],
    unseen_words: Sequence[str],
    version: str = "eng",
) -> dict:
    """GZSL: both splits decoded against the UNION lexicon; seen and unseen
    accuracy and their harmonic mean."""
    union = list(dict.fromkeys(list(seen_words) + list(unseen_words)))
    acc_seen, _ = zsl_accuracy(apply_fn, seen_batches, union, version)
    acc_unseen, _ = zsl_accuracy(apply_fn, unseen_batches, union, version)
    return {"seen": acc_seen, "unseen": acc_unseen,
            "harmonic_mean": _harmonic(acc_seen, acc_unseen)}


def gzsl_calibrated_stacking(
    apply_fn: Callable[[np.ndarray], dict],
    seen_batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    unseen_batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    seen_words: Sequence[str],
    unseen_words: Sequence[str],
    version: str = "eng",
    gammas: Optional[Sequence[float]] = None,
) -> dict:
    """GZSL with calibrated stacking (Chao et al., ECCV 2016): a bias
    ``gamma`` subtracted from every SEEN word's cosine score before the
    union-lexicon argmax, swept over ``gammas``: the seen/unseen curve and
    its best-harmonic-mean point. A diagnostic on top of the reference's
    uncalibrated protocol (gamma is swept on the evaluation split itself)."""
    union = list(dict.fromkeys(list(seen_words) + list(unseen_words)))
    lex = _Lexicon(union, version)
    words = lex.words
    in_seen = set(seen_words)
    seen_mask = np.array([w in in_seen for w in words], np.float32)

    def collect(batches):
        sims, targets = [], []
        for images, tg in batches:
            pred = _pred(apply_fn(images))
            sims.append(_similarity(pred, lex.on(pred)).cpu().numpy())
            targets.extend(tg)
        return (np.concatenate(sims) if sims else np.zeros((0, len(words)))), targets

    s_sim, s_tg = collect(seen_batches)
    u_sim, u_tg = collect(unseen_batches)
    if gammas is None:
        gammas = np.linspace(0.0, 0.5, 26)

    def acc(sim, tg, g):
        if not tg:
            return 0.0
        idx = (sim - g * seen_mask).argmax(axis=1)
        return float(np.mean([words[i] == t for i, t in zip(idx, tg)]))

    curve = []
    for g in gammas:
        a_s, a_u = acc(s_sim, s_tg, g), acc(u_sim, u_tg, g)
        curve.append({"gamma": round(float(g), 4), "seen": a_s, "unseen": a_u,
                      "harmonic_mean": _harmonic(a_s, a_u)})
    return {"best": max(curve, key=lambda r: r["harmonic_mean"]), "curve": curve}


def gzsl_accuracy_with_margin(
    apply_fn: Callable[[np.ndarray], dict],
    seen_batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    unseen_batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    seen_words: Sequence[str],
    unseen_words: Sequence[str],
    gamma: float,
    version: str = "eng",
) -> dict:
    """The reference GZSL rule (union-lexicon cosine argmax) with ONE fixed
    seen-class margin ``gamma``, chosen elsewhere (e.g. on a validation
    construct, as ``cli/train_phosc`` test mode does)."""
    cal = gzsl_calibrated_stacking(apply_fn, seen_batches, unseen_batches, seen_words,
                                   unseen_words, version, gammas=[float(gamma)])
    r = cal["curve"][0]
    return {"gamma": float(gamma), "seen": r["seen"], "unseen": r["unseen"],
            "harmonic_mean": r["harmonic_mean"]}


def zsl_gzsl_with_length(
    apply_fn: Callable[[np.ndarray], dict],
    batches: Iterable[tuple[np.ndarray, Sequence[str]]],
    seen_words: Sequence[str],
    union_words: Sequence[str],
    counter_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    threshold: float = 0.5,
    version: str = "eng",
) -> dict:
    """Each prediction decoded against the seen lexicon (zsl) and the union
    lexicon (gzsl); with ``counter_fn`` (a multi-hot over length slots,
    thresholded and summed) also the exact and the fuzzy (+-1, exact hits
    not counted again) length accuracy."""
    seen, union = _Lexicon(seen_words, version), _Lexicon(union_words, version)
    n = zsl_ok = gzsl_ok = len_ok = len_fuzzy = 0
    for images, targets in batches:
        pred = _pred(apply_fn(images))
        zi = cosine_decode_indices(pred, seen.on(pred)).tolist()
        gi = cosine_decode_indices(pred, union.on(pred)).tolist()
        len_pred = None
        if counter_fn is not None:
            lv = np.asarray(torch.as_tensor(counter_fn(images)).cpu())
            len_pred = (lv > threshold).sum(axis=-1)
        for i, target in enumerate(targets):
            n += 1
            zsl_ok += seen.words[zi[i]] == target
            gzsl_ok += union.words[gi[i]] == target
            if len_pred is not None:
                exact = int(len_pred[i]) == len(target)
                len_ok += exact
                len_fuzzy += (not exact) and abs(int(len_pred[i]) - len(target)) <= 1
    res = {"zsl": zsl_ok / max(n, 1), "gzsl": gzsl_ok / max(n, 1)}
    if counter_fn is not None:
        res["length_accuracy"] = len_ok / max(n, 1)
        res["length_fuzzy_accuracy"] = len_fuzzy / max(n, 1)
    return res


def split_seen_unseen(samples: Sequence, seen_fraction: float = 0.8,
                      seed: int = 0) -> tuple[list, list]:
    """Word-level ZSL split: unseen words never appear in training."""
    words = sorted({s.word for s in samples})
    rng = np.random.default_rng(seed)
    rng.shuffle(words)
    seen_words = set(words[:int(len(words) * seen_fraction)])
    return ([s for s in samples if s.word in seen_words],
            [s for s in samples if s.word not in seen_words])
