"""The port's zero-shot evaluation (``eval/zsl.py``) and FID harness (its
PHOSC featurizer; the numpy copies: ``test_torch_copies.py``) against the
JAX package's, on seeded predictions and lexicons. Decoded indices and
accuracies must be equal: the predictions sit near their target's
descriptor, and the near-ties between two words are built with a cosine
margin (at least 1e-4) far above the fp32 rounding of the two products
(about 1e-7). The PHOSC featurizer reads a JAX-written
pickle, and its features compare in fp32 to 1e-4 of max |JAX|."""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.data.gt import Sample as JSample
from worddiffusion_tpu.data.phosc import lexicon_matrix
from worddiffusion_tpu.eval import fid as jfid
from worddiffusion_tpu.eval import zsl as jzsl
from worddiffusion_tpu.models import phoscnet as jphoscnet
from worddiffusion_tpu_torch.data.gt import Sample
from worddiffusion_tpu_torch.eval import fid, zsl
from worddiffusion_tpu_torch.models import phoscnet

torch.set_num_threads(2)

SEEN = ["the", "of", "and", "to", "in", "is", "was", "that", "for", "it"]
UNSEEN = ["with", "as", "his", "on", "be", "at"]


def _predictions(targets, lexicon_words, seed: int) -> np.ndarray:
    """A prediction per target: its descriptor plus noise; every third one a
    near-tie, 52/48 between its target and the next lexicon word."""
    rng = np.random.default_rng(seed)
    words, lex = lexicon_matrix(lexicon_words, "eng")
    rows = []
    for i, t in enumerate(targets):
        v = lex[words.index(t)]
        if i % 3 == 2:
            other = lex[(words.index(t) + 1) % len(words)]
            v = 0.52 * v / np.linalg.norm(v) + 0.48 * other / np.linalg.norm(other)
        else:
            v = v + 0.05 * rng.standard_normal(v.shape)
        rows.append(v)
    pred = np.abs(np.stack(rows)).astype(np.float32)
    # the margin between the two largest cosines, in float64
    unit = lex / np.linalg.norm(lex, axis=1, keepdims=True)
    sims = np.sort((pred / np.linalg.norm(pred, axis=1, keepdims=True)) @ unit.T, axis=1)
    assert (sims[:, -1] - sims[:, -2]).min() > 1e-4
    return pred


def _batches(targets, size: int = 4):
    """(images, targets) batches where the "images" are row indices."""
    return [(np.arange(i, min(i + size, len(targets))), targets[i:i + size])
            for i in range(0, len(targets), size)]


def _apply_fns(pred: np.ndarray, phos: int = 165):
    def jfn(idx):
        p = jnp.asarray(pred[idx])
        return {"phos": p[:, :phos], "phoc": p[:, phos:]}

    def fn(idx):
        p = torch.from_numpy(pred[idx])
        return {"phos": p[:, :phos], "phoc": p[:, phos:]}

    return jfn, fn


@pytest.fixture
def data():
    seen_t = [SEEN[i % len(SEEN)] for i in range(17)]
    unseen_t = [UNSEEN[i % len(UNSEEN)] for i in range(11)]
    union = SEEN + UNSEEN
    return dict(seen_t=seen_t, unseen_t=unseen_t,
                seen_pred=_predictions(seen_t, union, 0),
                unseen_pred=_predictions(unseen_t, union, 1))


def test_cosine_decode_and_decode_words_match_jax(data):
    words, lex = lexicon_matrix(SEEN + UNSEEN, "eng")
    pred = data["seen_pred"]
    want = np.asarray(jzsl.cosine_decode_indices(jnp.asarray(pred), jnp.asarray(lex)))
    got = zsl.cosine_decode_indices(torch.from_numpy(pred), torch.from_numpy(lex)).numpy()
    assert np.array_equal(got, want)
    assert zsl.decode_words(pred, words, lex) == jzsl.decode_words(pred, words, lex)
    # the near-ties decode to their target, the noisy ones too
    assert [words[i] for i in got] == data["seen_t"]


def test_zsl_accuracy_matches_jax(data):
    jfn, fn = _apply_fns(data["unseen_pred"])
    lexicon = UNSEEN[:4]  # two words missing from the lexicon: decoded wrong
    want = jzsl.zsl_accuracy(jfn, _batches(data["unseen_t"]), lexicon)
    got = zsl.zsl_accuracy(fn, _batches(data["unseen_t"]), lexicon)
    assert got == want and 0 < got[0] < 1


def test_gzsl_functions_match_jax(data):
    jfs, fs = _apply_fns(data["seen_pred"])
    jfu, fu = _apply_fns(data["unseen_pred"])

    def both(jfunc, func, *args, **kw):
        # one apply_fn sees both splits: each batch's "images" carry its split
        seen_b = [(("s", i), t) for i, t in _batches(data["seen_t"])]
        unseen_b = [(("u", i), t) for i, t in _batches(data["unseen_t"])]
        j = jfunc(lambda b: {"s": jfs, "u": jfu}[b[0]](b[1]), seen_b, unseen_b, *args, **kw)
        p = func(lambda b: {"s": fs, "u": fu}[b[0]](b[1]), seen_b, unseen_b, *args, **kw)
        return j, p

    j, p = both(jzsl.gzsl_accuracy, zsl.gzsl_accuracy, SEEN, UNSEEN)
    assert p == j and p["seen"] > 0 and p["unseen"] > 0
    gammas = np.linspace(0.0, 0.5, 26)
    j, p = both(jzsl.gzsl_calibrated_stacking, zsl.gzsl_calibrated_stacking, SEEN, UNSEEN,
                gammas=gammas)
    assert p == j and len(p["curve"]) == 26
    j, p = both(jzsl.gzsl_accuracy_with_margin, zsl.gzsl_accuracy_with_margin, SEEN, UNSEEN,
                gamma=0.1)
    assert p == j


def test_zsl_gzsl_with_length_matches_jax(data):
    jfn, fn = _apply_fns(data["seen_pred"])
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 7, len(data["seen_t"]))
    multi = (np.arange(17)[None, :] < lengths[:, None]).astype(np.float32)
    batches = _batches(data["seen_t"])
    for counter in (None, lambda idx: multi[idx]):
        want = jzsl.zsl_gzsl_with_length(jfn, batches, SEEN[:6], SEEN + UNSEEN, counter)
        got = zsl.zsl_gzsl_with_length(fn, batches, SEEN[:6], SEEN + UNSEEN, counter)
        assert got == want
    assert 0 < got["length_accuracy"] < 1 and got["length_fuzzy_accuracy"] > 0


def test_split_seen_unseen_matches_jax():
    rows = [(f"a{i:03d}.png", str(i % 4), SEEN[i % len(SEEN)]) for i in range(40)]
    want = jzsl.split_seen_unseen([JSample(*r) for r in rows], 0.7, seed=5)
    got = zsl.split_seen_unseen([Sample(*r) for r in rows], 0.7, seed=5)
    assert [[(s.image, s.writer, s.word) for s in part] for part in got] == \
        [[(s.image, s.writer, s.word) for s in part] for part in want]


def test_phosc_featurizer_reads_a_jax_pickle(tmp_path, monkeypatch):
    """A JAX-layout best_params.pkl (hidden 32, fp32 compute in both packages:
    the class each loader builds is patched) through both featurizers:
    inputs of another size resized to 50x250, the TPP features."""
    monkeypatch.setattr(jphoscnet, "PHOSCNet", functools.partial(
        jphoscnet.PHOSCNet, hidden=32, dtype=jnp.float32))
    monkeypatch.setattr(phoscnet, "PHOSCNet", functools.partial(
        phoscnet.PHOSCNet, hidden=32, dtype=torch.float32))
    x = np.zeros((1, 50, 250, 3), np.float32)
    params = jax.tree_util.tree_map(np.asarray, jphoscnet.PHOSCNet(trunk="resnet18").init(
        jax.random.PRNGKey(0), x))
    path = tmp_path / "best_params.pkl"
    path.write_bytes(pickle.dumps(params))
    imgs = np.random.default_rng(6).uniform(-1, 1, (2, 40, 160, 3)).astype(np.float32)
    want = jfid.phosc_featurizer(str(path), trunk="resnet18")(imgs)
    got = fid.phosc_featurizer(str(path), trunk="resnet18", device="cpu")(imgs)
    assert got.shape == want.shape == (2, 4096)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    fn, net = fid.load_phosc_net(str(path), trunk="resnet18", device="cpu")
    assert set(fn(fid.phosc_resize(imgs))) == {"phos", "phoc", "features"}
    assert not any(p.requires_grad for p in net.parameters())
