"""The recognizer CLIs against the JAX ones on the CPU: the JAX
``train_phosc`` trains one short epoch (``--model resnet18``) and the JAX
``train_charcounter`` one epoch, on a handful of PNG crops; then both
packages' ``train_phosc --mode test --len_counter`` evaluate the same
JAX-written checkpoints and must write the same results. Both packages'
models are narrowed to hidden 32 heads and fp32 compute by patching the
class each CLI builds (the trunks keep their widths), so the decisions
compare exactly. Also: the port's CLIs train and write the JAX layout, which
the JAX CLI evaluates; every path the port cannot take raises, and the
synthetic split and missing crops are drawn as the JAX CLI draws them; a JAX-written
pickle unpickles without jax or flax; and the JAX CLI's ``--prompt 1`` is a
no-op (the hazard the port refuses)."""

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.cli import train_charcounter as jcounter_cli
from worddiffusion_tpu.cli import train_phosc as jphosc_cli
from worddiffusion_tpu.models import charcounter as jcharcounter
from worddiffusion_tpu.models import phoscnet as jphoscnet
from worddiffusion_tpu_torch.cli import train_charcounter as counter_cli
from worddiffusion_tpu_torch.cli import train_phosc as phosc_cli
from worddiffusion_tpu_torch.models import charcounter, phoscnet
from worddiffusion_tpu_torch.utils.images import encode_png

torch.set_num_threads(2)

TRAIN_WORDS, TEST_WORDS = ["the", "of", "and", "to"], ["was", "that"]


def _narrow(mp):
    """Both packages' recognizer and counter at hidden 32 and fp32 compute."""
    mp.setattr(jphoscnet, "PHOSCNet",
               functools.partial(jphoscnet.PHOSCNet, hidden=32, dtype=jnp.float32))
    mp.setattr(jcharcounter, "CharacterCounterNet",
               functools.partial(jcharcounter.CharacterCounterNet, dtype=jnp.float32))
    mp.setattr(phoscnet, "PHOSCNet",
               functools.partial(phoscnet.PHOSCNet, hidden=32, dtype=torch.float32))
    mp.setattr(charcounter, "CharacterCounterNet",
               functools.partial(charcounter.CharacterCounterNet, dtype=torch.float32))


def _write_split(root, name: str, words, n: int, seed: int) -> str:
    """n seeded word-like PNG crops (grey and RGB, varied sizes) and their
    filter27 gt file; image names carry the split's name, as the JAX CLI's
    crop cache keys on the name."""
    rng = np.random.default_rng(seed)
    gt = root / f"{name}.filter27"
    lines = []
    for i in range(n):
        h, w = int(rng.integers(30, 70)), int(rng.integers(60, 300))
        img = np.tile(np.linspace(230, 255, w).astype(np.uint8)[None, :, None], (h, 1, 3))
        for _ in range(w // 15):
            y, x = int(rng.integers(h // 5, 3 * h // 5)), int(rng.integers(0, w - 4))
            img[y:y + int(rng.integers(3, h // 3)), x:x + 3] = rng.integers(0, 60, 3)
        stem = f"rc{name}-{i:03d}u-00"
        (root / "crops" / f"{stem}.png").write_bytes(encode_png(img[..., 0] if i % 2 else img))
        lines.append(f"{i % 3:03d},{stem} {words[i % len(words)]}\n")
    gt.write_text("".join(lines))
    return str(gt)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("recognizer")
    (root / "crops").mkdir()
    return dict(root=root, crops=str(root / "crops"),
                train=_write_split(root, "trn", TRAIN_WORDS, 8, seed=1),
                test=_write_split(root, "tst", TEST_WORDS, 4, seed=2))


def _train_args(c, save_dir, *extra):
    return ["--train_csv", c["train"], "--valid_csv", c["test"], "--image_dir", c["crops"],
            "--model", "resnet18", "--batch_size", "4", "--epochs", "1", "--save_dir",
            str(save_dir), *extra]


def _test_args(c, save_dir, counter):
    return ["--mode", "test", "--train_csv", c["train"], "--test_csv", c["test"], "--image_dir",
            c["crops"], "--model", "resnet18", "--batch_size", "4", "--save_dir", str(save_dir),
            "--len_counter", str(counter)]


def _counter_args(c, save_dir):
    return ["--gt_train", c["train"], "--image_dir", c["crops"], "--batch_size", "4",
            "--epochs", "1", "--save_dir", str(save_dir)]


def _results(save_dir) -> dict:
    with open(os.path.join(save_dir, "testresults.txt")) as f:
        return dict(line.split("=", 1) for line in f.read().splitlines())


@pytest.fixture(scope="module")
def jax_trained(corpus):
    """The JAX CLIs' checkpoints: train_phosc (one epoch of 2 steps) and
    train_charcounter (one epoch of 2 steps)."""
    root = corpus["root"]
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        jphosc_cli.main(_train_args(corpus, root / "jax_phosc"))
        jcounter_cli.main(_counter_args(corpus, root / "jax_counter"))
    return root / "jax_phosc", root / "jax_counter" / "params.pkl"


def test_test_mode_matches_jax_on_a_jax_checkpoint(corpus, jax_trained, tmp_path):
    """Both CLIs' --mode test --len_counter on the same JAX-written
    best_params.pkl and params.pkl: the same testresults.txt lines, value for
    value (every decision is an argmax over cosine similarities that the two
    fp32 forwards give within about 1e-6)."""
    save, counter = jax_trained
    port_save = tmp_path / "port"
    port_save.mkdir()
    (port_save / "best_params.pkl").write_bytes((save / "best_params.pkl").read_bytes())
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        jphosc_cli.main(_test_args(corpus, save, counter))
        got = phosc_cli.main(_test_args(corpus, port_save, counter) + ["--device", "cpu"])
    want = _results(save)
    assert _results(port_save) == want
    assert len(want) == 17 and got["zsl"] == float(want["zsl"])


def test_port_checkpoints_evaluate_in_jax(corpus, tmp_path):
    """The port's CLIs train (1 epoch each) and write the JAX layout: the JAX
    CLI's test mode reads both files, and its results equal the port's on them."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        run = phosc_cli.main(_train_args(corpus, tmp_path / "phosc") + ["--device", "cpu"])
        counter_cli.main(_counter_args(corpus, tmp_path / "counter") + ["--device", "cpu"])
        counter = tmp_path / "counter" / "params.pkl"
        with open(tmp_path / "phosc" / "log.csv") as f:
            rows = f.read().splitlines()
        assert rows[0] == "epoch,loss,zsl_acc,lr" and len(rows) == 2
        assert run["history"][0]["steps"] == 2 and np.isfinite(run["history"][0]["loss"])
        phosc_cli.main(_test_args(corpus, tmp_path / "phosc", counter) + ["--device", "cpu"])
        port = _results(tmp_path / "phosc")
        (tmp_path / "phosc" / "testresults.txt").unlink()
        jphosc_cli.main(_test_args(corpus, tmp_path / "phosc", counter))
    assert _results(tmp_path / "phosc") == port


def test_jax_checkpoint_unpickles_without_jax(jax_trained):
    """A JAX CLI's pickle is a tree of numpy arrays (no FrozenDict): a fresh
    interpreter that imports neither jax nor flax reads it."""
    save, counter = jax_trained
    script = ("import pickle, sys\n"
              "for p in sys.argv[1:]:\n"
              "    tree = pickle.load(open(p, 'rb'))\n"
              "    assert type(tree) is dict and set(tree) == {'params'}, type(tree)\n"
              "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')))\n")
    proc = subprocess.run([sys.executable, "-c", script, str(save / "best_params.pkl"),
                           str(counter)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_jax_prompt_flag_changes_nothing(corpus, jax_trained, tmp_path):
    """The reference-side hazard: the JAX CLI's --prompt 1 initialises a
    FixedPatchPrompter and never applies or trains it, so its parameters
    and its logged results are identical to --prompt 0's."""
    save, _ = jax_trained
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        jphosc_cli.main(_train_args(corpus, tmp_path / "prompt", "--prompt", "1"))
    with open(save / "best_params.pkl", "rb") as f:
        plain = pickle.load(f)
    with open(tmp_path / "prompt" / "best_params.pkl", "rb") as f:
        prompted = pickle.load(f)
    assert jax.tree_util.tree_structure(plain) == jax.tree_util.tree_structure(prompted)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(plain),
                                                     jax.tree_util.tree_leaves(prompted)))
    assert (save / "log.csv").read_text() == (tmp_path / "prompt" / "log.csv").read_text()


@pytest.mark.parametrize("flags,error,match", [
    (["--prompt", "1"], NotImplementedError, "silent no-op"),
    (["--augment", "10"], NotImplementedError, "slice 12"),
    (["--synthetic", "1", "--augment", "5"], NotImplementedError, "slice 12"),
    (["--mode", "test"], SystemExit, "needs trained weights"),
])
def test_train_phosc_refuses_what_it_cannot_honour(corpus, tmp_path, flags, error, match):
    argv = _train_args(corpus, tmp_path / "run") + ["--device", "cpu"] + flags
    with pytest.raises(error, match=match):
        phosc_cli.main(argv)


def test_non_png_crop_raises(corpus, tmp_path):
    crops = tmp_path / "crops"
    crops.mkdir()
    (crops / "a01-000u-00.png").write_bytes(b"\xff\xd8\xff\xe0 a JPEG")
    gt = tmp_path / "one.filter27"
    gt.write_text("000,a01-000u-00 the\n")
    with pytest.raises(NotImplementedError, match="slice 12"):
        phosc_cli.main(["--train_csv", str(gt), "--valid_csv", str(gt), "--image_dir",
                        str(crops), "--batch_size", "1", "--save_dir", str(tmp_path / "r"),
                        "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--synthetic", "1"], ["--gt_train", ""],
                                   ["--image_dir", "missing"]])
def test_train_charcounter_refuses_what_it_cannot_honour(corpus, tmp_path, flags):
    """What it refused before the renderer was ported it now honours: the
    synthetic corpus (10 words, one render each) and crops drawn where the
    files are missing train one epoch and write the JAX-layout params.pkl."""
    counter_cli.main(_counter_args(corpus, tmp_path / "c") + [
        "--device", "cpu", "--samples_per_word", "1"] + flags)
    with open(tmp_path / "c" / "params.pkl", "rb") as f:
        assert "trunk" in pickle.load(f)["params"]


def test_recognizer_clis_refuse_cpu_fallback(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        phosc_cli.main(_train_args(corpus, tmp_path / "p"))
    with pytest.raises(SystemExit, match="--device cpu"):
        counter_cli.main(_counter_args(corpus, tmp_path / "c"))


def test_synthetic_epoch_loop_bookkeeping_matches_jax(tmp_path, monkeypatch):
    """Both packages' train_phosc --synthetic 1 --writer_styles 1 with a
    calibration holdout, 5 epochs, on the same injected validation scores
    (each package's ``zsl_accuracy`` replaced by one that returns a scripted
    accuracy per epoch and records what it was handed): the same training
    batches step by step (words, and writer-styled renders bitwise: the
    port draws them without PIL), the same validation images and lexicon,
    the same calibration words, the same log.csv epochs, accuracies and
    plateau learning rates (the value fed each step is the last validation
    accuracy negated, +1e9 before the first), and best_params.pkl written
    at the epochs whose accuracy improved. The weights are not compared: the
    inits differ."""
    from worddiffusion_tpu.eval import zsl as jzsl
    from worddiffusion_tpu_torch.eval import zsl

    accs = [0.1, 0.3, 0.3, 0.3, 0.2]
    seen = {"jax": [], "port": []}

    def scripted(key):
        it = iter(accs)

        def fake(apply_fn, batches, lexicon, version="eng"):
            imgs, words = zip(*[(np.asarray(b), list(w)) for b, w in batches])
            seen[key].append(("valid", np.concatenate(imgs), sum(words, []), list(lexicon)))
            return next(it), {}
        return fake

    def recording(key, fn):
        def wrapped(samples, image_dir, batch_size, rng=None, *a, **k):
            for imgs, words in fn(samples, image_dir, batch_size, rng, *a, **k):
                if rng is not None:
                    seen[key].append(("train", np.array(imgs), list(words)))
                yield imgs, words
        return wrapped

    saved = []
    real_save = phosc_cli._save_best
    monkeypatch.setattr(jzsl, "zsl_accuracy", scripted("jax"))
    monkeypatch.setattr(zsl, "zsl_accuracy", scripted("port"))
    monkeypatch.setattr(jphosc_cli, "_image_batches", recording("jax", jphosc_cli._image_batches))
    monkeypatch.setattr(phosc_cli, "_image_batches", recording("port", phosc_cli._image_batches))
    monkeypatch.setattr(phosc_cli, "_save_best",
                        lambda *a: (saved.append(len(seen["port"])), real_save(*a)))
    _narrow(monkeypatch)
    argv = ["--synthetic", "1", "--writer_styles", "1", "--n_synth", "16", "--model",
            "resnet18", "--batch_size", "4", "--epochs", "5", "--calib_words_fraction", "0.25",
            "--plateau_patience", "1"]
    jphosc_cli.main(argv + ["--save_dir", str(tmp_path / "jax")])
    phosc_cli.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])

    assert len(seen["port"]) == len(seen["jax"]) > len(accs)
    for ours, theirs in zip(seen["port"], seen["jax"]):
        assert ours[0] == theirs[0]
        for a, b in zip(ours[1:], theirs[1:]):
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
    for name in ("calib_words.json", "log.csv"):
        assert (tmp_path / "port" / name).exists()
    assert ((tmp_path / "port" / "calib_words.json").read_text()
            == (tmp_path / "jax" / "calib_words.json").read_text())
    rows = [[line.split(",") for line in (tmp_path / d / "log.csv").read_text().splitlines()]
            for d in ("port", "jax")]
    assert [(r[0], float(r[2]), float(r[3])) for r in rows[0][1:]] == [
        (r[0], float(r[2]), float(r[3])) for r in rows[1][1:]]
    assert len({r[3] for r in rows[0][1:]}) > 1  # the plateau cut the rate
    # the checkpoint follows each improvement: after validations 1 and 2
    valid_at = [i for i, rec in enumerate(seen["port"]) if rec[0] == "valid"]
    assert saved == [valid_at[0] + 1, valid_at[1] + 1]
