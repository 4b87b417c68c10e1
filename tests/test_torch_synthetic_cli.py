"""The CLIs' synthetic paths on the CPU at a tiny preset, against the JAX
package's data where the two can be compared: ``train --synthetic 1
--charImages 1`` (the corpus, the registry and every record's image and
glyph crops bitwise the JAX dataset's), ``--allow_random_style 1`` (a random
StyleEncoder's 4096-d vectors for every writer) and training without
``--gt_train``; ``build_latent_cache --synthetic 1 --writer_styled 1`` (the
JAX corpus, writer-styled renders bitwise) whose cache the train CLI reads;
``sample --charImages 1`` (the glyph crops handed to the sampler are the
JAX ``char_glyphs``)."""

import numpy as np
import torch

from worddiffusion_tpu.data import dataset as jdataset
from worddiffusion_tpu.data import synthetic as jsyn
from worddiffusion_tpu.data.gt import WriterRegistry as JRegistry
from worddiffusion_tpu.data.tokenizer import Tokenizer as JTokenizer
from test_torch_copies import port_cfg
from test_torch_train import tiny_exp
from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
from worddiffusion_tpu_torch.cli import sample as sample_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.generate import sample as gsample

torch.set_num_threads(2)


def _jax_dataset(exp, samples, **kw):
    reg = JRegistry()
    for s in samples:
        reg.add(s.writer)
    tok = JTokenizer.from_name(exp.data.alphabet, exp.data.max_chars)
    return jdataset.WordImageDataset(samples, reg, tok, exp.data, **kw)


def test_train_synthetic_char_images_match_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    argv = ["--preset", "tiny", "--synthetic", "1", "--vocab_size", "3",
            "--samples_per_word", "2", "--charImages", "1", "--batch_size", "2",
            "--epochs", "1", "--preview_ddim", "2", "--save_path", str(tmp_path / "run"),
            "--device", "cpu"]
    trainer = train_cli.build(train_cli.build_parser().parse_args(argv))
    jexp = tiny_exp()
    jsamples = jsyn.synthetic_corpus(words=jsyn.word_list(3, jsyn.corpus_lang(jexp.data)),
                                     samples_per_word=2)
    jds = _jax_dataset(jexp, jsamples, char_images=True,
                       char_image_size=jexp.unet.char_image_size)
    ds = trainer.dataset
    assert [tuple(vars(s).values()) for s in ds.samples] == [
        tuple(vars(s).values()) for s in jsamples]
    for i in range(len(ds)):
        ours, theirs = ds[i], jds[i]
        for key in ("image", "char_images", "context"):
            assert np.array_equal(ours[key], theirs[key]), (i, key)
        assert ours["writer"] == theirs["writer"]
    state = trainer.run(epochs=1)
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_random_style_and_no_gt(tmp_path, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    trainer = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "tiny", "--vocab_size", "2", "--samples_per_word", "4", "--wrdChrWrStyl",
        "1", "--allow_random_style", "1", "--batch_size", "2", "--save_path",
        str(tmp_path / "run"), "--device", "cpu"]))
    ds = trainer.dataset
    assert ds.writer_styled and sorted(ds.style_lookup) == [str(i) for i in range(8)]
    assert {v.shape for v in ds.style_lookup.values()} == {(4096,)}
    assert np.isfinite(np.stack(list(ds.style_lookup.values()))).all()
    assert trainer.run(epochs=1).step == 4


def test_cache_synthetic_writer_styled_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    argv = ["--preset", "tiny", "--synthetic", "1", "--writer_styled", "1", "--vocab_size",
            "3", "--samples_per_word", "2", "--out", str(tmp_path / "lat.npz"), "--device",
            "cpu", "--deterministic", "1"]
    ds, _ = cache_cli.build(cache_cli.build_parser().parse_args(argv))
    jexp = tiny_exp()
    jsamples = jsyn.synthetic_corpus(words=jsyn.word_list(3, jsyn.corpus_lang(jexp.data)),
                                     samples_per_word=2)
    jds = _jax_dataset(jexp, jsamples, writer_styled=True)
    assert ds.writer_styled and len(ds) == len(jds) == 6
    for i in range(len(ds)):
        assert np.array_equal(ds[i]["image"], jds[i]["image"]), i
    assert len(cache_cli.main(argv)) == 6
    with np.load(tmp_path / "lat.npz") as z:
        assert sorted(z.files) == sorted(s.image for s in jsamples)
    state = train_cli.main(["--preset", "tiny", "--synthetic", "1", "--vocab_size", "3",
                            "--samples_per_word", "2", "--latent_cache", str(tmp_path / "lat.npz"),
                            "--batch_size", "2", "--epochs", "1", "--preview_ddim", "2",
                            "--save_path", str(tmp_path / "run"), "--device", "cpu"])
    assert state.step == 3


def test_sample_char_images_match_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    handed = []
    real = gsample.WordSampler.sample_async

    def spy(self, words, wids, gen, **cond):
        handed.append((list(words), cond.get("char_images")))
        return real(self, words, wids, gen, **cond)

    monkeypatch.setattr(gsample.WordSampler, "sample_async", spy)
    names = sample_cli.main(["--preset", "tiny", "--words", "of,affine", "--writer", "2",
                             "--charImages", "1", "--ddim", "2", "--save_path",
                             str(tmp_path / "out"), "--device", "cpu"])
    assert names == ["00000_2_of.png", "00001_2_affine.png"]
    words, chimg = handed[0]
    exp = tiny_exp()
    want = np.stack([jdataset.char_glyphs(w, exp.data.max_chars, exp.unet.char_image_size)
                     for w in words])
    assert np.array_equal(chimg, want)
