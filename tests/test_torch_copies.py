"""The port's copies of the JAX package's jax-free modules (configs, data
tables and parsers, the dataset manipulations, the noise schedule) and
functions (the CTC label encoder, the sampling CLI's writer-dict helpers,
the FID harness's numpy functions) against their originals, value for
value.

``port_cfg`` is the helper the other port tests use to hand the port the
values of a JAX config: the same fields, in the port's own class.
"""

import dataclasses

import numpy as np
import pytest

from worddiffusion_tpu.cli import sample as jsample_cli
from worddiffusion_tpu.configs import presets as jpresets
from worddiffusion_tpu.data import alphabets as jalphabets
from worddiffusion_tpu.data import gt as jgt
from worddiffusion_tpu.data import manipulate as jmanipulate
from worddiffusion_tpu.data import phoc as jphoc
from worddiffusion_tpu.data import phos as jphos
from worddiffusion_tpu.data.phosc import phosc_vector as jphosc_vector
from worddiffusion_tpu.data.tokenizer import Tokenizer as JTokenizer
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from worddiffusion_tpu.eval import fid as jfid
from worddiffusion_tpu.ops.ctc import encode_ocr_labels as jax_encode_ocr_labels
from worddiffusion_tpu_torch.cli import sample as sample_cli
from worddiffusion_tpu_torch.configs import config as port_config
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data import alphabets, gt, manipulate, phoc, phos
from worddiffusion_tpu_torch.data.phosc import phosc_vector
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu_torch.eval import fid
from worddiffusion_tpu_torch.ops.ctc import encode_ocr_labels

WORDS = ["Hello", "word", "the", "A", "don't", "x", "Nørd", "Æble", "quickly"]


def port_cfg(cfg):
    """A JAX config dataclass (``Experiment`` or any of its parts) as the
    port's class of the same name, with the same values."""
    cls = getattr(port_config, type(cfg).__name__)
    fields = dataclasses.asdict(cfg)
    for name, value in fields.items():
        if isinstance(value, dict):  # a nested config: rebuild it in the port's class
            fields[name] = port_cfg(getattr(cfg, name))
    return cls(**fields)


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_presets_equal(name):
    ours, theirs = presets.get(name), jpresets.get(name)
    assert type(ours) is port_config.Experiment
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(port_cfg(theirs)) == dataclasses.asdict(theirs)
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)


def test_preset_overrides_equal():
    exp = presets.get("iam", diffusion=port_config.DiffusionConfig(num_steps=12))
    jexp = jpresets.get("iam", diffusion=port_cfg(jpresets.get("iam").diffusion))
    assert exp.diffusion.num_steps == 12 and jexp.diffusion.num_steps == 600
    assert exp.unet == port_config.UNetConfig(**dataclasses.asdict(jexp.unet))


def test_alphabets_and_tables_equal():
    for name in ("ALPHABETS", "OCR_ENG", "OCR_NOR", "OCR_CVL", "OCR_ENG_BLANK",
                 "OCR_NOR_BLANK", "OCR_CVL_BLANK", "PHOS_SHAPE_TABLES", "PHOS_NUM_SHAPES",
                 "PHOC_BIGRAMS", "PHOC_NUM_CHARS"):
        assert getattr(alphabets, name) == getattr(jalphabets, name), name
    for version in ("eng", "gw", "nor"):
        assert alphabets.phos_dim(version) == jalphabets.phos_dim(version)
        assert alphabets.phoc_dim(version) == jalphabets.phoc_dim(version)


@pytest.mark.parametrize("version", ["eng", "gw", "nor"])
def test_phoc_phos_phosc_equal(version):
    covered = 0
    for w in WORDS:
        try:
            jphos.phos_vector(w, version)
        except KeyError:  # a character outside this version's table: both refuse it
            with pytest.raises(KeyError):
                phos.phos_vector(w, version)
            continue
        covered += 1
        np.testing.assert_array_equal(phoc.phoc_vector(w, version), jphoc.phoc_vector(w, version))
        np.testing.assert_array_equal(phos.phos_vector(w, version), jphos.phos_vector(w, version))
        for as_int in (False, True):
            got = phosc_vector(w, version, as_int=as_int)
            want = jphosc_vector(w, version, as_int=as_int)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert covered >= 5


@pytest.mark.parametrize("alphabet,max_chars", [("eng_main", 10), ("eng_base", 10),
                                                ("cvl", 42), ("nor", 25)])
def test_tokenizer_equal(alphabet, max_chars):
    ours, theirs = Tokenizer.from_name(alphabet, max_chars), JTokenizer.from_name(alphabet,
                                                                                  max_chars)
    words = [w for w in WORDS if all(c in ours.letter2index for c in w)]
    assert words
    np.testing.assert_array_equal(ours.encode_batch(words), theirs.encode_batch(words))
    assert ours.vocab_size == theirs.vocab_size and ours.num_classes == theirs.num_classes
    ids = theirs.encode(words[0])
    assert ours.decode(ids) == theirs.decode(ids)


@pytest.mark.parametrize("steps", [600, 1000])
def test_noise_schedule_equal(steps):
    ours, theirs = NoiseSchedule.linear(steps), JNoiseSchedule.linear(steps)
    assert ours.num_steps == theirs.num_steps == steps
    for name in ("beta", "alpha", "alpha_hat", "sqrt_alpha_hat", "sqrt_one_minus_alpha_hat"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_parse_gt_and_writer_registry_equal(tmp_path):
    path = tmp_path / "words.filter27"
    path.write_text("000,a01-000u-00 Hello\n002,a01-000u-01 word\n000,a01-000u-02 test\n"
                    "001,a01-000u-03 the\n002,a01-000u-04 A\n")
    for partial in (0.0, 0.6):
        samples, reg = gt.parse_gt(str(path), partial_load=partial)
        jsamples, jreg = jgt.parse_gt(str(path), partial_load=partial)
        assert [dataclasses.astuple(s) for s in samples] == [
            dataclasses.astuple(s) for s in jsamples]
        assert reg.mapping == jreg.mapping and len(reg) == len(jreg)
    reg.dump_json(str(tmp_path / "ours.json"))
    jreg.dump_json(str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    back, jback = (gt.WriterRegistry.from_json(str(tmp_path / "theirs.json")),
                   jgt.WriterRegistry.from_json(str(tmp_path / "ours.json")))
    assert back.mapping == jback.mapping == jreg.mapping
    assert gt.sniff_format(str(path)) == jgt.sniff_format(str(path))


def test_writer_dict_helpers_equal(tmp_path):
    """``cli.sample``'s copies of ``load_writers_dict`` and
    ``resolve_writer_registry``: the same registry from an explicit file and
    from a checkpoint directory or its parent, None where there is none,
    the gt registry without a dict, and the same refusals."""
    ckpt = tmp_path / "run" / "ckpt"
    ckpt.mkdir(parents=True)
    (tmp_path / "run" / "writers_dict_train.json").write_text('{"000": 0, "007": 1}')
    gt_path = tmp_path / "words.filter27"
    gt_path.write_text("007,a01-000u-00 the\n000,a01-000u-01 of\n")
    samples, gt_reg = gt.parse_gt(str(gt_path))
    jsamples, jgt_reg = jgt.parse_gt(str(gt_path))
    for path, ckpt_dir in (("", str(ckpt)), (str(tmp_path / "run" / "writers_dict_train.json"),
                                             ""), ("", str(tmp_path)), ("", "")):
        got, want = (sample_cli.load_writers_dict(path, ckpt_dir),
                     jsample_cli.load_writers_dict(path, ckpt_dir))
        assert (got is None) == (want is None) and (got is None or got.mapping == want.mapping)
        got = sample_cli.resolve_writer_registry(path, ckpt_dir, samples, gt_reg)
        want = jsample_cli.resolve_writer_registry(path, ckpt_dir, jsamples, jgt_reg)
        assert got.mapping == want.mapping
    (tmp_path / "run" / "writers_dict_train.json").write_text('{"000": 0}')
    for fn, s_, r_ in ((sample_cli.resolve_writer_registry, samples, gt_reg),
                       (jsample_cli.resolve_writer_registry, jsamples, jgt_reg)):
        with pytest.raises(SystemExit, match="not in the training writers dict"):
            fn("", str(ckpt), s_, r_)
    for fn in (sample_cli.load_writers_dict, jsample_cli.load_writers_dict):
        with pytest.raises(SystemExit, match="not found"):
            fn(str(tmp_path / "none.json"), "")


def test_encode_ocr_labels_equal():
    words = ["Hello", "the", "", "a b", "zz9", "quickly!"]
    for alphabet, max_len in ((" _ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz", 10),
                              ("abc", 3)):
        got, want = encode_ocr_labels(words, alphabet, max_len), \
            jax_encode_ocr_labels(words, alphabet, max_len)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _samples(cls, n: int = 60):
    rng = np.random.default_rng(0)
    words = ["the", "of", "a", "don't", "quickly", "Nørd", "x" * 40, "two words"]
    return [cls(image=f"a01-{i:03d}u{'_aug' if i % 7 == 0 else ''}.png", writer=str(i % 5),
                word=words[int(rng.integers(len(words)))]) for i in range(n)]


def test_manipulate_equal():
    """``data/manipulate``'s copies on a seeded sample list: the same samples
    in the same order; ``resize_dataset`` (OpenCV's resize, written out in
    numpy) bitwise on two crops (more: tests/test_torch_augment.py)."""
    ours, theirs = _samples(gt.Sample), _samples(jgt.Sample)

    def rows(samples):
        return [dataclasses.astuple(s) for s in samples]

    for target, seed in ((3, 0), (12, 5)):
        assert rows(manipulate.balance_by_word(ours, target, seed)) == rows(
            jmanipulate.balance_by_word(theirs, target, seed))
        assert rows(manipulate.balance_by_length(ours, target, seed)) == rows(
            jmanipulate.balance_by_length(theirs, target, seed))
    for kw in ({}, {"min_len": 2, "max_len": 7}, {"alphabet": "abcdefghijklmnopqrstuvwxyz_'"}):
        assert rows(manipulate.trim_dataset(ours, **kw)) == rows(
            jmanipulate.trim_dataset(theirs, **kw))
    assert rows(manipulate.isolate_original(ours)) == rows(jmanipulate.isolate_original(theirs))
    assert {k: rows(v) for k, v in manipulate.group_by(ours, lambda s: s.writer).items()} == {
        k: rows(v) for k, v in jmanipulate.group_by(theirs, lambda s: s.writer).items()}
    crops = [np.random.default_rng(i).integers(0, 256, (40 + i, 130 * (i + 1), 3), dtype=np.uint8)
             for i in range(2)]
    for a, b in zip(manipulate.resize_dataset(crops), jmanipulate.resize_dataset(crops)):
        np.testing.assert_array_equal(a, b)


def test_analysis_and_canvas_copies_equal():
    """``utils/analysis.py`` (embedding correlation, word-length histogram)
    and ``utils/images.center_on_canvas`` (crop and pad both ways)."""
    from worddiffusion_tpu.utils import analysis as janalysis
    from worddiffusion_tpu.utils.images import center_on_canvas as jcenter
    from worddiffusion_tpu_torch.utils import analysis
    from worddiffusion_tpu_torch.utils.images import center_on_canvas

    rng = np.random.default_rng(0)
    emb = {"w3": rng.standard_normal((5, 16)), "w1": rng.standard_normal(16),
           "w2": rng.standard_normal((2, 16))}
    keys, corr = analysis.embedding_correlation(emb)
    jkeys, jcorr = janalysis.embedding_correlation(emb)
    assert keys == jkeys
    np.testing.assert_array_equal(corr, jcorr)
    words = ["a", "the", "of", "words", "x"]
    assert analysis.word_length_histogram(words) == janalysis.word_length_histogram(words)
    imgs = rng.standard_normal((2, 30, 70, 3)).astype(np.float32)
    for h, w, border in ((64, 256, 0.0), (20, 50, 1.0), (64, 40, -1.0)):
        np.testing.assert_array_equal(center_on_canvas(imgs, h, w, border),
                                      jcenter(imgs, h, w, border))


def test_fid_copies_equal():
    """``eval/fid``'s copies: Gaussian statistics, the Frechet distance, the
    covariance-free FID (1e-10 of the value), features and the resize to the
    recognizer's 50x250."""
    rng = np.random.default_rng(4)
    real = rng.standard_normal((40, 12))
    fake = 0.5 + 1.3 * rng.standard_normal((30, 12))
    for a, b in zip(fid.gaussian_stats(real), jfid.gaussian_stats(real)):
        assert np.array_equal(a, b)
    stats = (*fid.gaussian_stats(real), *fid.gaussian_stats(fake))
    assert fid.frechet_distance(*stats) == jfid.frechet_distance(*stats)
    want = jfid.fid_score(real, fake)
    assert abs(fid.fid_score(real, fake) - want) <= 1e-10 * abs(want)
    assert abs(fid.fid_score(real, fake) - fid.frechet_distance(*stats)) <= 1e-6 * want
    batches = [real[:7], real[7:]]
    assert np.array_equal(fid.compute_features(lambda b: 2 * b, batches),
                          jfid.compute_features(lambda b: 2 * b, batches))
    with pytest.raises(ValueError):
        fid.fid_score(real[:1], fake)
    imgs = rng.uniform(-1, 1, (3, 40, 120, 3)).astype(np.float32)
    assert np.array_equal(fid.phosc_resize(imgs), jfid.phosc_resize(imgs))
    full = rng.uniform(-1, 1, (2, 50, 250, 3)).astype(np.float32)
    assert np.array_equal(fid.phosc_resize(full), full)  # already the recognizer's size


def test_native_numpy_bodies_equal(monkeypatch):
    """``data/native.py``'s numpy bodies against the JAX module's fallbacks
    (both libraries switched off by ``WD_NATIVE=0``), value for value."""
    from worddiffusion_tpu.data import native as jnative
    from worddiffusion_tpu_torch.data import native

    monkeypatch.setenv("WD_NATIVE", "0")
    assert not jnative.preferred() and not native.preferred()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((30, 90), (64, 300))]
    assert np.array_equal(native.batch_resize_pad_normalize(imgs, 64, 256),
                          jnative.batch_resize_pad_normalize(imgs, 64, 256))
    assert np.array_equal(native.batch_normalize(imgs[0]), jnative.batch_normalize(imgs[0]))
    f = rng.uniform(-0.2, 1.2, (2, 5, 7)).astype(np.float32)
    assert np.array_equal(native.batch_denormalize(f), jnative.batch_denormalize(f))
    xs = np.array([-3, 0, 4, 89, 200])
    assert np.array_equal(native.vertical_lines(imgs[0].copy(), xs, 7),
                          jnative.vertical_lines(imgs[0].copy(), xs, 7))


def test_host_pass_source_is_a_copy():
    """The port's host C pass is the JAX repo's source byte for byte after a
    first line that names it."""
    from pathlib import Path

    from worddiffusion_tpu_torch.data import native

    repo = Path(__file__).resolve().parent.parent
    ours = native.SOURCE.read_bytes()
    first, rest = ours.split(b"\n", 1)
    assert b"native/src/wd_image.cpp" in first
    assert rest == (repo / "native" / "src" / "wd_image.cpp").read_bytes()


def test_style_retrieval_accuracy_equal():
    from worddiffusion_tpu.cli import train_style as jtrain_style
    from worddiffusion_tpu_torch.cli import train_style

    rng = np.random.default_rng(1)
    vecs = {str(w): rng.normal(w % 3, 1.0, (int(rng.integers(1, 5)), 6)).astype(np.float32)
            for w in range(7)}
    assert (train_style.retrieval_accuracy(vecs)
            == jtrain_style._retrieval_accuracy(vecs))


def test_synthetic_copies_equal():
    """``data/synthetic.py``'s copies (the word lists, seeds, writer styles,
    corpora) against their originals; then ``make_glyph_table.pil_render_word``
    (a copy of the JAX ``render_word``, the generator's reference)."""
    from worddiffusion_tpu.data import synthetic as jsyn
    from worddiffusion_tpu_torch.configs.config import DataConfig as PortDataConfig
    from worddiffusion_tpu_torch.data import synthetic

    for name in ("WORDS_200", "WORDS_NOR", "WORDS_CVL"):
        assert getattr(synthetic, name) == getattr(jsyn, name), name
    for name in ("x", "writer-3", "ø"):
        assert synthetic.stable_seed(name) == jsyn.stable_seed(name)
        assert synthetic.writer_style(name) == jsyn.writer_style(name)
    for lang in ("eng", "nor", "cvl", "gw"):
        for n in (5, 204, 300):
            assert synthetic.word_list(n, lang) == jsyn.word_list(n, lang)
    for alphabet, phos in (("eng_main", "eng"), ("cvl", "eng"), ("nor", "nor"), ("gw", "gw")):
        cfg = PortDataConfig(alphabet=alphabet, phos_version=phos)
        assert synthetic.corpus_lang(cfg) == jsyn.corpus_lang(cfg)
    assert [tuple(vars(s).values()) for s in synthetic.synthetic_corpus(["a", "b"], 3, 2)] == [
        tuple(vars(s).values()) for s in jsyn.synthetic_corpus(["a", "b"], 3, 2)]


def test_pil_render_word_copy_equal():
    from worddiffusion_tpu.data import synthetic as jsyn
    from worddiffusion_tpu_torch.data import make_glyph_table

    font, _ = make_glyph_table.load_font()
    words = jsyn.WORDS_200 + jsyn.WORDS_NOR + jsyn.WORDS_CVL
    for i, word in enumerate(words[::37]):
        style = jsyn.writer_style(str(i)) if i % 2 else None
        assert np.array_equal(make_glyph_table.pil_render_word(font, word, seed=i, style=style),
                              jsyn.render_word(word, seed=i, style=style))
