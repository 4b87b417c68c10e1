"""The port's copies of the JAX package's jax-free modules (configs, data
tables and parsers, the noise schedule) against their originals, value
for value.

``port_cfg`` is the helper the other port tests use to hand the port the
values of a JAX config: the same fields, in the port's own class.
"""

import dataclasses

import numpy as np
import pytest

from worddiffusion_tpu.configs import presets as jpresets
from worddiffusion_tpu.data import alphabets as jalphabets
from worddiffusion_tpu.data import gt as jgt
from worddiffusion_tpu.data import phoc as jphoc
from worddiffusion_tpu.data import phos as jphos
from worddiffusion_tpu.data.phosc import phosc_vector as jphosc_vector
from worddiffusion_tpu.data.tokenizer import Tokenizer as JTokenizer
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from worddiffusion_tpu_torch.configs import config as port_config
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data import alphabets, gt, phoc, phos
from worddiffusion_tpu_torch.data.phosc import phosc_vector
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule

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
