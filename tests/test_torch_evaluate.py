"""The evaluation CLI against the JAX one on the featurizers both can load:
the same real and generated PNG directories, a JAX-layout PHOSC pickle
(``--phosc_params``, resnet18 trunk, both packages narrowed to hidden-32
fp32 heads) and a seeded torchvision-layout Inception ``.pt``. The JSON has
the same keys; ``phosc_zsl_accuracy`` and ``phosc_zsl_n`` are equal, and the
two FIDs agree within 1e-5 relative (fp32 features; measured 3.6e-7 for
Inception, 8.2e-7 for PHOSC). Also: the style-encoder fallback's key and warning, a ``.jpg``
refused naming slice 12, ``--ocr_ckpt`` exiting naming the conversion."""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.cli import evaluate as jeval_cli
from worddiffusion_tpu.models import phoscnet as jphoscnet
from worddiffusion_tpu_torch.cli import evaluate as eval_cli
from worddiffusion_tpu_torch.data.synthetic import render_word
from worddiffusion_tpu_torch.eval.inception import seeded_torchvision_state_dict
from worddiffusion_tpu_torch.models import phoscnet
from worddiffusion_tpu_torch.utils.images import encode_png

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    for d, words in (("real", ["the", "of", "and", "to", "in"]),
                     ("fake", ["the", "hand", "word", "don't", "of"])):
        (root / d).mkdir()
        for i, w in enumerate(words):
            img = render_word(w, seed=i + (7 if d == "fake" else 0))
            (root / d / f"a01-{i:03d}_{i % 2}_{w}.png").write_bytes(encode_png(img))
    jm = jphoscnet.PHOSCNet(hidden=32, trunk="resnet18", dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), np.zeros((1, 50, 250, 3),
                                                                   np.float32)))
    with open(root / "phosc.pkl", "wb") as f:
        pickle.dump(params, f)
    torch.save(seeded_torchvision_state_dict(1), root / "inception.pt")
    return root


def test_evaluate_matches_jax(dirs, monkeypatch):
    monkeypatch.setattr(jphoscnet, "PHOSCNet", functools.partial(
        jphoscnet.PHOSCNet, hidden=32, dtype=jnp.float32))
    monkeypatch.setattr(phoscnet, "PHOSCNet", functools.partial(
        phoscnet.PHOSCNet, hidden=32, dtype=torch.float32))
    argv = ["--real_dir", str(dirs / "real"), "--fake_dir", str(dirs / "fake"),
            "--phosc_params", str(dirs / "phosc.pkl"), "--phosc_trunk", "resnet18",
            "--inception_weights", str(dirs / "inception.pt"), "--batch_size", "2"]
    jeval_cli.main(argv + ["--out", str(dirs / "jax.json")])
    ours = eval_cli.main(argv + ["--out", str(dirs / "port.json"), "--device", "cpu"])
    theirs = json.loads((dirs / "jax.json").read_text())
    assert json.loads((dirs / "port.json").read_text()) == ours
    assert sorted(ours) == sorted(theirs) == sorted(
        ["fid_inception", "fid_phosc", "phosc_zsl_accuracy", "phosc_zsl_n"])
    assert ours["phosc_zsl_accuracy"] == theirs["phosc_zsl_accuracy"]
    assert ours["phosc_zsl_n"] == theirs["phosc_zsl_n"] == 4
    for key in ("fid_inception", "fid_phosc"):
        assert abs(ours[key] - theirs[key]) <= 1e-5 * abs(theirs[key]), key


def test_evaluate_style_fallback_and_refusals(dirs, tmp_path, caplog):
    argv = ["--real_dir", str(dirs / "real"), "--fake_dir", str(dirs / "fake"), "--device",
            "cpu", "--limit", "3"]
    with caplog.at_level("WARNING"):
        res = eval_cli.main(argv)
    assert list(res) == ["fid_style_encoder"] and np.isfinite(res["fid_style_encoder"])
    assert "RANDOM-INIT StyleEncoder" in caplog.text
    with pytest.raises(SystemExit, match="jax_ocr_to_torch"):
        eval_cli.main(argv + ["--ocr_ckpt", "ckpt"])
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(NotImplementedError, match="slice 12"):
        eval_cli.main(["--real_dir", str(tmp_path), "--fake_dir", str(dirs / "fake"),
                       "--device", "cpu"])


def test_load_dir_parses_words_as_jax(dirs):
    ours = eval_cli._load_dir(str(dirs / "fake"), 64, 256)
    theirs = jeval_cli._load_dir(str(dirs / "fake"), 64, 256)
    assert ours[1] == theirs[1] == ["the", "hand", "word", "don't", "of"]
    assert np.array_equal(ours[0], theirs[0])
