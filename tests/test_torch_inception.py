"""The port's InceptionV3 featurizer (``eval/inception.py``) against the JAX
one on the same seeded torchvision-layout weights (BatchNorm statistics
away from the identity, so the fold is exercised), each side converting them
with its own ``convert_torch_inception``: the 2048-d pool3 features of a
64x256 batch (resized up to 299x299) within 1e-4 of their largest value,
fp32. The resize alone against ``jax.image.resize(..., "bilinear")`` on an
upscale (64x256, within 2e-7) and on downscales (320x640, 600x300, within
3e-5: measured 2.1e-5, JAX and torch computing the widened filter's weights
in different orders): JAX antialiases a downscale, as ``antialias=True``
does. The JAX network is compiled once."""

import jax
import numpy as np
import pytest
import torch

from worddiffusion_tpu.eval import inception as jinception
from worddiffusion_tpu_torch.eval import inception


@pytest.fixture(scope="module")
def weights():
    return {k: v.numpy() for k, v in inception.seeded_torchvision_state_dict(3).items()}


@pytest.mark.parametrize("hw", [(64, 256), (320, 640), (600, 300), (299, 299)])
def test_resize_matches_jax(hw):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 299, 299, 3), "bilinear"))
    shrinks = max(hw) > 299
    got = inception.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= (3e-5 if shrinks else 2e-7)


def test_features_match_jax(weights, tmp_path):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 256, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jinception.InceptionV3Features().apply)(
        jinception.convert_torch_inception(weights), x))
    path = tmp_path / "inception.pt"
    torch.save({k: torch.from_numpy(v) for k, v in weights.items()}, path)
    got = inception.load_inception_featurizer(str(path), "cpu")(x)
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.savez(tmp_path / "inception.npz", **weights)
    assert np.array_equal(inception.load_inception_featurizer(str(tmp_path / "inception.npz"),
                                                              "cpu")(x), got)


def test_fold_matches_jax(weights):
    """The folded kernel is the JAX one transposed HWIO -> OIHW, bit for bit;
    AuxLogits and fc are left out."""
    ours = inception.convert_torch_inception(dict(weights, **{
        "AuxLogits.conv0.conv.weight": np.zeros((1, 1, 1, 1), np.float32),
        "fc.weight": np.zeros((2, 2), np.float32)}))
    theirs = jinception.convert_torch_inception(weights)["params"]
    n = 0
    for key, value in ours.items():
        *path, conv, leaf = key.split(".")
        node = theirs
        for part in path:
            node = node[part]
        j = np.asarray(node[conv]["kernel" if leaf == "weight" else "bias"])
        assert np.array_equal(value, j.transpose(3, 2, 0, 1) if leaf == "weight" else j), key
        n += 1
    assert n == 2 * 94 and not any(k.startswith(("AuxLogits", "fc")) for k in ours)
