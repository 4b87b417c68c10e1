"""The PHOSC recognizer's initial draws in the port against flax's defaults,
at the `iam` chain's sizes (``cli/train_phosc.build_model``: the VGG trunk,
two 4096-wide hidden layers a head, the English phos / phoc widths), and its
dropout against flax's ``nn.Dropout``.

JAX's ``Module.init`` (seed 0, the JAX CLI's call) and the port's
``models.layers.init_weights_`` (seed 0) draw from different generators, so
each parameter is held by its law, tensor by tensor under the flax names
(``models.convert.jax_phoscnet_to_torch``): the same zero, one and drawn
sites; a drawn tensor of at least 10k elements has its standard deviation
within 3% of JAX's (the estimate's own spread is below 1% there) and its
mean within 3 standard errors of zero and of JAX's. The residual trunk
(GroupNorm scales: the one sites) is held the same way.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from worddiffusion_tpu.models import phoscnet as jphoscnet
from worddiffusion_tpu_torch.cli.train_phosc import build_parser, build_model
from worddiffusion_tpu_torch.data.alphabets import phoc_dim, phos_dim
from worddiffusion_tpu_torch.models import phoscnet
from worddiffusion_tpu_torch.models.convert import jax_phoscnet_to_torch

STD_REL, MEAN_SE, MIN_DRAWN = 0.03, 3.0, 10_000


def _kind(a: np.ndarray) -> str:
    if not a.any():
        return "zeros"
    if (a == 1).all():
        return "ones"
    return "drawn"


@pytest.mark.parametrize("trunk", ["vgg", "resnet18"])
def test_initial_draws_follow_flax(trunk):
    """Every parameter of the port's seeded init has the site and the law of
    JAX's ``Module.init`` at the chain's sizes."""
    jmodel = jphoscnet.PHOSCNet(phos_size=phos_dim("eng"), phoc_size=phoc_dim("eng"),
                                trunk=trunk)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), np.zeros((2, 50, 250, 3), np.float32))
    ref = jax_phoscnet_to_torch(jax.tree_util.tree_map(np.asarray, init))

    args = build_parser().parse_args(["--model", trunk, "--seed", "0"])
    port = {k: v.numpy() for k, v in build_model(args, torch.device("cpu")).state_dict().items()}

    assert sorted(port) == sorted(ref)
    checked = 0
    for name, want in ref.items():
        got = port[name]
        assert got.shape == want.shape, name
        assert _kind(got) == _kind(want), (name, _kind(got), _kind(want))
        if _kind(want) != "drawn" or want.size < MIN_DRAWN:
            continue
        g, w = got.astype(np.float64), want.astype(np.float64)
        se = w.std() / np.sqrt(w.size)
        assert abs(g.std() / w.std() - 1) < STD_REL, (name, g.std(), w.std())
        assert abs(g.mean()) < MEAN_SE * se, (name, g.mean(), se)
        assert abs(g.mean() - w.mean()) < MEAN_SE * np.sqrt(2) * se, (name, g.mean(), w.mean())
        # both truncate at two standard deviations of the untruncated normal
        assert abs(np.abs(g).max() / np.abs(w).max() - 1) < STD_REL, name
        checked += 1
    assert checked >= (14 if trunk == "vgg" else 20)


def test_dropout_keeps_and_scales_as_flax():
    """The port's training-mode dropout keeps 1 - p of the activations and
    scales the kept by 1 / (1 - p), as flax's ``nn.Dropout`` does."""
    p, n = 0.5, 1 << 20
    ones = np.ones((16, n // 16), np.float32)
    model = phoscnet.PHOSCNet(phos_size=8, phoc_size=8, hidden=8, trunk="vgg", dropout=p)
    got = model._dropout(torch.from_numpy(ones), torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(nn.Dropout(p).apply({}, ones, deterministic=False,
                                          rngs={"dropout": jax.random.PRNGKey(0)}))
    se = np.sqrt(p * (1 - p) / n)
    for out in (got, want):
        kept = out != 0
        assert set(np.unique(out[kept])) == {np.float32(1 / (1 - p))}
        assert abs(kept.mean() - (1 - p)) < 3 * se
    assert not np.array_equal(got, want)  # two generators: the law, not the bits


def test_fp32_model_computes_in_fp32():
    """The ``dtype`` argument that selects fp32 reaches every layer: the
    heads' outputs and the features keep fp32 precision (no bf16 step)."""
    model = functools.partial(phoscnet.PHOSCNet, dtype=torch.float32)(
        phos_size=8, phoc_size=8, hidden=16, trunk="vgg")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 50, 250, 3)).astype(np.float32))
    out = model(x, return_features=True)
    f = out["features"]
    assert f.dtype == torch.float32
    assert not torch.equal(f, f.to(torch.bfloat16).float())
