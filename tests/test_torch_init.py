"""The port's seeded initialisation and the two things that make repeated
model builds cheap: ``init_weights_``'s kept draws (bitwise the draws made
anew) and ``skip_default_init`` (torch's default initialisation skipped
where every parameter is written at once after).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_init.py -q
"""

import dataclasses
import math
from unittest import mock

import pytest
import torch
import torch.nn as nn

from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.models import layers
from worddiffusion_tpu_torch.models.layers import init_weights_, skip_default_init
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.models.vae import AutoencoderKL, make_vae

UNET = dataclasses.replace(presets.get("iam").unet, model_channels=32, num_heads=2,
                           context_dim=32)
VAE = dataclasses.replace(presets.get("iam").vae, base_channels=8)
VARIANTS = {"iam": {}, "ocr_head": dict(ocr_head=True), "img": dict(img_conditioned=True),
            "style": dict(style_vec_dim=16, style_replace_context=True),
            "glyphs": dict(use_char_images=True), "film": dict(use_scale_shift_norm=True),
            "phosc": dict(use_phosc=True), "fold": dict(attn_fold_context=True)}


@torch.no_grad()
def drawn_anew(module, seed=0, zero_init=True):
    """``init_weights_`` as it drew before its draws were kept: one pass,
    every draw made from the generator at its layer."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)):
            if zero_init and getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                std = math.sqrt(1.0 / m.weight[0].numel()) / layers._TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
                m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * m.embedding_dim ** -0.5)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def same(a: nn.Module, b: nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("make", [lambda: UNet(UNET), lambda: AutoencoderKL(VAE)],
                         ids=["unet", "vae"])
def test_kept_draws_are_the_draws_made_anew(make):
    """Bitwise the one-pass initialisation, on a first build and on every
    build after (the kept draws), at two seeds and both zero_init modes."""
    layers._DRAWS.clear()
    for seed, zero_init in ((0, True), (0, False), (3, True), (0, True), (0, False)):
        assert same(init_weights_(make(), seed, zero_init), drawn_anew(make(), seed, zero_init))
    assert 0 < len(layers._DRAWS) <= layers._DRAWS_KEPT


def test_kept_draws_are_bounded_and_never_written():
    """At most _DRAWS_KEPT initialisations are kept (the oldest goes first),
    and a model trained after its initialisation leaves its kept draws as
    they were drawn."""
    layers._DRAWS.clear()
    for seed in range(layers._DRAWS_KEPT + 2):
        init_weights_(nn.Linear(3, 4), seed)
    assert len(layers._DRAWS) == layers._DRAWS_KEPT
    assert [k[0] for k in layers._DRAWS] == list(range(2, layers._DRAWS_KEPT + 2))
    lin = init_weights_(nn.Linear(3, 4), seed=2)
    with torch.no_grad():
        lin.weight.add_(1.0)
    assert same(init_weights_(nn.Linear(3, 4), seed=2), drawn_anew(nn.Linear(3, 4), seed=2))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_weights_writes_every_parameter_skip_default_init_leaves(variant):
    """Every parameter of the UNet (each variant the presets and CLIs build)
    is written by init_weights_ in both modes: a layer left to
    skip_default_init's uninitialised memory (NaN here) would show."""

    def nan_fill(self):
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.fill_(float("nan"))

    with mock.patch.object(nn.Linear, "reset_parameters", nan_fill), \
            mock.patch.object(nn.modules.conv._ConvNd, "reset_parameters", nan_fill):
        models = [UNet(dataclasses.replace(UNET, **VARIANTS[variant]))]
        if variant == "iam":
            models += [AutoencoderKL(VAE, with_encoder=enc) for enc in (True, False)]
    for m in models:
        for zero_init in (True, False):
            init_weights_(m, 0, zero_init)
            bad = [k for k, t in m.state_dict().items()
                   if t.is_floating_point() and not bool(torch.isfinite(t).all())]
            assert not bad, (variant, type(m).__name__, zero_init, bad[:3])


def test_skip_default_init_skips_and_restores():
    """Inside: Linear and conv layers draw nothing from torch's global
    generator (the VAE has no other layer that draws); after: torch's own
    initialisation is back; built inside and then initialised, a model is
    bitwise one built outside."""
    torch.manual_seed(0)
    before = torch.get_rng_state()
    with skip_default_init():
        AutoencoderKL(VAE)
    assert torch.equal(torch.get_rng_state(), before)
    with skip_default_init():
        inside = UNet(UNET)
    torch.manual_seed(0)
    lin = nn.Linear(8, 8)
    torch.manual_seed(0)
    assert torch.equal(lin.weight, nn.Linear(8, 8).weight) and not torch.equal(
        torch.get_rng_state(), before)
    assert same(init_weights_(inside, 5), init_weights_(UNet(UNET), 5))


def test_make_vae_seeded_and_loaded_as_before():
    """make_vae's seeded VAE is the default-built VAE initialised from the
    seed, and its state-dict path loads every parameter."""
    want = drawn_anew(AutoencoderKL(VAE, with_encoder=True), seed=2)
    got = make_vae(VAE, seed=2)
    assert same(got, want)
    loaded = make_vae(VAE, vae_sd=want.state_dict(), with_encoder=False)
    dec = {k: v for k, v in want.state_dict().items()
           if not k.startswith(("encoder.", "quant_conv."))}
    assert loaded.state_dict().keys() == dec.keys()
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in dec.items())
