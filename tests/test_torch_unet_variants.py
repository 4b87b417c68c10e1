"""The port's UNet conditioning variants against the JAX UNet at a tiny
width, in fp32: FiLM and split-skip ResBlocks, writer style vectors
(appended, replacing), reference latents, glyph images, the writer mix
and the CTC aux head (both norms). The weights go across through
the port's ``jax_unet_to_torch`` and load with ``strict=True``; every parameter is random (seeded numpy), the
zero-initialised output convs too, so no sub-path hides.

64 channels: at 32 every channel is its own GroupNorm group, which would
cancel per-channel conditioning. The port runs ``split_skip_conv`` in the
concat form (the same math), so its cases hold that against JAX's split
emission.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import UNetConfig
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.models.convert import jax_unet_to_torch, state_dict_to_torch
from worddiffusion_tpu_torch.models.unet import UNet

torch.set_num_threads(1)

CFG = UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                 num_writers=8, max_seq_len=10, dtype="float32")
B = 2


def _extra(name: str, rng) -> dict:
    """The conditioning inputs of each variant, numpy."""
    f32 = np.float32
    return {
        "style_appended": {"style_vec": rng.standard_normal((B, 24)).astype(f32)},
        "style_replacing": {"style_vec": rng.standard_normal((B, 3, 24)).astype(f32)},
        "cond_latents": {"cond_latents": rng.standard_normal((B, 8, 32, 4)).astype(f32)},
        "glyph_images": {"char_images": rng.uniform(0, 1, (B, 10, 16, 16, 1)).astype(f32)},
        "writer_mix": {"writer_id2": np.array([7, 2], np.int32),
                       "mix_rate": np.array([0.3, 0.9], f32)},
    }.get(name, {})


VARIANTS = {
    "film": dict(use_scale_shift_norm=True),
    "split_skip": dict(split_skip_conv=True),
    "film_split_skip": dict(use_scale_shift_norm=True, split_skip_conv=True),
    "style_appended": dict(style_vec_dim=24),
    "style_replacing": dict(style_vec_dim=24, style_replace_context=True),
    "cond_latents": dict(img_conditioned=True),
    "glyph_images": dict(use_char_images=True),
    "writer_mix": {},
    "ocr_head": dict(ocr_head=True, ocr_hidden=64, ocr_classes=20),
    "ocr_head_no_norm": dict(ocr_head=True, ocr_hidden=64, ocr_classes=20, ocr_norm="none"),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 32, 4)).astype(np.float32), np.array([5, 50], np.int32),
            rng.integers(0, 53, (B, 10)).astype(np.int32), np.array([0, 3], np.int32))


def jax_params(cfg, extra, seed=3):
    """Every parameter of the JAX UNet random (0.05 * N(0, 1))."""
    shapes = jax.eval_shape(lambda r, *a: JaxUNet(cfg).init(r, *a, **extra),
                            jax.random.PRNGKey(0), *_inputs())
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def port_unet(cfg, params) -> UNet:
    m = UNet(port_cfg(cfg))
    m.load_state_dict(state_dict_to_torch(jax_unet_to_torch(params, cfg)), strict=True)
    return m.eval()


def _torch(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_unet_variant_matches_jax(name):
    """eps (and the CTC logits [T, B, K] with the head) within 1e-4
    relative + 1e-5 absolute, the existing UNet parity's fp32 tolerance."""
    cfg = dataclasses.replace(CFG, **VARIANTS[name])
    extra = _extra(name, np.random.default_rng(1))
    params = jax_params(cfg, extra)
    inp = _inputs()
    want = jax.jit(lambda p, *a: JaxUNet(cfg).apply(p, *a, **extra))(params, *inp)
    with torch.no_grad():
        got = port_unet(cfg, params)(*(_torch(a) for a in inp),
                                     **{k: _torch(v) for k, v in extra.items()})
    if cfg.ocr_head:
        (want, want_logits), (got, got_logits) = want, got
        assert got_logits.shape == (256, B, 20) and got_logits.dtype == torch.float32
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                                   atol=1e-5 * np.abs(want_logits).max())
    want = np.asarray(want)
    assert got.shape == (B, 8, 32, 4) and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["style_appended", "cond_latents", "writer_mix",
                                  "style_replacing"])
def test_unet_variant_conditioning_moves_eps(name):
    """Each conditioning reaches eps: other style vectors, reference latents
    or mix rates give another eps."""
    cfg = dataclasses.replace(CFG, **VARIANTS[name])
    extra = _extra(name, np.random.default_rng(1))
    params = jax_params(cfg, extra)
    m = port_unet(cfg, params)
    inp = [_torch(a) for a in _inputs()]
    with torch.no_grad():
        base = m(*inp, **{k: _torch(v) for k, v in extra.items()})
        other = m(*inp, **{k: _torch(v) * 0.5 for k, v in extra.items() if k != "writer_id2"},
                  **({"writer_id2": _torch(extra["writer_id2"])} if "writer_id2" in extra
                     else {}))
    assert (other - base).abs().max() > 1e-3 * base.abs().max()
