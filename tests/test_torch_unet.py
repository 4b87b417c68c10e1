"""The port's UNet against the JAX UNet at a tiny width: weights go
across through the port's ``jax_unet_to_torch`` -> ``load_state_dict(strict=True)``.

Random weights (numpy, seeded) over the whole JAX parameter tree, so
the zero-initialised output convs do not hide sub-paths.
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

CFG = UNetConfig(
    model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
    num_writers=8, max_seq_len=10, attn1_cross=True, dtype="float32",
)


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, 8, 32, 4)).astype(np.float32),
        np.array([5, 50], np.int32)[:b],
        rng.integers(0, 53, (b, 10)).astype(np.int32),
        np.array([0, 3], np.int32)[:b],
    )


def _params(cfg, seed=3):
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), *_inputs())
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes
    )


def _port(cfg, params):
    m = UNet(port_cfg(cfg))
    m.load_state_dict(state_dict_to_torch(jax_unet_to_torch(params, cfg)), strict=True)
    return m.eval()


def _run(m, x, t, ctx, wid):
    with torch.no_grad():
        return m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx).long(),
                 torch.from_numpy(wid).long()).numpy()


def test_unet_matches_jax_fp32():
    params = _params(CFG)
    inp = _inputs()
    want = np.asarray(jax.jit(JaxUNet(CFG).apply)(params, *inp))
    got = _run(_port(CFG, params), *inp)
    assert got.shape == (2, 8, 32, 4) and got.dtype == np.float32
    assert np.abs(want).max() > 1e-2  # the randomised out conv carries signal
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_unet_matches_jax_bf16_loose():
    """bf16 activations: the frameworks round at different places (bias
    adds, silu, the FF hidden), so only a loose bound holds."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    params = _params(cfg)
    inp = _inputs(1)
    want = np.asarray(jax.jit(JaxUNet(cfg).apply)(params, *inp))
    got = _run(_port(cfg, params), *inp)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * scale, (np.abs(got - want).max(), scale)


def test_plain_ffn_switch_and_writer_clamp():
    """use_pallas_ffn=False forces the plain FF; on the CPU the default
    dispatcher takes the same plain path. Out-of-range writer ids clamp."""
    params = _params(CFG)
    x, t, ctx, wid = _inputs()
    base = _run(_port(CFG, params), x, t, ctx, wid)
    plain = _run(_port(dataclasses.replace(CFG, use_pallas_ffn=False), params), x, t, ctx, wid)
    np.testing.assert_array_equal(base, plain)
    clamped = _run(_port(CFG, params), x, t, ctx, np.array([-4, 99], np.int32))
    np.testing.assert_array_equal(clamped, _run(_port(CFG, params), x, t, ctx,
                                                np.array([0, 7], np.int32)))


def test_writer_mask_matches_jax():
    """The training's classifier-free drop: writer_mask 0 removes a
    sample's writer embedding, 1 keeps it (fp32, 1e-4). 64 channels: at
    32 every channel is its own GroupNorm group, which cancels the
    per-channel writer embedding outright."""
    cfg = dataclasses.replace(CFG, model_channels=64)
    params = _params(cfg)
    x, t, ctx, wid = _inputs()
    mask = np.array([1.0, 0.0], np.float32)
    want = np.asarray(jax.jit(lambda p, *a: JaxUNet(cfg).apply(p, *a[:4], writer_mask=a[4]))(
        params, x, t, ctx, wid, mask))
    with torch.no_grad():
        got = _port(cfg, params)(torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx).long(), torch.from_numpy(wid).long(),
                                 writer_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    unmasked = _run(_port(cfg, params), x, t, ctx, wid)
    np.testing.assert_array_equal(got[0], unmasked[0])
    assert np.abs(got[1] - unmasked[1]).max() > 1e-4


@pytest.mark.parametrize("option", [dict(return_attn=True), dict(fast_softmax=True)])
def test_unported_config_raises(option):
    """The two switches that were once refused build and match JAX (the
    name is kept from then). ``fast_softmax=True`` gives JAX's eps with the
    same switch (fp32: 1e-4 relative, 1e-5 absolute; its bf16 order is
    held in tests/test_torch_fast_softmax.py). ``return_attn`` builds and
    returns eps and the 8 maps keyed by JAX's intermediates paths, each
    within 1e-6 of JAX's sown softmax (tests/test_torch_attn_maps.py holds
    more)."""
    cfg = dataclasses.replace(CFG, **option)
    if not cfg.return_attn:
        params = _params(cfg)
        inp = _inputs()
        want = np.asarray(jax.jit(JaxUNet(cfg).apply)(params, *inp))
        np.testing.assert_allclose(_run(_port(cfg, params), *inp), want, rtol=1e-4, atol=1e-5)
        return
    params = _params(cfg)
    inp = _inputs()
    want, state = jax.jit(lambda p, *a: JaxUNet(cfg).apply(p, *a, mutable=["intermediates"]))(
        params, *inp)
    with torch.no_grad():
        eps, maps = _port(cfg, params)(*(torch.from_numpy(a) for a in inp[:2]),
                                       torch.from_numpy(inp[2]).long(),
                                       torch.from_numpy(inp[3]).long())
    np.testing.assert_allclose(eps.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    sown = {"/".join(p.key for p in path[:-1]): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]}
    assert len(maps) == 8 and sorted(maps) == sorted(sown)
    for k, m in maps.items():
        np.testing.assert_allclose(m.numpy(), sown[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("given", ["style_vec", "cond_latents", "char_images", "writer_id2"])
def test_unported_conditioning_raises(given):
    """A conditioning input the model's config does not take, or half of a
    writer mix, raises instead of being dropped (the JAX UNet ignores it)."""
    m = UNet(port_cfg(CFG)).eval()
    x, t, ctx, wid = (torch.from_numpy(a) for a in _inputs())
    extra = {"style_vec": torch.zeros(2, 16), "cond_latents": x,
             "char_images": torch.zeros(2, 10, 16, 16, 1), "writer_id2": wid.long()}
    with pytest.raises(ValueError, match="writer_id2 and mix_rate" if given == "writer_id2"
                       else given):
        m(x, t, ctx.long(), wid.long(), **{given: extra[given]})
