"""The HiGAN+ denoiser (``models/higan.py``, ``--hiGanArch 1``) of the port
against the JAX package at a tiny width: the condition-modulated block,
the generator, the adapter (weights through ``jax_higan_to_torch``, every
parameter random so the zero-initialised convs carry signal), a training
step, the refusals of the conditioning JAX's adapter drops, and the three
CLIs. fp32 within 1e-4 relative (1e-5 of the largest value absolute); bf16
within 5% of the largest value."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import UNetConfig
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models.higan import CondResBlock as JaxBlock
from worddiffusion_tpu.models.higan import HiGanDenoiserAdapter as JaxAdapter
from worddiffusion_tpu.train import state as jstate
from worddiffusion_tpu.train import step as jstep
from test_torch_copies import port_cfg
from test_torch_train import T, _cli_files, tiny_exp
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import sample as sample_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.models.convert import (
    _conv, _linear, _norm, jax_higan_to_torch, state_dict_to_torch,
)
from worddiffusion_tpu_torch.models.higan import CondResBlock, HiGanDenoiserAdapter
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)
CFG = UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54, num_writers=8,
                 max_seq_len=10, dtype="float32")
BLOCKS = 2


def _inputs(seed=0, shape=(2, 8, 32, 4)):
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, 53, (2, 10)).astype(np.int32)
    ctx[0, 4:] = 0  # PAD tail: text_len 4 and 10
    return (rng.standard_normal(shape).astype(np.float32), np.array([5, 31], np.int32), ctx,
            np.array([0, 3], np.int32))


def _random(shapes, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _adapter_params(cfg=CFG, seed=3):
    return _random(jax.eval_shape(JaxAdapter(cfg, BLOCKS).init, jax.random.PRNGKey(0),
                                  *_inputs()), seed)


def _port(cfg, params) -> HiGanDenoiserAdapter:
    m = HiGanDenoiserAdapter(port_cfg(cfg), BLOCKS)
    m.load_state_dict(state_dict_to_torch(jax_higan_to_torch(params)), strict=True)
    return m


def _t(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def test_cond_res_block_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 32, 64)).astype(np.float32)
    cond = np.random.default_rng(2).standard_normal((2, 96)).astype(np.float32)
    params = _random(jax.eval_shape(JaxBlock(64, dtype="float32").init, jax.random.PRNGKey(0),
                                    x, cond))
    want = np.asarray(JaxBlock(64, dtype="float32").apply(params, x, cond))
    p, sd = params["params"], {}
    for n in ("cgn1", "cgn2"):
        _norm(p[n], n, sd)
        _linear(p[n + "_proj"]["Dense_0"], n + "_proj", sd)
    for n in ("conv1", "conv2"):
        _conv(p[n]["Conv_0"], n, sd)
    block = CondResBlock(64, 96)
    block.load_state_dict(state_dict_to_torch(sd), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(cond))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,shape", [("float32", (2, 8, 32, 4)), ("float32", (2, 16, 64, 3)),
                                         ("bfloat16", (2, 8, 32, 4))],
                         ids=["latent", "pixel", "bf16"])
def test_adapter_matches_jax(dtype, shape):
    """The whole denoiser through ``jax_higan_to_torch`` (latent 8x32x4 and
    pixel 16x64x3): 2 * blocks + 1 GroupNorms a call (B.5's launches on the
    card; the plain version here)."""
    cfg = dataclasses.replace(CFG, dtype=dtype, in_channels=shape[-1], out_channels=shape[-1])
    inp = _inputs(shape=shape)
    params = _random(jax.eval_shape(JaxAdapter(cfg, BLOCKS).init, jax.random.PRNGKey(0), *inp))
    want = np.asarray(jax.jit(JaxAdapter(cfg, BLOCKS).apply)(params, *inp))
    model = _port(cfg, params)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.GroupNorm)]
    assert len(norms) == 2 * BLOCKS + 1
    with torch.no_grad():
        got = model(*(_t(a) for a in inp)).numpy()
    assert got.shape == shape and got.dtype == np.float32 and np.abs(want).max() > 1e-2
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    else:
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_default_adapter_has_13_norms():
    """6 blocks: 13 GroupNorms a call (12 modulated without SiLU, out_norm
    with it), the B.5 launches phase 24 of the card's check counts."""
    model = HiGanDenoiserAdapter(port_cfg(CFG))
    assert sum(isinstance(m, torch.nn.GroupNorm) for m in model.modules()) == 13


def test_higan_train_step_matches_jax():
    """One step (lr 1e-5): the loss 1e-5 relative and the parameters after
    AdamW (Adam's sign-like first update bounds a difference by 2 lr; 99% of
    the entries within 1e-7); JAX's draws handed in, the writer drop's
    keep flag accepted and, as in JAX, without effect."""
    exp = tiny_exp(lr=1e-5).replace(unet=CFG)
    params = _adapter_params()
    x, _, ctx, wid = _inputs(5)
    batch = {"latent": x, "context": ctx, "writer": wid}
    sched = NoiseSchedule.linear(T)
    tx = jstate.make_optimizer(exp.train.lr, exp.train.weight_decay)
    key = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jstep.make_train_step(JaxAdapter(CFG, BLOCKS), sched, exp, tx))(
        jstate.TrainState.create(params, tx), batch, key)
    t_rng, n_rng, d_rng = jax.random.split(jax.random.fold_in(key, 0), 3)
    draws = StepDraws(_t(jforward.sample_timesteps(sched, t_rng, 2)),
                      torch.from_numpy(np.array(jax.random.normal(n_rng, x.shape))),
                      torch.tensor(0.0))
    model = _port(CFG, params).train()
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    metrics = make_train_step(PortSchedule.linear(T), port_cfg(exp))(
        state, {k: _t(v) for k, v in batch.items()}, draws)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    want = jax_higan_to_torch(jax.device_get(jnew.params))
    for k, v in model.state_dict().items():
        d = np.abs(v.numpy().astype(np.float64) - want[k])
        assert d.max() <= 2e-5 and np.mean(d <= 1e-7) >= 0.99, (k, d.max())


@pytest.mark.parametrize("given", ["phosc_ids", "style_vec", "cond_latents", "char_images",
                                   "writer_id2", "mix_rate"])
def test_adapter_refuses_what_jax_drops(given):
    """JAX's adapter accepts these and ignores them; the port refuses each,
    naming it. An unknown keyword is a TypeError."""
    model = HiGanDenoiserAdapter(port_cfg(CFG), BLOCKS).eval()
    x, t, ctx, wid = (_t(a) for a in _inputs())
    with pytest.raises(ValueError, match=f"takes no.*{given}"):
        model(x, t, ctx, wid, **{given: torch.zeros(2, 3)})
    with pytest.raises(TypeError, match="unexpected"):
        model(x, t, ctx, wid, bogus=None)


def test_writer_mask_has_no_effect_as_in_jax():
    model = HiGanDenoiserAdapter(port_cfg(CFG), BLOCKS).eval()
    from worddiffusion_tpu_torch.models.layers import init_weights_

    init_weights_(model, seed=1, zero_init=False)
    x, t, ctx, wid = (_t(a) for a in _inputs())
    with torch.no_grad():
        a = model(x, t, ctx, wid)
        b = model(x, t, ctx, wid, writer_mask=torch.zeros(2))
    assert torch.equal(a, b)


def test_higan_clis_train_regenerate_sample(tmp_path, monkeypatch):
    """--hiGanArch 1 through the train CLI (from a latent cache, no
    previews), then its EMA weights in the regeneration and sampling CLIs;
    13 GroupNorm calls a denoiser call; conditioning the generator does not
    take exits naming it."""
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    gt, cache = _cli_files(tmp_path, n=4)
    save = tmp_path / "run"
    state = train_cli.main(["--preset", "tiny", "--gt_train", gt, "--latent_cache", cache,
                            "--batch_size", "2", "--epochs", "1", "--hiGanArch", "1",
                            "--save_path", str(save), "--device", "cpu"])
    assert isinstance(state.model, HiGanDenoiserAdapter) and state.step == 2
    assert not (save / "images").exists()
    ckpt = str(save / "ckpt" / "2" / "ema_unet.pt")
    regen, samples = regen_cli.build(regen_cli.build_parser().parse_args([
        "--preset", "tiny", "--gt_file", gt, "--hiGanArch", "1", "--torch_ckpt", ckpt,
        "--no_ocr_filter", "1", "--ddim", "2", "--dump_path",
        str(tmp_path / "regen"), "--device", "cpu"]))
    calls = []
    for m in regen.sampler.model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.register_forward_hook(lambda *_: calls.append(1))
    assert regen.run(samples, batch_size=4).generated == 4
    assert len(calls) == 2 * 13  # DDIM-2: two calls of 13 norms
    names = sample_cli.main(["--preset", "tiny", "--words", "of", "--writer", "1",
                             "--hiGanArch", "1", "--torch_ckpt", ckpt, "--ddim", "2",
                             "--device", "cpu", "--save_path", str(tmp_path / "s")])
    assert names == ["00000_1_of.png"] and os.path.exists(tmp_path / "s" / names[0])
    with pytest.raises(SystemExit, match="hiGanArch 1 takes no.*writer mix"):
        sample_cli.main(["--preset", "tiny", "--words", "of", "--hiGanArch", "1", "--writer2",
                         "3", "--device", "cpu"])
