"""One training step of a ``channel_mult=(1, 2)`` UNet, the width at which
the port's FF backward and fold kernels now train on the card, against the
JAX package's jitted loss and gradients on the CPU, without the fold and
with it (``attn_fold_context``, every attention folded: 2 heads x 10
characters <= 64). On the CPU the port's FF sub-layers and folds take their
plain versions; the CUDA kernels are held to those on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 35). Inputs, weights and JAX's
draws are seeded numpy handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import port_cfg
from worddiffusion_tpu.configs.config import (
    DataConfig, DiffusionConfig, Experiment, TrainConfig, UNetConfig, VAEConfig,
)
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.train import step as jstep
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
from worddiffusion_tpu_torch.models.convert import jax_unet_to_torch, state_dict_to_torch
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.ops import fold_attention
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(2)

B, T = 2, 40
# 64 channels at the first level and 128 at the second and in the middle
# block (at 32 every channel would be its own GroupNorm group)
CFG = UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54, num_writers=8,
                 max_seq_len=10, attn1_cross=True, dtype="float32", channel_mult=(1, 2))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 32, 4)).astype(np.float32), np.array([5, 30], np.int32),
            rng.integers(0, 53, (B, 10)).astype(np.int32), np.array([0, 3], np.int32))


def _params(cfg, seed):
    """Every parameter random (the zero-initialised output convs too)."""
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), *_inputs())
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("fold", [False, True])
def test_train_step_at_channel_mult_12_matches_jax(fold):
    """One fp32 step, JAX's draws handed to the port: loss 1e-5 relative;
    each gradient 1e-4 of its largest entry, floored at 1e-2 of the largest
    gradient anywhere (as tests/test_torch_train.py argues). With the fold,
    every transformer block's two attentions run FoldAttention, whose plain
    recompute backward gives the q/k/v/out weights their gradients."""
    cfg = dataclasses.replace(CFG, attn_fold_context=True if fold else None)
    exp = Experiment(
        name="tiny_wide", unet=cfg,
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"),
        diffusion=DiffusionConfig(num_steps=T),
        data=DataConfig(max_chars=10, alphabet="eng_main", batch_size=B),
        train=TrainConfig(lr=1e-3, cfg_drop_prob=0.1, ema_warmup_steps=2),
    )
    sched = NoiseSchedule.linear(T)
    params = _params(cfg, seed=13)
    x, _, ctx, wid = _inputs(2)
    batch = {"latent": x, "context": ctx, "writer": wid}
    step_rng = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    loss_fn = jstep.make_loss_fn(JaxUNet(cfg), sched, exp)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch, step_rng)
    t_rng, n_rng, d_rng = jax.random.split(step_rng, 3)
    t = np.asarray(jforward.sample_timesteps(sched, t_rng, B))
    noise = np.asarray(jax.random.normal(n_rng, (B, 8, 32, 4), jnp.float32))
    keep = float(jax.random.uniform(d_rng, ()) >= 0.1)

    model = UNet(port_cfg(cfg))
    model.load_state_dict(state_dict_to_torch(jax_unet_to_torch(params, cfg)), strict=True)
    model.train()
    widths = sorted({m.norm3.normalized_shape[0] for m in model.modules()
                     if isinstance(m, BasicTransformerBlock)})
    assert widths == [64, 128], widths
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in model.modules())
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    draws = StepDraws(torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy()),
                      torch.tensor(keep))
    tb = {"latent": torch.from_numpy(x), "context": torch.from_numpy(ctx).long(),
          "writer": torch.from_numpy(wid).long()}
    before = fold_attention.bwd_calls
    metrics = make_train_step(PortSchedule.linear(T), port_cfg(exp))(state, tb, draws)
    assert fold_attention.bwd_calls - before == (2 * blocks if fold else 0)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-5)

    named = dict(model.named_parameters())
    want_g = jax_unet_to_torch(jgrads, cfg)
    assert set(want_g) == set(named)
    floor = 1e-2 * max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = named[k].grad
        assert g is not None, k
        if ".to_" in k or ".ff.net." in k:
            assert g.abs().max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), floor),
                                   err_msg=k)
