"""The port's training slice against the JAX package at a tiny width:
q_sample and DDIM, one training step (loss, gradients, AdamW, EMA),
checkpoints, the Trainer's bitwise resume and the train CLI.

JAX's draws of t, noise and the CFG keep flag are handed to the port
(threefry is not torch's generator); gradients cross through the port's
``jax_unet_to_torch``, which maps any Flax UNet tree (parameters or their
gradients) onto the port's parameter names.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import (
    DataConfig, DiffusionConfig, Experiment, TrainConfig, UNetConfig, VAEConfig,
)
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.sampler import ddim_sample as jax_ddim
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.train import state as jstate
from worddiffusion_tpu.train import step as jstep
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data.dataset import LatentLookup, WordImageDataset
from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
from worddiffusion_tpu_torch.diffusion.forward import q_sample, sample_timesteps
from worddiffusion_tpu_torch.diffusion.sampler import ddim_sample
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.models.convert import jax_unet_to_torch, state_dict_to_torch
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.train.checkpoint import CheckpointManager
from worddiffusion_tpu_torch.train.loop import Trainer
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)

# 64 channels: at 32 every channel is its own GroupNorm group, which
# cancels per-channel conditioning (time and writer embeddings) outright
CFG = UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                 num_writers=8, max_seq_len=10, dtype="float32")
T = 40


def tiny_exp(save_path="", **train_kw):
    """The JAX config; ``port_cfg`` hands its values to the port."""
    return Experiment(
        name="tiny", unet=CFG,
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"),
        diffusion=DiffusionConfig(num_steps=T),
        data=DataConfig(max_chars=10, alphabet="eng_main", batch_size=8),
        train=TrainConfig(**{"save_path": str(save_path), "ckpt_every_epochs": 1,
                             "ema_warmup_steps": 2, **train_kw}),
    )


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "latent": rng.standard_normal((b, 8, 32, 4)).astype(np.float32),
        "context": rng.integers(0, 53, (b, 10)).astype(np.int32),
        "writer": np.array([0, 3, 5, 1][:b], np.int32),
    }


def _jax_params(seed=3, cfg=CFG, extra=None):
    b = _batch()
    shapes = jax.eval_shape(lambda r, *a: JaxUNet(cfg).init(r, *a, **(extra or {})),
                            jax.random.PRNGKey(0), b["latent"], np.array([5, 9], np.int32),
                            b["context"], b["writer"])
    rng = np.random.default_rng(seed)
    # every parameter random: the zero-initialised output convs would hide sub-paths
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _port_sd(tree, cfg=CFG) -> dict:
    """A Flax UNet tree (parameters or their gradients) in the port's keys."""
    return jax_unet_to_torch(tree, cfg)


def _port_model(params, cfg=CFG):
    m = UNet(port_cfg(cfg))
    m.load_state_dict(state_dict_to_torch(_port_sd(params, cfg)), strict=True)
    return m


def test_q_sample_matches_jax():
    sched = NoiseSchedule.linear(T)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 8, 32, 4)).astype(np.float32)
    noise = rng.standard_normal((3, 8, 32, 4)).astype(np.float32)
    t = np.array([1, 17, T - 1], np.int32)
    want = np.asarray(jforward.q_sample(sched, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = q_sample(PortSchedule.linear(T), torch.from_numpy(x0), torch.from_numpy(t).long(),
                   torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sample_timesteps_support_and_generator():
    """t ~ U{1..T-1} like JAX's (whose threefry bits differ): the same
    range, every value reached, reproducible from the generator."""
    sched = PortSchedule.linear(T)
    t = sample_timesteps(sched, 4000, torch.Generator().manual_seed(0))
    t_again = sample_timesteps(sched, 4000, torch.Generator().manual_seed(0))
    jt = np.asarray(jforward.sample_timesteps(NoiseSchedule.linear(T), jax.random.PRNGKey(0),
                                              4000))
    assert torch.equal(t, t_again)
    assert set(t.tolist()) == set(jt.tolist()) == set(range(1, T))


@pytest.mark.parametrize("steps", [5, 12, T])
def test_ddim_matches_jax(steps):
    """eta 0 (the previews' DDIM) on the same x_init and eps function:
    the same float32 grid and coefficients -> 1e-5."""
    sched = NoiseSchedule.linear(T)
    x = np.random.default_rng(2).standard_normal((2, 8, 32, 4)).astype(np.float32)

    def eps_j(xx, tt):
        return 0.5 * jnp.tanh(xx) + 0.001 * tt[:, None, None, None].astype(jnp.float32)

    def eps_t(xx, tt):
        return 0.5 * torch.tanh(xx) + 0.001 * tt[:, None, None, None].float()

    want = np.asarray(jax_ddim(sched, eps_j, jax.random.PRNGKey(0), jnp.asarray(x),
                               num_steps=steps, eta=0.0))
    got = ddim_sample(PortSchedule.linear(T), eps_t, torch.from_numpy(x), num_steps=steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# the conditioned training steps: the UNet config, the train config and the
# batch's extra keys (numpy) of each
VARIANTS = {
    None: ({}, {}, lambda rng: {}),
    "ctc": (dict(ocr_head=True, ocr_hidden=64, ocr_classes=20), dict(ctc_weight=0.1),
            lambda rng: {"ocr_ids": rng.integers(1, 20, (2, 10)).astype(np.int32),
                         "ocr_len": np.array([4, 10], np.int32)}),
    "img_conditioned": (dict(img_conditioned=True), {}, lambda rng: {}),
    "style_replace": (dict(style_vec_dim=24, style_replace_context=True), {},
                      lambda rng: {"style_vec": rng.standard_normal((2, 24)).astype(np.float32)}),
}


@pytest.mark.parametrize("drop_prob,warmup,dropout,variant", [
    (0.1, 0, 0.0, None), (1.0, 5, 0.0, None), (0.1, 0, 0.1, None),
    (0.1, 0, 0.0, "ctc"), (0.1, 0, 0.0, "img_conditioned"), (0.1, 0, 0.0, "style_replace"),
], ids=["0.1-0", "1.0-5", "0.1-0-dropout0.1", "ctc", "img_conditioned", "style_replace"])
def test_train_step_matches_jax(drop_prob, warmup, dropout, variant):
    """One step under fp32: loss, every gradient, the parameters after
    AdamW and the EMA, against JAX's make_train_step on the same
    weights, batch and draws. drop_prob 1.0 drops the writer embedding
    (keep = 0) and warmup 5 takes the EMA's reset branch. dropout 0.1:
    JAX's step applies the UNet with deterministic=True, so the port's
    UNet (in train mode) must apply no dropout either. The conditioned
    steps: the CTC aux head with ``ctc_weight`` 0.1 (the metrics' ``ctc``
    too, 1e-5 relative), reference latents (the batch's clean latent, by
    default) and writer style vectors replacing the context.

    Tolerances: loss 1e-5 relative; each gradient 1e-4 of its largest
    entry (fp32, other summation orders through a 4-block UNet), floored
    at 1e-6 of the largest gradient anywhere: parameters whose exact
    gradient is (near) zero get rounding noise on both sides. The
    parameters after the step (an lr of 1e-3 moves them by up to 1e-3):
    2e-6 absolute plus what the gradients' own difference makes of
    Adam's first update, lr * |f(g_port) - f(g_jax)| with f(g) = g / (|g|
    + eps). That is near 0 where |g| >> eps and up to 2 lr where the
    gradient is rounding noise. The EMA: the same, times its weight on
    the new parameters (1 - beta, or 1 in the warmup's reset).

    Weight decay is 1.0 here, not the default 0.01: the decoupled decay
    moves a parameter by lr * wd * |p|, about 5e-5 at these weights, so
    that a dropped or coupled decay exceeds the tolerance; the test
    asserts that it does for most entries."""
    unet_kw, train_kw, batch_extra = VARIANTS[variant]
    exp = tiny_exp(cfg_drop_prob=drop_prob, ema_warmup_steps=warmup, lr=1e-3, weight_decay=1.0,
                   **train_kw)
    cfg = dataclasses.replace(CFG, dropout=dropout, **unet_kw)
    exp = exp.replace(unet=cfg)
    sched = NoiseSchedule.linear(T)
    batch = {**_batch(), **batch_extra(np.random.default_rng(5))}
    init_extra = {k: batch[k] for k in ("style_vec",) if k in batch}
    if cfg.img_conditioned:
        init_extra["cond_latents"] = batch["latent"]
    params = _jax_params(cfg=cfg, extra=init_extra)

    jmodel = JaxUNet(exp.unet)
    rng = jax.random.PRNGKey(7)
    step_rng = jax.random.fold_in(rng, 0)  # make_train_step folds in state.step = 0
    loss_fn = jstep.make_loss_fn(jmodel, sched, exp)
    tx = jstate.make_optimizer(exp.train.lr, exp.train.weight_decay)
    train_step = jstep.make_train_step(jmodel, sched, exp, tx)

    @jax.jit
    def grads_and_step(state):  # one program: XLA shares the forward and backward
        (loss, jmetrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, step_rng)
        return loss, jmetrics, grads, train_step(state, batch, rng)[0]

    jloss, jmetrics, jgrads, jnew = grads_and_step(jstate.TrainState.create(params, tx))
    t_rng, n_rng, d_rng = jax.random.split(step_rng, 3)
    t = np.asarray(jforward.sample_timesteps(sched, t_rng, 2))
    noise = np.asarray(jax.random.normal(n_rng, (2, 8, 32, 4), jnp.float32))
    keep = float(jax.random.uniform(d_rng, ()) >= drop_prob)

    model = _port_model(params, exp.unet)
    assert model.training
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    draws = StepDraws(torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy()),
                      torch.tensor(keep))
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in batch.items()}
    metrics = make_train_step(PortSchedule.linear(T), port_cfg(exp))(state, tb, draws)
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)

    named = dict(model.named_parameters())
    want_g = _port_sd(jgrads, cfg)
    assert set(want_g) == set(named)
    floor = 1e-2 * max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = named[k].grad
        assert g is not None and g.dtype == torch.float32, k
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=k)
    if drop_prob == 1.0:  # the writer embedding was dropped: no gradient reaches it
        assert not named["label_emb.weight"].grad.any()
    # the variant's own parameters take a gradient: the head, the style
    # projection, conv_in's reference-latent input channels
    own = {"ctc": "auxhead.lin2.weight", "style_replace": "wrd_proj.weight",
           "img_conditioned": "input_blocks.0.0.weight"}.get(variant)
    if own:
        assert named[own].grad[:, -4:].abs().max() > 0, own

    def f(g):
        return g / (np.abs(g) + 1e-8)

    adam_diff = {k: exp.train.lr * np.abs(f(named[k].grad.numpy()) - f(w))
                 for k, w in want_g.items()}
    ema_weight = 1.0 if warmup else 1.0 - exp.train.ema_beta
    old_p = _port_sd(params, cfg)
    seen, total = 0, 0
    for tree, module, weight in ((jnew.params, model, 1.0), (jnew.ema_params, state.ema,
                                                             ema_weight)):
        want_p = _port_sd(tree, cfg)
        for k, p in module.named_parameters():
            err = np.abs(p.detach().numpy() - want_p[k])
            tol = 2e-6 + weight * adam_diff[k]
            assert (err <= tol).all(), (k, err.max())
            if module is model:  # the decay's own move, lr * wd * |p_old|
                decay = exp.train.lr * exp.train.weight_decay * np.abs(old_p[k])
                seen += int((decay > 2 * tol).sum())
                total += decay.size
    assert seen > 0.5 * total, (seen, total)


def _dataset(n=32, seed=0):
    samples = [Sample(image=f"img{i:03d}.png", writer=f"{i % 5:03d}", word=w)
               for i, w in enumerate(("the of and to in is was that " * 4).split()[:n])]
    reg = WriterRegistry()
    for s in samples:
        reg.add(s.writer)
    rng = np.random.default_rng(seed)
    cache = LatentLookup({s.image: rng.standard_normal((8, 32, 4)).astype(np.float32)
                          for s in samples})
    return WordImageDataset(samples, reg, Tokenizer.from_name("eng_main", 10),
                            port_cfg(DataConfig(max_chars=10)), latent_cache=cache)


def _state_equal(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return (
        a.step == b.step
        and all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))
        and all(torch.equal(x, y) for x, y in zip(a.ema.parameters(), b.ema.parameters()))
        and sa.keys() == sb.keys()
        and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    )


def test_trainer_resume_is_bit_deterministic(tmp_path):
    """The Trainer's RNG & resume contract (as
    tests/test_train_loop.py::test_resume_is_bit_deterministic pins it for
    JAX): kill a run mid-epoch with max_steps, resume from the
    checkpoint, and the model, EMA and optimizer state are bitwise those
    of an uninterrupted run."""
    ds = _dataset()
    spe = len(ds) // 8
    assert spe >= 2  # the kill point lands mid-epoch
    full = Trainer(port_cfg(tiny_exp(tmp_path / "a")), ds, device="cpu").run(epochs=2)

    exp_b = port_cfg(tiny_exp(tmp_path / "b"))
    kill_at = spe + 1
    part = Trainer(exp_b, ds, device="cpu").run(epochs=2, max_steps=kill_at)
    assert part.step == kill_at
    resumed = Trainer(exp_b, ds, device="cpu").run(epochs=2, resume=True)
    assert resumed.step == full.step == 2 * spe
    assert _state_equal(resumed, full)
    init = Trainer(port_cfg(tiny_exp(tmp_path / "c")), ds, device="cpu").init_state()
    assert not all(torch.equal(x, y) for x, y in
                   zip(full.model.parameters(), init.model.parameters()))


def test_checkpoint_roundtrip_and_retention(tmp_path):
    model = UNet(port_cfg(CFG))
    state = TrainState.create(model, make_optimizer(model.parameters(), 1e-3))
    step = make_train_step(PortSchedule.linear(T), port_cfg(tiny_exp()))
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in _batch().items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    for _ in range(5):
        step(state, tb)
        mgr.save(state.step, state, {"loss": 0.5})
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not [n for n in os.listdir(mgr.directory) if n.startswith(".tmp")]

    fresh = UNet(port_cfg(CFG))
    restored = mgr.restore(TrainState.create(fresh, make_optimizer(fresh.parameters(), 1e-3)))
    assert _state_equal(restored, state)
    # the EMA alone loads as the regeneration CLI's --torch_ckpt
    regen_unet = UNet(port_cfg(CFG))
    regen_unet.load_state_dict(torch.load(mgr.path(5, "ema_unet.pt"), weights_only=True),
                               strict=True)
    assert all(torch.equal(a, b) for a, b in zip(regen_unet.parameters(), state.ema.parameters()))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(restored)


def _cli_files(tmp_path, n=12):
    words = "the of and to in is was that for it with as".split()[:n]
    gt = tmp_path / "words.filter27"
    rng = np.random.default_rng(0)
    lat = {}
    with open(gt, "w") as f:
        for i, w in enumerate(words):
            f.write(f"{i % 4:03d},a01-{i:03d}u-00 {w}\n")
            lat[f"a01-{i:03d}u-00.png"] = rng.standard_normal((8, 32, 4)).astype(np.float32)
    np.savez(tmp_path / "lat.npz", **lat)
    return str(gt), str(tmp_path / "lat.npz")


def test_train_cli_runs_from_latent_cache(tmp_path, monkeypatch):
    """The train CLI on --device cpu at a tiny preset: 2 epochs of 3
    steps, checkpoints and DDIM previews each epoch; the EMA checkpoint
    then loads as the regeneration CLI's --torch_ckpt."""
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    gt, cache = _cli_files(tmp_path)
    save = tmp_path / "run"
    state = train_cli.main([
        "--preset", "tiny", "--gt_train", gt, "--latent_cache", cache, "--batch_size", "4",
        "--epochs", "2", "--ckpt_every_epochs", "1", "--save_path", str(save),
        "--preview_ddim", "4", "--device", "cpu",
    ])
    assert state.step == 6
    assert sorted(os.listdir(save / "ckpt")) == ["3", "6"]
    assert sorted(os.listdir(save / "images")) == ["epoch_0000.png", "epoch_0001.png"]
    with open(save / "images" / "epoch_0001.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    args = regen_cli.build_parser().parse_args([
        "--preset", "tiny", "--gt_file", gt, "--device", "cpu", "--no_ocr_filter", "1",
        "--torch_ckpt", str(save / "ckpt" / "6" / "ema_unet.pt"),
    ])
    regen, _ = regen_cli.build(args)
    assert all(torch.equal(a, b) for a, b in
               zip(regen.sampler.model.parameters(), state.ema.parameters()))


@pytest.mark.parametrize("flags,error,match", [
    (["--synthetic", "1", "--augMaps", "1"], None, "augment"),
    (["--charImages", "1", "--hiGanArch", "1"], SystemExit, "hiGanArch 1 takes no glyph images"),
    (["--hiGanArch", "1"], None, "higan"),
    (["--augMaps", "1"], None, "augment"),
    (["--mesh_data", "2"], ValueError, "--mesh_data 2 must equal the number of processes"),
    (["--latent", "0"], None, "pixel"),
    (["--vae_ckpt", "vae_dir"], SystemExit, "no vae.pt"),
    (["--mesh_model", "3"], ValueError, "num_heads 4 is not divisible by the model axis 3"),
    (["--wrdChrWrStyl", "1"], SystemExit, "--style_dict"),
])
def test_train_cli_refuses_unported(tmp_path, monkeypatch, flags, error, match):
    """The train CLI's refusals, and (``error`` None) flags whose paths it
    runs: each builds and takes a step at a tiny preset, ``match`` naming what it checks -- the augmentation in the
    dataset (rendered crops, encoded by the VAE), the HiGAN+ denoiser, pixel
    space (3 channels, no VAE). A mesh above one process needs torchrun; a
    model axis that does not divide the heads is refused before it starts."""
    gt, cache = _cli_files(tmp_path, n=2)
    argv = ["--gt_train", gt, "--latent_cache", cache, "--device", "cpu",
            "--save_path", str(tmp_path / "run")] + flags
    if error is not None:
        with pytest.raises(error, match=match):
            train_cli.main(argv)
        return
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    argv = ["--preset", "tiny", "--batch_size", "2", "--img_size", "16,64", "--vocab_size", "1",
            "--samples_per_word", "2", "--preview_ddim", "2"] + argv
    if match != "higan":  # images, not the cache
        i = argv.index("--latent_cache")
        argv = argv[:i] + argv[i + 2:]
    trainer = train_cli.build(train_cli.build_parser().parse_args(argv))
    if match == "augment":
        from worddiffusion_tpu_torch.data.augment import random_augment

        assert trainer.dataset.augment_fn is random_augment and trainer.encode_fn is not None
    elif match == "higan":
        from worddiffusion_tpu_torch.models.higan import HiGanDenoiserAdapter

        assert isinstance(trainer.model, HiGanDenoiserAdapter) and trainer.preview_fn is None
    else:
        assert trainer.encode_fn is None and trainer.exp.unet.in_channels == 3
        assert trainer.dataset[0]["image"].shape == (16, 64, 3)
    state = trainer.run(epochs=1, max_steps=1)
    assert state.step == 1 and all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_cli_conditioned_runs(tmp_path, monkeypatch):
    """The train CLI on --device cpu at a tiny preset with --ocrTraining 1
    --imgConditioned 1 (the words' CTC targets in the preset's alphabet
    after the blank class 0), then with --wrdChrWrStyl 1 and a
    --style_dict: 3 steps each; the aux head, conv_in's reference-latent
    channels and the style projection are trained, and ``ctc`` is logged."""
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp(log_every=1)))
    gt, cache = _cli_files(tmp_path)
    argv = ["--preset", "tiny", "--gt_train", gt, "--latent_cache", cache, "--batch_size", "4",
            "--epochs", "1", "--preview_ddim", "2", "--device", "cpu"]

    def run(save, *flags):
        trainer = train_cli.build(train_cli.build_parser().parse_args(
            argv + ["--save_path", str(tmp_path / save), *flags]))
        initial = {k: v.clone() for k, v in trainer.init_state().model.state_dict().items()}
        state = trainer.run(epochs=1)
        assert state.step == 3
        return trainer, {k: (v - initial[k]).abs().max().item()
                         for k, v in state.model.state_dict().items()}

    trainer, changed = run("ocr", "--ocrTraining", "1", "--imgConditioned", "1")
    cfg = trainer.exp.unet
    assert cfg.ocr_head and cfg.img_conditioned and trainer.exp.train.ctc_weight == 0.1
    rec = trainer.dataset[0]
    assert rec["word"] == "the" and rec["ocr_ids"][:3].tolist() == [46, 34, 31]  # t h e, + 1
    assert rec["ocr_len"] == 3
    assert changed["auxhead.lin2.weight"] > 0 and changed["auxhead.temporal_i.1.weight"] > 0
    assert changed["input_blocks.0.0.weight"] > 0
    logged = [line for line in open(tmp_path / "ocr" / "metrics.jsonl") if '"ctc"' in line]
    assert logged, "no ctc metric logged"

    writers = sorted({line.split(",")[0] for line in open(gt)})
    np.savez(tmp_path / "styles.npz", **{w: np.random.default_rng(int(w)).standard_normal(
        4096).astype(np.float32) for w in writers})
    trainer, changed = run("style", "--wrdChrWrStyl", "1", "--style_dict",
                           str(tmp_path / "styles.npz"))
    assert trainer.exp.unet.style_vec_dim == 4096 and trainer.exp.unet.style_replace_context
    assert changed["wrd_proj.weight"] > 0


def test_jax_train_cli_ocr_training_has_no_targets(tmp_path, monkeypatch):
    """The reference-side fault the port's train CLI repairs: the JAX train
    CLI builds its dataset with ocr_alphabet=None, so --ocrTraining 1 fails
    at its first step reading batch["ocr_ids"]."""
    from worddiffusion_tpu.cli import train as jtrain_cli
    from worddiffusion_tpu.configs import presets as jpresets

    monkeypatch.setitem(jpresets.PRESETS, "iam", lambda: tiny_exp())
    gt, cache = _cli_files(tmp_path, n=4)
    with pytest.raises(KeyError, match="ocr_ids"):
        jtrain_cli.main(["--gt_train", gt, "--latent_cache", cache, "--batch_size", "2",
                         "--epochs", "1", "--mesh_data", "1", "--ocrTraining", "1",
                         "--save_path", str(tmp_path / "run")])


def test_train_cli_refuses_cpu_fallback(monkeypatch, tmp_path):
    gt, cache = _cli_files(tmp_path, n=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(["--gt_train", gt, "--latent_cache", cache,
                        "--save_path", str(tmp_path / "run")])
