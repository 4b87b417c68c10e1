"""The PHOSC-conditioned model (the ``iam_phosc`` and ``gw`` presets) in the
port against the JAX package at a tiny width: the UNet, the word sampler,
one training step, the dataset record, and the regeneration and train
CLIs on the CPU.

The layout is the presets' (``attn1_cross=False``: self-attention, then
cross-attention over the characters and the 769 PHOSC tokens, which go
through the same CharacterEncoder). Weights are seeded numpy over the
whole JAX tree, so the zero-initialised output convs hide no sub-path.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import (
    DataConfig, DiffusionConfig, Experiment, TrainConfig, UNetConfig, VAEConfig,
)
from worddiffusion_tpu.data.phosc import phosc_vector
from worddiffusion_tpu.data.tokenizer import Tokenizer
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.sampler import ddpm_sample, latent_to_image
from worddiffusion_tpu.diffusion.sampler import regen_call_mask as jax_call_mask
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models import vae as jvae
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.train import state as jstate
from worddiffusion_tpu.train import step as jstep
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data import gt as port_gt
from worddiffusion_tpu_torch.data.dataset import LatentLookup, WordImageDataset
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer as PortTokenizer
from worddiffusion_tpu_torch.diffusion.sampler import regen_call_mask
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.generate.sample import WordSampler, phosc_ids
from worddiffusion_tpu_torch.models.convert import (
    jax_unet_to_torch, jax_vae_to_torch, state_dict_to_torch,
)
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.models.vae import AutoencoderKL
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)

T = 24
P = 769  # PHOS (165) + PHOC (604), for "eng" and "gw" alike
WORDS, WRITERS = ["word", "Hello"], [0, 3]


def phosc_exp(version="eng", max_chars=10, **train_kw):
    """The iam_phosc / gw layout at a tiny width (the JAX config;
    ``port_cfg`` hands its values to the port). 64 channels: at 32 every
    channel is its own GroupNorm group, which cancels per-channel
    conditioning outright."""
    return Experiment(
        name="tiny_phosc",
        unet=UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                        num_writers=8, max_seq_len=max_chars, attn1_cross=False,
                        use_phosc=True, phosc_dim=P, dtype="float32"),
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"),
        diffusion=DiffusionConfig(num_steps=T),
        data=DataConfig(max_chars=max_chars, alphabet="eng_main", phos_version=version,
                        batch_size=4),
        train=TrainConfig(ckpt_every_epochs=1, ema_warmup_steps=2, **train_kw),
    )


CFG = phosc_exp().unet


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((2, 8, 32, 4)).astype(np.float32),
        np.array([5, 20], np.int32),
        Tokenizer.from_name("eng_main", 10).encode_batch(WORDS).astype(np.int32),
        np.asarray(WRITERS, np.int32),
        phosc_ids(WORDS, "eng").astype(np.int32),
    )


def _random_tree(shapes, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _params(seed=3):
    return _random_tree(jax.eval_shape(JaxUNet(CFG).init, jax.random.PRNGKey(0), *_inputs()),
                        seed)


def _port(params):
    m = UNet(port_cfg(CFG))
    # strict: norm1 of the self-attention layout crosses too
    m.load_state_dict(state_dict_to_torch(jax_unet_to_torch(params, CFG)), strict=True)
    return m.eval()


def _run(m, x, t, ctx, wid, ph):
    with torch.no_grad():
        return m(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(ctx).long(), torch.from_numpy(wid).long(),
                 None if ph is None else torch.from_numpy(ph).long()).numpy()


def test_phosc_ids_are_the_jax_descriptors():
    got = phosc_ids(WORDS, "gw")
    assert got.shape == (2, P) and got.dtype == np.int64
    np.testing.assert_array_equal(got[1], phosc_vector("Hello", "gw", as_int=True))


def test_phosc_unet_matches_jax_fp32():
    """fp32 through a context of 10 + 769 tokens: other summation orders
    -> rtol 1e-4, atol 1e-5; the PHOSC tokens move the output."""
    params = _params()
    inp = _inputs()
    want = np.asarray(jax.jit(JaxUNet(CFG).apply)(params, *inp))
    port = _port(params)
    got = _run(port, *inp)
    assert got.shape == (2, 8, 32, 4) and got.dtype == np.float32
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    without = _run(port, *inp[:4], None)  # the 10 character tokens alone
    assert np.abs(without - got).max() > 1e-3


def _weights():
    key = jax.random.PRNGKey(0)
    exp = phosc_exp()
    vae_p = _random_tree(jax.eval_shape(
        jvae.AutoencoderKL(exp.vae).init, key, jnp.zeros((1, 16, 16, 3)), key), 2)
    return _params(1), vae_p


def test_word_sampler_with_phosc_matches_jax_pipeline():
    """Skip-step deterministic DDPM with the PHOSC ids, then the VAE
    decode, against the JAX pipeline on the same weights and x_init.
    Latents fp32 -> 1e-4 of their scale; uint8 pixels within 1."""
    exp = phosc_exp()
    unet_p, vae_p = _weights()
    x_init, _, ctx, wid, ph = _inputs(5)
    unet, vae = JaxUNet(CFG), jvae.AutoencoderKL(exp.vae)

    @jax.jit
    def run(x):
        lat = ddpm_sample(
            NoiseSchedule.linear(T), lambda xx, tt: unet.apply(unet_p, xx, tt, ctx, wid, ph),
            jax.random.PRNGKey(0), x, stochastic=False, call_mask=jax_call_mask(T))
        img = latent_to_image(lat, lambda z: jvae.decode_from_latent(vae, vae_p, z * 0.18215))
        return lat, (img * 255.0).astype(jnp.uint8)

    lat_j, img_j = (np.asarray(a) for a in run(x_init))

    port_vae = AutoencoderKL(port_cfg(exp.vae))
    port_vae.load_state_dict(state_dict_to_torch(jax_vae_to_torch(vae_p, port_cfg(exp.vae),
                                                                  decoder_only=True)))
    sampler = WordSampler(port_cfg(exp), _port(unet_p), port_vae, call_mask=regen_call_mask(T),
                          stochastic=False)
    lat = sampler.denoise(WORDS, WRITERS, torch.from_numpy(x_init), phosc=ph)
    img = sampler.decode(lat).numpy()
    lat = lat.numpy()
    np.testing.assert_allclose(lat, lat_j, rtol=1e-4, atol=1e-4 * np.abs(lat_j).max())
    assert img.dtype == np.uint8 and img.shape == (2, 64, 256, 3)
    assert np.abs(img.astype(int) - img_j.astype(int)).max() <= 1
    without = sampler.denoise(WORDS, WRITERS, torch.from_numpy(x_init)).numpy()
    assert np.abs(without - lat).max() > 1e-3  # the sampler hands the PHOSC ids on


def test_train_step_with_phosc_matches_jax():
    """One fp32 step with the PHOSC batch key: loss 1e-5 relative; each
    gradient 1e-4 of its largest entry (floored at 1e-2 of the largest
    gradient anywhere, as tests/test_torch_train.py argues), with the
    PHOSC path's encoder among them; the parameters after AdamW within
    2e-6 plus lr times what the gradients' difference makes of Adam's
    first update."""
    exp = phosc_exp(lr=1e-3, cfg_drop_prob=0.1)
    sched = NoiseSchedule.linear(T)
    params = _params()
    x, _, ctx, wid, ph = _inputs(1)
    batch = {"latent": x, "context": ctx, "writer": wid, "phosc": ph}

    jmodel = JaxUNet(CFG)
    rng = jax.random.PRNGKey(7)
    step_rng = jax.random.fold_in(rng, 0)
    loss_fn = jstep.make_loss_fn(jmodel, sched, exp)
    tx = jstate.make_optimizer(exp.train.lr, exp.train.weight_decay)
    train_step = jstep.make_train_step(jmodel, sched, exp, tx)

    @jax.jit
    def grads_and_step(state):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, batch, step_rng)
        return loss, grads, train_step(state, batch, rng)[0]

    jloss, jgrads, jnew = grads_and_step(jstate.TrainState.create(params, tx))
    t_rng, n_rng, d_rng = jax.random.split(step_rng, 3)
    t = np.asarray(jforward.sample_timesteps(sched, t_rng, 2))
    noise = np.asarray(jax.random.normal(n_rng, (2, 8, 32, 4), jnp.float32))
    keep = float(jax.random.uniform(d_rng, ()) >= 0.1)

    model = _port(params).train()
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    draws = StepDraws(torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy()),
                      torch.tensor(keep))
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in batch.items()}
    metrics = make_train_step(PortSchedule.linear(T), port_cfg(exp))(state, tb, draws)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=1e-5)

    named = dict(model.named_parameters())
    want_g = jax_unet_to_torch(jgrads, CFG)
    assert set(want_g) == set(named)
    floor = 1e-2 * max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        g = named[k].grad
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), floor),
                                   err_msg=k)
    assert named["word_emb.embedding.weight"].grad[:4].abs().max() > 0  # PHOSC ids 0..3

    want_p = jax_unet_to_torch(jnew.params, CFG)
    for k, p in model.named_parameters():
        g = named[k].grad.numpy()
        adam = exp.train.lr * np.abs(g / (np.abs(g) + 1e-8) - want_g[k] / (np.abs(want_g[k]) + 1e-8))
        assert (np.abs(p.detach().numpy() - want_p[k]) <= 2e-6 + adam).all(), k


def _dataset():
    samples = [port_gt.Sample(image=f"img{i}.png", writer=f"{i % 2:03d}", word=w)
               for i, w in enumerate(["the", "of", "and", "the"])]
    reg = port_gt.WriterRegistry()
    for s in samples:
        reg.add(s.writer)
    cache = LatentLookup({s.image: np.zeros((8, 32, 4), np.float32) for s in samples})
    return WordImageDataset(samples, reg, PortTokenizer.from_name("eng_main", 10),
                            port_cfg(DataConfig(max_chars=10, phos_version="gw")),
                            latent_cache=cache,
                            use_phosc=True)


def test_dataset_record_carries_phosc():
    ds = _dataset()
    rec = ds[1]
    assert rec["phosc"].dtype == np.int32 and rec["phosc"].shape == (P,)
    np.testing.assert_array_equal(rec["phosc"], phosc_vector("of", "gw", as_int=True))
    assert "phosc" not in WordImageDataset(ds.samples, ds.registry, ds.tokenizer, ds.cfg,
                                           latent_cache=ds.latent_cache)[1]


class _PhoscSpy:
    """Records the phosc_ids shape of every UNet call."""

    def __init__(self, monkeypatch):
        self.shapes = []
        forward = UNet.forward

        def spy(model, *a, **kw):
            ph = kw.get("phosc_ids", a[4] if len(a) > 4 else None)
            self.shapes.append(None if ph is None else tuple(ph.shape))
            return forward(model, *a, **kw)

        monkeypatch.setattr(UNet, "forward", spy)


def _gt(tmp_path, n=5):
    words = "the of and to in is was".split()[:n]
    gt = tmp_path / "words.filter27"
    rng = np.random.default_rng(0)
    lat = {}
    with open(gt, "w") as f:
        for i, w in enumerate(words):
            f.write(f"{i % 3:03d},a01-{i:03d}u-00 {w}\n")
            lat[f"a01-{i:03d}u-00.png"] = rng.standard_normal((8, 32, 4)).astype(np.float32)
    np.savez(tmp_path / "lat.npz", **lat)
    return str(gt), str(tmp_path / "lat.npz")


@pytest.mark.parametrize("preset,version,max_chars", [("iam_phosc", "eng", 10), ("gw", "gw", 16)])
def test_regen_cli_runs_phosc_presets(tmp_path, monkeypatch, preset, version, max_chars):
    """--preset iam_phosc and --preset gw (registered here at a tiny width)
    on --device cpu: every batch's UNet calls get [B, 769] PHOSC ids and
    every word is written."""
    monkeypatch.setitem(presets.PRESETS, preset, lambda: port_cfg(phosc_exp(version, max_chars)))
    spy = _PhoscSpy(monkeypatch)
    gt, _ = _gt(tmp_path)
    dump = tmp_path / "regen"
    stats = regen_cli.main(["--preset", preset, "--gt_file", gt, "--dump_path", str(dump),
                            "--batch_size", "2", "--no_ocr_filter", "1", "--device", "cpu"])
    assert stats.generated == stats.accepted == 5
    assert len([f for f in os.listdir(dump) if f.endswith(".png")]) == 5
    calls = int(regen_call_mask(T)[1:].sum())
    assert spy.shapes == [(2, P)] * (3 * calls), spy.shapes[:3]


@pytest.mark.parametrize("flag", ["--phosc", "--phos"])
def test_train_cli_phosc_switches_to_iam_phosc(tmp_path, monkeypatch, flag):
    """--preset iam with --phosc 1 (or --phos 1) trains the iam_phosc
    model (registered here at a tiny width), as the JAX CLI does: the
    dataset emits PHOSC ids, every step's UNet call and the preview get
    them, and the checkpoint loads as the PHOSC regeneration UNet."""
    monkeypatch.setitem(presets.PRESETS, "iam_phosc", lambda: port_cfg(phosc_exp()))
    gt, cache = _gt(tmp_path, n=4)
    args = train_cli.build_parser().parse_args([
        "--preset", "iam", flag, "1", "--gt_train", gt, "--latent_cache", cache,
        "--batch_size", "2", "--epochs", "1", "--preview_ddim", "2",
        "--save_path", str(tmp_path / "run"), "--device", "cpu"])
    trainer = train_cli.build(args)
    assert trainer.exp.name == "tiny_phosc" and trainer.exp.unet.use_phosc
    assert trainer.dataset[0]["phosc"].shape == (P,)
    spy = _PhoscSpy(monkeypatch)
    state = trainer.run(epochs=1)
    assert state.step == 2
    assert spy.shapes == [(2, P)] * 2 + [(3, P)] * 2, spy.shapes  # 2 steps, 2 DDIM preview calls
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    regen = UNet(trainer.exp.unet)
    regen.load_state_dict(torch.load(tmp_path / "run" / "ckpt" / "2" / "ema_unet.pt",
                                     weights_only=True), strict=True)
