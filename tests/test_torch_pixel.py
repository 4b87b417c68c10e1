"""Pixel-space diffusion (``--latent 0``) of the port against the JAX
package: the 3-channel UNet, ``pixel_to_uint8``, the ``WordSampler``
without a VAE (its OCR input and preview), a training step, and the
regeneration, sampling and training CLIs at a tiny preset.

fp32 throughout; the UNet and the sampler within 1e-4 relative (1e-5 of the
largest value absolute), the images bitwise where both sides round the same
floats, the step's loss 1e-5 relative."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.cli.sample import pixel_space_exp as jax_pixel_space_exp
from worddiffusion_tpu.configs.config import DataConfig, DiffusionConfig, Experiment
from worddiffusion_tpu.diffusion.sampler import pixel_to_uint8 as jax_pixel_to_uint8
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.generate import sample as jsample
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.train import state as jstate
from worddiffusion_tpu.train import step as jstep
from test_torch_copies import port_cfg
from test_torch_train import _cli_files, tiny_exp
from test_torch_unet_variants import CFG, port_unet
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import sample as sample_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.configs.pixel import pixel_space_exp
from worddiffusion_tpu_torch.diffusion.sampler import pixel_to_uint8
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.generate.sample import WordSampler
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)
T = 40
H, W = 16, 64  # a small image: the UNet's attention runs over all 1024 pixels
PCFG = dataclasses.replace(CFG, in_channels=3, out_channels=3)


def _exp():
    return jax_pixel_space_exp(Experiment(
        unet=CFG, diffusion=DiffusionConfig(num_steps=T),
        data=DataConfig(max_chars=10, alphabet="eng_main", img_height=H, img_width=W)))


def _params(cfg=PCFG, seed=3):
    x = np.zeros((2, H, W, 3), np.float32)
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), x,
                            np.array([1, 2], np.int32), np.zeros((2, 10), np.int32),
                            np.array([0, 1], np.int32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def test_pixel_space_exp_matches_jax():
    from worddiffusion_tpu.configs.presets import get as jget

    for name in ("iam", "gw"):
        want = jax_pixel_space_exp(jget(name))
        got = pixel_space_exp(presets.get(name))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert not got.data.latent and got.unet.in_channels == got.unet.out_channels == 3


def test_pixel_unet_matches_jax():
    """The 3-channel UNet at 16x64 (every pixel a position of the
    full-resolution attention): fp32, 1e-4 relative."""
    params = _params()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    t, ctx, wid = np.array([5, 31], np.int32), rng.integers(0, 53, (2, 10)).astype(np.int32), \
        np.array([0, 3], np.int32)
    want = np.asarray(jax.jit(JaxUNet(PCFG).apply)(params, x, t, ctx, wid))
    with torch.no_grad():
        got = port_unet(PCFG, params)(torch.from_numpy(x), torch.from_numpy(t).long(),
                                      torch.from_numpy(ctx).long(), torch.from_numpy(wid).long())
    assert got.shape == (2, H, W, 3) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_pixel_to_uint8_truncates_as_jax():
    """[-1, 1] -> uint8 truncating, as JAX's astype: 0.999 maps to 254
    (rounding would give 255), bitwise on a dense grid and outside [-1, 1]."""
    x = np.concatenate([np.linspace(-1.2, 1.2, 20001, dtype=np.float32),
                        np.array([0.999, -0.999, 0.0, 1.0, -1.0, 0.9961, 0.99215686],
                                 np.float32)])
    want = np.asarray(jax_pixel_to_uint8(jnp.asarray(x)))
    got = pixel_to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got[-7] == 254 and want[-7] == 254


def test_word_sampler_without_vae_matches_jax(monkeypatch):
    """The JAX WordSampler on a pixel-space experiment (x_T [B, 16, 64, 3]
    from fold_in(rng, 0), DDIM-4) against the port's: the images before
    the uint8 cast within 1e-4, and the port's uint8 of JAX's floats equal
    to JAX's."""
    exp = _exp()
    params = _params()
    words, writers = ["word", "Hello"], [0, 3]
    rng = jax.random.PRNGKey(4)
    with monkeypatch.context() as m:
        m.setattr(jsample, "pixel_to_uint8", lambda x: x)
        want = np.asarray(jsample.WordSampler(exp, params, ddim_steps=4).sample(
            words, writers, rng))
    want_u8 = np.asarray(jsample.WordSampler(exp, params, ddim_steps=4).sample(
        words, writers, rng))
    x_init = np.array(jax.random.normal(jax.random.fold_in(rng, 0), (2, H, W, 3)))
    port = WordSampler(port_cfg(exp), port_unet(PCFG, params), None, ddim_steps=4)
    assert port.latent_shape == (H, W, 3)
    got = port.denoise(words, writers, torch.from_numpy(x_init))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(port.decode(torch.from_numpy(want)).numpy(), want_u8)


def test_word_sampler_pixel_ocr_input_and_preview():
    """The fused OCR reads the first channel of the uint8 image in [-1, 1]
    ([B, H, W, 1]); the preview samples 3 probe words as [3, H, W, 3]."""
    exp = port_cfg(_exp())
    model = port_unet(PCFG, _params())
    seen = []

    def ocr(gray):
        seen.append(gray)
        return torch.zeros(gray.shape[0], 8, 5)

    sampler = WordSampler(exp, model, None, ddim_steps=2, ocr_apply=ocr)
    img, ids = sampler.sample_async(["of", "to"], [1, 2], torch.Generator().manual_seed(0))
    assert img.shape == (2, H, W, 3) and img.dtype == torch.uint8 and ids.shape == (2, 8)
    np.testing.assert_array_equal(seen[0].numpy(), img[..., :1].float().numpy() / 127.5 - 1.0)
    preview = WordSampler(exp, model, None, ddim_steps=2).sample_preview(
        torch.Generator().manual_seed(1))
    assert preview.shape == (3, H, W, 3) and preview.dtype == np.uint8
    with pytest.raises(ValueError, match="takes none"):
        WordSampler(exp, model, torch.nn.Identity())


def test_pixel_train_step_matches_jax():
    """One pixel-space step: the batch's image [-1, 1] is x0 (no VAE); the
    loss and the updated parameters against JAX's step on the same weights,
    batch and draws (lr 1e-5: Adam's sign-like first update bounds a
    difference by 2 lr; 99% of the entries within 1e-7)."""
    exp = tiny_exp(lr=1e-5)
    exp = exp.replace(unet=PCFG, data=dataclasses.replace(exp.data, latent=False,
                                                          img_height=H, img_width=W))
    params = _params()
    rng = np.random.default_rng(5)
    batch = {"latent": rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32),
             "context": rng.integers(0, 53, (2, 10)).astype(np.int32),
             "writer": np.array([0, 3], np.int32)}
    sched = NoiseSchedule.linear(T)
    tx = jstate.make_optimizer(exp.train.lr, exp.train.weight_decay)
    key = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jstep.make_train_step(JaxUNet(PCFG), sched, exp, tx))(
        jstate.TrainState.create(params, tx), batch, key)
    t_rng, n_rng, d_rng = jax.random.split(jax.random.fold_in(key, 0), 3)
    from worddiffusion_tpu.diffusion import forward as jforward

    draws = StepDraws(torch.from_numpy(np.asarray(jforward.sample_timesteps(sched, t_rng, 2))).long(),
                      torch.from_numpy(np.array(jax.random.normal(n_rng, (2, H, W, 3)))),
                      torch.tensor(float(jax.random.uniform(d_rng, ()) >= 0.1)))
    model = port_unet(PCFG, params).train()
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    pbatch = {"image": torch.from_numpy(batch["latent"]),
              "context": torch.from_numpy(batch["context"]).long(),
              "writer": torch.from_numpy(batch["writer"]).long()}
    metrics = make_train_step(PortSchedule.linear(T), port_cfg(exp))(state, pbatch, draws)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    from test_torch_train import _port_sd

    want = _port_sd(jax.device_get(jnew.params), PCFG)
    for k, v in model.state_dict().items():
        d = np.abs(v.numpy().astype(np.float64) - want[k])
        assert d.max() <= 2e-5 and np.mean(d <= 1e-7) >= 0.99, (k, d.max())


def test_pixel_clis_train_regenerate_sample(tmp_path, monkeypatch):
    """--latent 0 through the three CLIs at a tiny preset: training reads the
    crops (rendered here) as x0, builds no VAE and writes previews; its EMA
    weights regenerate the gt words and sample two more, as 3-channel
    images."""
    exp = port_cfg(tiny_exp())
    exp = exp.replace(data=dataclasses.replace(exp.data, img_height=H, img_width=W))
    monkeypatch.setitem(presets.PRESETS, "tiny_px", lambda: exp)
    gt, _ = _cli_files(tmp_path, n=4)
    save = tmp_path / "run"
    trainer = train_cli.build(train_cli.build_parser().parse_args([
        "--preset", "tiny_px", "--gt_train", gt, "--batch_size", "2", "--img_size", f"{H},{W}",
        "--latent", "0", "--save_path", str(save), "--preview_ddim", "2", "--device", "cpu"]))
    assert trainer.encode_fn is None and trainer.exp.unet.in_channels == 3
    assert trainer.dataset[0]["image"].shape == (H, W, 3)
    state = trainer.run(epochs=1)
    assert state.step == 2 and os.listdir(save / "images") == ["epoch_0000.png"]
    ckpt = str(save / "ckpt" / "2" / "ema_unet.pt")
    regen, samples = regen_cli.build(regen_cli.build_parser().parse_args([
        "--preset", "tiny_px", "--gt_file", gt, "--latent", "0", "--torch_ckpt", ckpt,
        "--no_ocr_filter", "1", "--ddim", "2", "--dump_path", str(tmp_path / "regen"),
        "--device", "cpu"]))
    assert regen.sampler.vae is None and regen.sampler.latent_shape == (H, W, 3)
    stats = regen.run(samples, batch_size=2)
    assert stats.generated == stats.accepted == 4 and len(os.listdir(tmp_path / "regen")) == 4
    names = sample_cli.main(["--preset", "tiny_px", "--words", "of,to", "--writer", "1",
                             "--latent", "0", "--torch_ckpt", ckpt, "--ddim", "2", "--device",
                             "cpu", "--save_path", str(tmp_path / "s")])
    assert names == ["00000_1_of.png", "00001_1_to.png"]
    from worddiffusion_tpu_torch.data.png import read_png

    assert read_png(str(tmp_path / "s" / names[0])).shape == (H, W, 3)


def test_self_attention_backward_too_large_raises(monkeypatch):
    """Self-attention over a pixel-space image (``attn1_cross=False``, as
    ``iam_phosc`` and ``gw``): the Trainer refuses a batch whose attention
    backward would form more than ``BACKWARD_BYTES_LIMIT`` of fp32 scores
    before any step (``iam_phosc`` at 64x256: B=8 needs 34 GiB), and the
    Function's backward refuses one before allocating it."""
    from worddiffusion_tpu_torch.ops import attention
    from worddiffusion_tpu_torch.train.loop import Trainer, check_attention_backward

    phosc = pixel_space_exp(presets.get("iam_phosc"))
    check_attention_backward(phosc, 1)  # 17 GiB: under the limit
    with pytest.raises(ValueError, match="Nq=16384, Nk=16384.*GiB"):
        check_attention_backward(phosc, 8)
    check_attention_backward(pixel_space_exp(presets.get("iam")), 128)  # cross only
    exp = port_cfg(tiny_exp()).replace(unet=port_cfg(dataclasses.replace(
        PCFG, attn1_cross=False)))
    exp = exp.replace(data=dataclasses.replace(exp.data, latent=False, img_height=H,
                                               img_width=W, batch_size=2))
    monkeypatch.setattr(attention, "BACKWARD_BYTES_LIMIT", 2 ** 20)
    with pytest.raises(ValueError, match="smaller batch"):
        Trainer(exp, [], device="cpu")
    q = torch.randn(1, 2, 300, 16, requires_grad=True)
    out = attention.fused_attention(q, q, q, 0.25)
    with pytest.raises(ValueError, match="Nq=300, Nk=300"):
        out.sum().backward()
