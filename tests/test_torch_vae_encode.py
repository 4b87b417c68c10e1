"""The port's VAE encoder, ``encode`` and ``encode_to_latent``, the
diffusers loader, ``build_latent_cache`` and its CLI, and training from
word images, against the JAX package at a narrow ``VAEConfig`` under fp32
(weights carried by ``jax_vae_to_torch`` or a diffusers-keyed dict).

Tolerance: 1e-4 of max |JAX| (fp32, other summation orders through ~20
convolutions and GroupNorms)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from worddiffusion_tpu.cli import build_latent_cache as jcache_cli
from worddiffusion_tpu.configs import presets as jpresets
from worddiffusion_tpu.configs.config import DataConfig, Experiment
from worddiffusion_tpu.models import vae as jvae
from test_torch_copies import port_cfg
from test_torch_train import tiny_exp
from test_torch_vae_ocr import PORT_VAE_CFG, VAE_CFG, _vae_params
from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data.dataset import LatentLookup
from worddiffusion_tpu_torch.data.loader import batches
from worddiffusion_tpu_torch.models.convert import jax_vae_to_torch, state_dict_to_torch
from worddiffusion_tpu_torch.models.layers import init_weights_
from worddiffusion_tpu_torch.models.vae import (
    AutoencoderKL, decode_from_latent, encode_to_latent, load_diffusers_vae, make_vae,
)
from worddiffusion_tpu_torch.ops import gn_conv, groupnorm
from worddiffusion_tpu_torch.train.step import make_train_step, step_generator
from worddiffusion_tpu_torch.utils import safetensors

torch.set_num_threads(1)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _images(b=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 64, 256, 3)).astype(np.float32)


def _full_vae(params):
    vae = AutoencoderKL(PORT_VAE_CFG, with_encoder=True)
    vae.load_state_dict(state_dict_to_torch(jax_vae_to_torch(params, PORT_VAE_CFG)), strict=True)
    return vae.eval()


def test_encode_matches_jax():
    """mean and logvar (clipped to [-30, 20]: the quant_conv biases push
    two logvar channels past both ends), and encode_to_latent with JAX's
    noise handed in, and its posterior mean."""
    params = _vae_params(seed=5)
    qb = params["params"]["quant_conv"]["bias"]
    params["params"]["quant_conv"]["bias"] = qb + np.array([0, 0, 0, 0, 60, -60, 0, 0],
                                                           np.float32)
    x = _images()
    jm = jvae.AutoencoderKL(VAE_CFG)
    mean_j, logvar_j = jax.jit(lambda p, x: jm.apply(p, x, method=jvae.AutoencoderKL.encode))(
        params, x)
    rng = jax.random.PRNGKey(3)
    lat_j = jax.jit(lambda p, x: jvae.encode_to_latent(jm, p, x, rng))(params, x)
    noise = np.array(jax.random.normal(rng, mean_j.shape, jnp.float32))
    vae = _full_vae(params)
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(x))
        lat = encode_to_latent(vae, torch.from_numpy(x), noise=torch.from_numpy(noise))
        lat_mean = encode_to_latent(vae, torch.from_numpy(x), sample=False)
    assert mean.shape == logvar.shape == (2, 8, 32, 4)
    assert logvar[..., 0].min() == 20.0 and logvar[..., 1].max() == -30.0
    _close(mean.numpy(), np.asarray(mean_j))
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), rtol=0, atol=1e-3)
    _close(lat.numpy(), np.asarray(lat_j))
    _close(lat_mean.numpy(), 0.18215 * np.asarray(mean_j))


def test_decode_only_construction_is_unchanged():
    """The trap: --vae_pt files of regeneration are decoder-only and load
    strictly into AutoencoderKL(cfg); the full model loads the full dict
    strictly; seeded random decoders are the same with or without the
    encoder; the decode half refuses to encode."""
    params = _vae_params(seed=6)
    half = AutoencoderKL(PORT_VAE_CFG)
    half.load_state_dict(state_dict_to_torch(
        jax_vae_to_torch(params, PORT_VAE_CFG, decoder_only=True)), strict=True)
    full = _full_vae(params)
    with pytest.raises(RuntimeError):
        half.load_state_dict(full.state_dict(), strict=True)
    a = init_weights_(AutoencoderKL(PORT_VAE_CFG), seed=4)
    b = init_weights_(AutoencoderKL(PORT_VAE_CFG, with_encoder=True), seed=4)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    with pytest.raises(ValueError, match="with_encoder=True"):
        half.encode(torch.zeros(1, 64, 256, 3))


def test_regen_cli_still_loads_a_decoder_only_vae_pt(tmp_path, monkeypatch):
    sd = state_dict_to_torch(jax_vae_to_torch(_vae_params(seed=7), PORT_VAE_CFG,
                                              decoder_only=True))
    torch.save(sd, tmp_path / "vae.pt")
    gt = tmp_path / "words.filter27"
    gt.write_text("000,a01-000u-00 the\n")
    exp = port_cfg(Experiment(vae=VAE_CFG, unet=tiny_exp().unet, data=DataConfig(max_chars=10)))
    monkeypatch.setitem(presets.PRESETS, "tiny_vae_regen", lambda: exp)
    regen, _ = regen_cli.build(regen_cli.build_parser().parse_args([
        "--preset", "tiny_vae_regen", "--gt_file", str(gt), "--vae_pt",
        str(tmp_path / "vae.pt"), "--no_ocr_filter", "1", "--device", "cpu"]))
    for k, v in regen.sampler.vae.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("era", ["to_q", "query"])
def test_diffusers_checkpoint_matches_jax(tmp_path, era):
    """A diffusers-keyed dict of random arrays in either attention naming
    era (the old one with 1x1-conv-shaped attention weights), written with
    the ``safetensors`` package, read by the port's reader and loader and by
    JAX's ``convert_diffusers_vae``: encode and decode agree."""
    from safetensors.numpy import load_file, save_file

    sd = jax_vae_to_torch(_vae_params(seed=8), PORT_VAE_CFG)
    if era == "query":
        old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        renamed = {}
        for k, v in sd.items():
            for new, name in old.items():
                if f".attentions.0.{new}." in k:
                    k = k.replace(f".{new}.", f".{name}.")
                    v = v[:, :, None, None] if v.ndim == 2 else v
            renamed[k] = v
        sd = renamed
        assert "decoder.mid_block.attentions.0.proj_attn.weight" in sd
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(tmp_path / "vae.st"))
    jparams = jvae.convert_diffusers_vae(load_file(str(tmp_path / "vae.st")), VAE_CFG)
    vae = load_diffusers_vae(safetensors.load_file(str(tmp_path / "vae.st")), PORT_VAE_CFG)
    x = _images(seed=9)
    z = np.random.default_rng(10).standard_normal((2, 8, 32, 4)).astype(np.float32)
    jm = jvae.AutoencoderKL(VAE_CFG)
    mean_j, _ = jax.jit(lambda p, x: jm.apply(p, x, method=jvae.AutoencoderKL.encode))(jparams, x)
    img_j = jax.jit(lambda p, z: jvae.decode_from_latent(jm, p, z))(jparams, z)
    with torch.no_grad():
        mean, _ = vae.eval().encode(torch.from_numpy(x))
        img = decode_from_latent(vae, torch.from_numpy(z))
    _close(mean.numpy(), np.asarray(mean_j))
    _close(img.numpy(), np.asarray(img_j))


def _word_pngs(root, n=7):
    """n word crops of varied sizes (grey and RGB) and a gt file naming them."""
    rng = np.random.default_rng(11)
    os.makedirs(root, exist_ok=True)
    words = "the of and to in is was".split()
    lines = []
    for i in range(n):
        h, w = int(rng.integers(30, 150)), int(rng.integers(20, 600))
        img = np.full((h, w, 3), 250, np.uint8)
        img[h // 3: 2 * h // 3, w // 8: 7 * w // 8] = rng.integers(0, 80, 3)
        Image.fromarray(img[..., 0] if i % 2 else img).save(os.path.join(root, f"a01-{i:03d}u-00.png"))
        lines.append(f"{i % 3:03d},a01-{i:03d}u-00 {words[i]}\n")
    gt = os.path.join(root, "train.filter27")
    with open(gt, "w") as f:
        f.writelines(lines)
    return gt


def test_cache_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same PNGs and diffusers file, --deterministic 1, at
    a batch of 3 (a padded tail): the same names, latents within 1e-4; and
    the port's cache is the direct posterior-mean encode (no gradient
    bookkeeping: the pass runs under no_grad)."""
    gt = _word_pngs(tmp_path / "crops")
    params = _vae_params(seed=12)
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v) for k, v in jax_vae_to_torch(params, PORT_VAE_CFG)
               .items()}, str(tmp_path / "vae.st"))
    jexp = Experiment(vae=VAE_CFG, data=DataConfig(max_chars=10))
    monkeypatch.setitem(jpresets.PRESETS, "tiny_vae", lambda: jexp)
    monkeypatch.setitem(presets.PRESETS, "tiny_vae", lambda: port_cfg(jexp))
    argv = ["--preset", "tiny_vae", "--gt_train", gt, "--iam_path", str(tmp_path / "crops"),
            "--stable_dif_path", str(tmp_path / "vae.st"), "--batch_size", "3",
            "--deterministic", "1"]
    jcache_cli.main(argv + ["--out", str(tmp_path / "jax.npz")])
    g0, c0 = groupnorm.bwd_calls, gn_conv.bwd_calls
    cache = cache_cli.main(argv + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    assert (groupnorm.bwd_calls, gn_conv.bwd_calls) == (g0, c0)  # no_grad
    want, got = LatentLookup.load(str(tmp_path / "jax.npz")), LatentLookup.load(
        str(tmp_path / "port.npz"))
    names = sorted(f"a01-{i:03d}u-00.png" for i in range(7))
    assert sorted(got._arrays) == sorted(want._arrays) == names and len(cache) == 7
    for n in names:
        assert got[n].shape == (8, 32, 4) and got[n].dtype == np.float32
        _close(got[n], want[n])
    ds, vae = cache_cli.build(cache_cli.build_parser().parse_args(argv + [
        "--out", "unused", "--device", "cpu"]))
    with torch.no_grad():
        direct = encode_to_latent(vae, torch.from_numpy(np.stack([ds[i]["image"] for i in
                                                                  range(3)])), sample=False)
    for i in range(3):
        np.testing.assert_array_equal(got[ds[i]["image_name"]], direct[i].numpy())


def test_cache_cli_refuses_unported_and_decoder_only(tmp_path):
    gt = _word_pngs(tmp_path / "crops", n=2)
    base = ["--gt_train", gt, "--iam_path", str(tmp_path / "crops"), "--out",
            str(tmp_path / "c.npz"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="jax_vae_to_torch"):
        cache_cli.main(base + ["--vae_ckpt", "d"])
    half = init_weights_(AutoencoderKL(port_cfg(VAE_CFG)), seed=0)
    torch.save(half.state_dict(), tmp_path / "dec.pt")
    with pytest.raises(ValueError, match="decoder-only"):
        cache_cli.build(cache_cli.build_parser().parse_args(
            base + ["--vae_pt", str(tmp_path / "dec.pt")]))


def _train_argv(tmp_path, gt, save, *extra):
    return ["--preset", "tiny", "--gt_train", gt, "--iam_path", str(tmp_path / "crops"),
            "--batch_size", "2", "--epochs", "2", "--ckpt_every_epochs", "1",
            "--preview_ddim", "2", "--save_path", str(tmp_path / save), "--device", "cpu",
            *extra]


def test_train_cli_from_images_resumes_bitwise(tmp_path, monkeypatch):
    """The train CLI without --latent_cache at a tiny preset: each step
    encodes its images with the VAE (posterior noise from the step's
    generator), 2 epochs of 3 steps; a max_steps stop and a resume end
    bitwise equal to the uninterrupted run. The step's latent is the
    direct encode with the step generator's first draw."""
    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    gt = _word_pngs(tmp_path / "crops", n=6)
    full = train_cli.main(_train_argv(tmp_path, gt, "a"))
    assert full.step == 6
    assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["3", "6"]
    assert sorted(os.listdir(tmp_path / "a" / "images")) == ["epoch_0000.png", "epoch_0001.png"]
    part = train_cli.build(train_cli.build_parser().parse_args(_train_argv(tmp_path, gt, "b")))
    assert part.encode_fn is not None and part.dataset.latent_cache is None
    assert part.run(epochs=2, max_steps=4).step == 4
    resumed = train_cli.main(_train_argv(tmp_path, gt, "b", "--loadPrev", "1"))
    assert resumed.step == 6
    for a, b in zip(resumed.model.parameters(), full.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.ema.parameters(), full.ema.parameters()):
        assert torch.equal(a, b)

    # the encode inside the step: the CLI's seeded VAE, the step's generator
    captured = {}

    def spy(images, gen):
        captured["images"] = images
        captured["lat"] = part.encode_fn(images, gen)
        return captured["lat"]

    batch = part._device_batch(next(batches(part.dataset, 2, shuffle=False)))
    make_train_step(part.schedule, part.exp, spy)(part.init_state(), batch)
    vae = make_vae(part.exp.vae, seed=0)
    noise = torch.randn((2, 8, 32, 4), generator=step_generator(0, 0, "cpu"))
    with torch.no_grad():
        mean, logvar = vae.encode(captured["images"])
    assert torch.equal(captured["lat"], (mean + torch.exp(0.5 * logvar) * noise) * 0.18215)
