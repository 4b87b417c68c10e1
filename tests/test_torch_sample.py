"""Classifier-free guidance, the conditioned ``WordSampler`` and the
sampling CLI (``cli/sample.py``) of the port against the JAX package's.

The samplers get the same x_init and, where they add noise, the same
noise (JAX's draws handed to the port); the WordSampler comparisons run
deterministic DDIM on a tiny fp32 UNet with random weights, JAX's images
replaced by its latents (no VAE). The CLI runs on the CPU at a tiny
preset and writes its PNGs under the JAX CLI's names."""

import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import DataConfig, DiffusionConfig, Experiment
from worddiffusion_tpu.diffusion.sampler import ddim_sample as jax_ddim
from worddiffusion_tpu.diffusion.sampler import ddpm_sample as jax_ddpm
from worddiffusion_tpu.diffusion.sampler import regen_call_mask
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.generate import sample as jsample
from test_torch_copies import port_cfg
from test_torch_unet_variants import CFG, jax_params, port_unet
from test_torch_vae_ocr import PORT_VAE_CFG, VAE_CFG
from worddiffusion_tpu_torch.cli import sample as sample_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.diffusion.sampler import ddim_sample, ddpm_sample
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.generate.sample import WordSampler
from worddiffusion_tpu_torch.models.layers import init_weights_
from worddiffusion_tpu_torch.models.vae import AutoencoderKL
from worddiffusion_tpu_torch.utils.images import encode_png

torch.set_num_threads(1)
T = 40


def _eps_pair(lib):
    """A conditional and an unconditional eps function, in jnp or torch."""
    as_float = (lambda t: t.astype(jnp.float32)) if lib is jnp else (lambda t: t.float())

    def cond(x, t):
        return 0.5 * lib.tanh(x) + 0.001 * as_float(t)[:, None, None, None]

    def uncond(x, t):
        return 0.2 * x - 0.1

    return cond, uncond


@pytest.mark.parametrize("stochastic", [True, False])
def test_ddpm_cfg_matches_jax(stochastic):
    """CFG scale 2.5 under the regeneration's call mask (stale eps between
    calls), the noise handed in: 1e-5 of the latents' scale."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((T, 2, 4, 8, 4)).astype(np.float32)
    mask = regen_call_mask(T)
    cj, uj = _eps_pair(jnp)
    ct, ut = _eps_pair(torch)
    want = np.asarray(jax_ddpm(NoiseSchedule.linear(T), cj, jax.random.PRNGKey(0),
                               jnp.asarray(x), stochastic=stochastic, call_mask=mask,
                               cfg_scale=2.5, uncond_eps_fn=uj, noise_seq=jnp.asarray(noise)))
    got = ddpm_sample(PortSchedule.linear(T), ct, torch.from_numpy(x), stochastic=stochastic,
                      call_mask=mask, noise_seq=torch.from_numpy(noise), cfg_scale=2.5,
                      uncond_eps_fn=ut).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    plain = ddpm_sample(PortSchedule.linear(T), ct, torch.from_numpy(x), stochastic=stochastic,
                        call_mask=mask, noise_seq=torch.from_numpy(noise)).numpy()
    assert np.abs(plain - got).max() > 1e-2  # the guidance moves the result


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_cfg_matches_jax(eta):
    """DDIM-12 with CFG scale 3; with eta 0.7 the port takes JAX's per-step
    noise (fold_in(rng, idx)): 1e-5 of the latents' scale."""
    x = np.random.default_rng(1).standard_normal((2, 4, 8, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i), x.shape))
                      for i in range(12)])
    cj, uj = _eps_pair(jnp)
    ct, ut = _eps_pair(torch)
    want = np.asarray(jax_ddim(NoiseSchedule.linear(T), cj, rng, jnp.asarray(x), num_steps=12,
                               eta=eta, cfg_scale=3.0, uncond_eps_fn=uj))
    got = ddim_sample(PortSchedule.linear(T), ct, torch.from_numpy(x), num_steps=12, eta=eta,
                      cfg_scale=3.0, uncond_eps_fn=ut, noise_seq=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# (UNet config, WordSampler options, sample() keyword conditionings)
SAMPLER_CASES = {
    "cfg_writer_mix": ({}, dict(cfg_scale=2.0),
                       dict(writer_ids2=[5, 1], mix_rate=np.array([0.25, 0.8], np.float32))),
    "style_replacing": (dict(style_vec_dim=24, style_replace_context=True), {},
                        dict(style_vec=np.random.default_rng(2).standard_normal(
                            (2, 24)).astype(np.float32))),
    "cond_latents": (dict(img_conditioned=True), {},
                     dict(cond_latents=np.random.default_rng(3).standard_normal(
                         (2, 8, 32, 4)).astype(np.float32))),
}


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_word_sampler_conditioning_matches_jax(name, monkeypatch):
    """The JAX WordSampler (no VAE: its latents, read through an identity
    in place of pixel_to_uint8) against the port's ``denoise`` from JAX's
    x_init, DDIM-4: CFG (PAD context, writer mask 0) with a per-sample
    writer mix, style vectors replacing the context, reference latents.
    fp32, 1e-4 of the latents' scale."""
    unet_kw, sampler_kw, cond = SAMPLER_CASES[name]
    cfg = dataclasses.replace(CFG, **unet_kw)
    exp = Experiment(unet=cfg, diffusion=DiffusionConfig(num_steps=T),
                     data=DataConfig(max_chars=10, alphabet="eng_main"))
    init = {k: v for k, v in cond.items() if k in ("style_vec", "cond_latents")}
    params = jax_params(cfg, init)
    words, writers = ["word", "Hello"], [0, 3]
    monkeypatch.setattr(jsample, "pixel_to_uint8", lambda lat: lat)
    jax_sampler = jsample.WordSampler(exp, params, ddim_steps=4, **sampler_kw)
    rng = jax.random.PRNGKey(4)
    want = np.asarray(jax_sampler.sample(words, writers, rng, **cond))
    x_init = np.array(jax.random.normal(jax.random.fold_in(rng, 0), (2, 8, 32, 4)))

    port = WordSampler(port_cfg(exp), port_unet(cfg, params), torch.nn.Identity(), ddim_steps=4,
                       **sampler_kw)
    got = port.denoise(words, writers, torch.from_numpy(x_init), **cond).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_word_sampler_cfg_keeps_reference_latents():
    """CFG on a reference-latent model: the port's unconditional call keeps
    the reference latents, where the JAX sampler's drops them and fails at
    conv_in (8 input channels, 4 given)."""
    unet_kw, _, cond = SAMPLER_CASES["cond_latents"]
    cfg = dataclasses.replace(CFG, **unet_kw)
    exp = Experiment(unet=cfg, diffusion=DiffusionConfig(num_steps=T),
                     data=DataConfig(max_chars=10, alphabet="eng_main"))
    params = jax_params(cfg, cond)
    jax_sampler = jsample.WordSampler(exp, params, ddim_steps=2, cfg_scale=2.0)
    with pytest.raises(Exception, match="conv_in|shape|Conv"):
        jax_sampler.sample(["word", "Hello"], [0, 3], jax.random.PRNGKey(0), **cond)
    port = WordSampler(port_cfg(exp), port_unet(cfg, params), torch.nn.Identity(), ddim_steps=2,
                       cfg_scale=2.0)
    got = port.denoise(["word", "Hello"], [0, 3], torch.zeros(2, 8, 32, 4), **cond)
    assert got.shape == (2, 8, 32, 4) and bool(torch.isfinite(got).all())


@pytest.fixture
def tiny_sample(tmp_path, monkeypatch):
    """A tiny preset (the variants' 64-channel UNet, a narrow VAE), a full
    seeded VAE as a port state dict, and the CLI's argv prefix."""
    exp = port_cfg(Experiment(vae=VAE_CFG, unet=CFG, data=DataConfig(max_chars=10)))
    monkeypatch.setitem(presets.PRESETS, "tiny_sample", lambda: exp)
    vae = init_weights_(AutoencoderKL(PORT_VAE_CFG, with_encoder=True), seed=11)
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    argv = ["--preset", "tiny_sample", "--vae_pt", str(tmp_path / "vae.pt"), "--ddim", "2",
            "--device", "cpu", "--save_path", str(tmp_path / "out")]
    return argv, tmp_path


def _png_size(path) -> tuple[int, int]:
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def test_sample_cli_writes_jax_file_names(tiny_sample):
    """--words with random writers and a per-sample mix drawn from the
    seeded numpy generator in the JAX CLI's order, CFG: the names the JAX
    CLI writes (index, writer, word, mix rate), 256 x 64 PNGs; then the same
    with --crop_whitespace, which crops each image."""
    argv, tmp = tiny_sample
    names = sample_cli.main(argv + ["--words", "the,of", "--n", "2", "--writer2", "5",
                                    "--cfg_scale", "2", "--seed", "7"])
    rng = np.random.default_rng(7)
    wids = [int(rng.integers(0, CFG.num_writers)) for _ in range(4)]
    mix = rng.uniform(0.0, 1.0, 4).astype(np.float32)
    want = [f"{i:05d}_{wid}_{w}_mix{m:.3f}.png"
            for i, (w, wid, m) in enumerate(zip(["the", "the", "of", "of"], wids, mix))]
    assert names == want
    assert sorted(os.listdir(tmp / "out")) == sorted(want)
    assert all(_png_size(tmp / "out" / n) == (256, 64) for n in want)
    cropped = sample_cli.main(argv + ["--words", "the", "--writer", "3", "--crop_whitespace", "1",
                                      "--save_path", str(tmp / "crop")])
    assert cropped == ["00000_3_the.png"]
    w, h = _png_size(tmp / "crop" / cropped[0])
    assert w <= 256 and h <= 64


def test_sample_cli_conditioned_models(tiny_sample):
    """--imgConditioned 1 with a --cond_image PNG (encoded to its
    posterior mean by the VAE) and --wrdChrWrStyl 1 with a --style_dict
    keyed by raw writer ids (through --writers_dict), from --torch_ckpt
    files of those models; a checkpoint with an aux head loads, the head
    left unread."""
    argv, tmp = tiny_sample
    img = np.full((40, 120, 3), 240, np.uint8)
    img[10:30, 10:100] = 20
    (tmp / "ref.png").write_bytes(encode_png(img))
    ocr_cond = port_cfg(dataclasses.replace(CFG, img_conditioned=True, ocr_head=True))
    from worddiffusion_tpu_torch.models.unet import UNet

    torch.save(init_weights_(UNet(ocr_cond), seed=1).state_dict(), tmp / "cond.pt")
    names = sample_cli.main(argv + ["--words", "the", "--writer", "2", "--imgConditioned", "1",
                                    "--cond_image", str(tmp / "ref.png"), "--torch_ckpt",
                                    str(tmp / "cond.pt")])
    assert names == ["00000_2_the.png"]

    style_cfg = port_cfg(dataclasses.replace(CFG, style_vec_dim=4096, style_replace_context=True))
    torch.save(init_weights_(UNet(style_cfg), seed=2).state_dict(), tmp / "style.pt")
    (tmp / "writers.json").write_text('{"w07": 4, "w09": 6}')
    np.savez(tmp / "styles.npz", w07=np.ones(4096, np.float32), w09=np.zeros(4096, np.float32))
    names = sample_cli.main(argv + ["--words", "of,to", "--writer", "4", "--wrdChrWrStyl", "1",
                                    "--style_dict", str(tmp / "styles.npz"), "--writers_dict",
                                    str(tmp / "writers.json"), "--torch_ckpt",
                                    str(tmp / "style.pt"), "--save_path", str(tmp / "style")])
    assert names == ["00000_4_of.png", "00001_4_to.png"]
    with pytest.raises(SystemExit, match="not in --style_dict"):
        sample_cli.main(argv + ["--words", "of", "--writer", "5", "--wrdChrWrStyl", "1",
                                "--style_dict", str(tmp / "styles.npz"), "--torch_ckpt",
                                str(tmp / "style.pt")])


@pytest.mark.parametrize("flags,error,match", [
    (["--ckpt_dir", "ckpt"], SystemExit, "no checkpoint"),
    (["--vae_ckpt", "vae"], SystemExit, "--vae_ckpt and --vae_pt both name the weights"),
    (["--use_ema", "0"], SystemExit, "one parameter set"),
    (["--charImages", "1", "--hiGanArch", "1"], SystemExit, "hiGanArch 1 takes no glyph"),
    (["--hiGanArch", "1"], None, "HiGanDenoiserAdapter"),
    (["--latent", "0"], None, "pixel"),
    (["--imgConditioned", "1"], SystemExit, "--cond_image"),
    (["--wrdChrWrStyl", "1"], SystemExit, "--style_dict"),
])
def test_sample_cli_refuses_what_it_cannot_honour(tiny_sample, flags, error, match):
    """The refusals; the HiGAN+ denoiser and pixel space (``error`` None)
    sample one image (the pixel checkpoint without a VAE, as 3 channels)."""
    argv, tmp = tiny_sample
    if error is not None:
        with pytest.raises(error, match=match):
            sample_cli.main(argv + ["--words", "the"] + flags)
        return
    sampler = sample_cli.build(sample_cli.build_parser().parse_args(argv + ["--words", "the"]
                                                                    + flags))[0]
    if match == "pixel":
        assert sampler.vae is None and sampler.latent_shape == (64, 256, 3)
    else:
        assert type(sampler.model).__name__ == match
    assert sample_cli.main(argv + ["--words", "the", "--writer", "1"] + flags) == ["00000_1_the.png"]


def test_sample_cli_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        sample_cli.main(["--words", "the"])
