"""The port's CLIs against the JAX CLIs' options: every option of the
three JAX parsers is in the port's parser, the regeneration CLI's
``--stable_dif_path`` and ``--ddim`` run on the CPU at a tiny preset, and
the options the port cannot honour raise with their reason."""

import argparse
import logging

import numpy as np
import pytest
import torch

from worddiffusion_tpu.cli import build_latent_cache as jcache_cli
from worddiffusion_tpu.cli import regenerate as jregen_cli
from worddiffusion_tpu.cli import train as jtrain_cli
from worddiffusion_tpu.configs.config import DataConfig, Experiment
from test_torch_copies import port_cfg
from test_torch_train import tiny_exp
from test_torch_vae_ocr import PORT_VAE_CFG, VAE_CFG
from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.models.layers import init_weights_
from worddiffusion_tpu_torch.models.vae import AutoencoderKL, decode_from_latent
from worddiffusion_tpu_torch.utils.safetensors import save_file

torch.set_num_threads(1)


class _Parsed(Exception):
    """Raised in place of parsing, carrying the parser."""


def _jax_cache_parser():
    """The JAX cache CLI builds its parser inside ``main``: stop it at
    ``parse_args`` and keep the parser."""
    def grab(self, *a, **k):
        raise _Parsed(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as got:
            jcache_cli.main([])
    return got.value.args[0]


def _options(parser: argparse.ArgumentParser) -> set[str]:
    return {o for a in parser._actions for o in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("name", ["regenerate", "train", "build_latent_cache"])
def test_port_parsers_hold_every_jax_option(name):
    jax_parser, port_parser = {
        "regenerate": (jregen_cli.build_parser, regen_cli.build_parser),
        "train": (jtrain_cli.build_parser, train_cli.build_parser),
        "build_latent_cache": (_jax_cache_parser, cache_cli.build_parser),
    }[name]
    jax_opts, port_opts = _options(jax_parser()), _options(port_parser())
    assert jax_opts <= port_opts, sorted(jax_opts - port_opts)
    # the port's own: its weight files, the device and the cache's posterior seed
    own = {"--torch_ckpt", "--vae_pt", "--ocr_pt", "--device", "--seed"}
    assert port_opts - jax_opts <= own, \
        sorted(port_opts - jax_opts)


@pytest.fixture
def tiny_regen(tmp_path, monkeypatch):
    """A tiny preset with a narrow VAE, a seeded full VAE written both as a
    port state dict and as a diffusers safetensors file, and a gt file."""
    exp = port_cfg(Experiment(vae=VAE_CFG, unet=tiny_exp().unet, data=DataConfig(max_chars=10)))
    monkeypatch.setitem(presets.PRESETS, "tiny_flags", lambda: exp)
    vae = init_weights_(AutoencoderKL(PORT_VAE_CFG, with_encoder=True), seed=11)
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    save_file(vae.state_dict(), str(tmp_path / "vae.safetensors"))
    gt = tmp_path / "words.filter27"
    gt.write_text("000,a01-000u-00 the\n001,a01-001u-00 of\n")

    def build(*flags):
        return regen_cli.build(regen_cli.build_parser().parse_args([
            "--preset", "tiny_flags", "--gt_file", str(gt), "--no_ocr_filter", "1",
            "--dump_path", str(tmp_path / "regen"), "--device", "cpu", *flags]))

    return build, tmp_path


def test_regen_stable_dif_path_decodes_as_vae_pt(tiny_regen):
    """--stable_dif_path loads the diffusers file as the decode half: the
    same weights and the same images as the same VAE's --vae_pt."""
    build, tmp = tiny_regen
    (a, _), (b, _) = build("--stable_dif_path", str(tmp / "vae.safetensors")), \
        build("--vae_pt", str(tmp / "vae.pt"))
    assert not a.sampler.vae.with_encoder  # the decode half only
    sa, sb = a.sampler.vae.state_dict(), b.sampler.vae.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 32, 4)).astype(
        np.float32))
    with torch.no_grad():
        img_a, img_b = decode_from_latent(a.sampler.vae, z), decode_from_latent(b.sampler.vae, z)
    assert img_a.shape == (2, 64, 256, 3) and torch.equal(img_a, img_b)


def test_regen_ddim_calls_the_unet_n_times(tiny_regen, caplog):
    """--ddim 3: one batch makes 3 UNet calls, and the CLI logs them as the
    JAX CLI does."""
    build, tmp = tiny_regen
    with caplog.at_level(logging.INFO):
        regen, samples = build("--ddim", "3", "--stable_dif_path", str(tmp / "vae.safetensors"))
    assert "denoiser calls per batch: 3 (DDIM)" in caplog.text
    calls = []
    regen.sampler.model.register_forward_hook(lambda *_: calls.append(1))
    stats = regen.run(samples, batch_size=2, seed=0)
    assert stats.generated == 2 and len(calls) == 3


@pytest.mark.parametrize("flags,error", [
    (["--ckpt_dir", "ckpt"], SystemExit), (["--vae_ckpt", "vae"], SystemExit),
    (["--ocr_ckpt", "ocr"], SystemExit), (["--use_ema", "0"], SystemExit),
    (["--hiGanArch", "1"], NotImplementedError), (["--latent", "0"], NotImplementedError),
])
def test_regen_refuses_what_it_cannot_honour(tiny_regen, flags, error):
    build, _ = tiny_regen
    with pytest.raises(error):
        build(*flags)
