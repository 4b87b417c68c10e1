"""The whole slice: the port's WordSampler against the JAX pipeline on
the same tiny weights and numpy x_init, and a Regenerator round trip.

The JAX side is composed from its parts as ``bench.py`` composes it
(skip-step deterministic ``ddpm_sample`` -> ``latent_to_image`` -> OCR
argmax), with the OCR reading channel 0 of the uint8 image as
``generate/sample.WordSampler`` does.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from worddiffusion_tpu.configs.config import (
    DataConfig, DiffusionConfig, Experiment, UNetConfig, VAEConfig,
)
from worddiffusion_tpu.data.alphabets import OCR_ENG
from worddiffusion_tpu.data.tokenizer import Tokenizer
from worddiffusion_tpu.diffusion.sampler import ddpm_sample, latent_to_image
from worddiffusion_tpu.diffusion.sampler import regen_call_mask as jax_call_mask
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models import ocr as jocr
from worddiffusion_tpu.models import vae as jvae
from worddiffusion_tpu.models.convert import export_reference_unet
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.data.gt import Sample
from worddiffusion_tpu_torch.diffusion.sampler import regen_call_mask
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.generate.regenerate import Regenerator
from worddiffusion_tpu_torch.generate.sample import WordSampler
from worddiffusion_tpu_torch.models.convert import (
    jax_ocr_to_torch, jax_vae_to_torch, state_dict_to_torch,
)
from worddiffusion_tpu_torch.models.ocr import CTCRecognizer
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.models.vae import AutoencoderKL
from worddiffusion_tpu_torch.ops.ctc import collapse_and_decode

torch.set_num_threads(1)

T = 30
EXP = Experiment(
    unet=UNetConfig(model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
                    num_writers=8, max_seq_len=10, dtype="float32"),
    vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                  dtype="float32"),
    diffusion=DiffusionConfig(num_steps=T),
    data=DataConfig(max_chars=10, alphabet="eng_main"),
)
OCR_WIDTHS = (8, 16, 16, 16, 32)
WORDS, WRITERS = ["word", "Hello"], [0, 3]


def _random_tree(shapes, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes
    )


def _weights():
    key = jax.random.PRNGKey(0)
    unet_p = _random_tree(jax.eval_shape(
        JaxUNet(EXP.unet).init, key, jnp.zeros((1, 8, 32, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 10), jnp.int32), jnp.zeros((1,), jnp.int32)), 1, 0.05)
    vae_p = _random_tree(jax.eval_shape(
        jvae.AutoencoderKL(EXP.vae).init, key, jnp.zeros((1, 16, 16, 3)), key), 2, 0.05)
    ocr = jocr.CTCRecognizer(num_classes=len(OCR_ENG), widths=OCR_WIDTHS, dtype=jnp.float32)
    ocr_v = _random_tree(jax.eval_shape(ocr.init, key, jnp.zeros((1, 64, 32, 1))), 3, 0.2)
    return unet_p, vae_p, ocr_v


def _jax_pipeline(unet_p, vae_p, ocr_v, ctx, wid, x_init):
    unet, vae = JaxUNet(EXP.unet), jvae.AutoencoderKL(EXP.vae)
    ocr = jocr.CTCRecognizer(num_classes=len(OCR_ENG), widths=OCR_WIDTHS, dtype=jnp.float32)

    @jax.jit
    def run(x):
        lat = ddpm_sample(
            NoiseSchedule.linear(T), lambda xx, tt: unet.apply(unet_p, xx, tt, ctx, wid),
            jax.random.PRNGKey(0), x, stochastic=False, call_mask=jax_call_mask(T),
        )
        img = latent_to_image(lat, lambda z: jvae.decode_from_latent(vae, vae_p, z * 0.18215))
        img = (img * 255.0).astype(jnp.uint8)
        logits = ocr.apply(ocr_v, img[..., :1].astype(jnp.float32) / 127.5 - 1.0)
        return lat, img, logits

    return [np.asarray(a) for a in run(x_init)]


def _port_sampler(unet_p, vae_p, ocr_v):
    unet = UNet(port_cfg(EXP.unet))
    unet.load_state_dict(state_dict_to_torch(export_reference_unet(unet_p, EXP.unet)))
    vae = AutoencoderKL(port_cfg(EXP.vae))
    vae.load_state_dict(state_dict_to_torch(jax_vae_to_torch(vae_p, port_cfg(EXP.vae),
                                                             decoder_only=True)))
    ocr = CTCRecognizer(num_classes=len(OCR_ENG), widths=OCR_WIDTHS, dtype=torch.float32)
    ocr.load_state_dict(state_dict_to_torch(jax_ocr_to_torch(ocr_v)))
    return WordSampler(port_cfg(EXP), unet, vae, call_mask=regen_call_mask(T), stochastic=False,
                       ocr_apply=ocr.eval())


def test_call_mask_copy_matches_jax():
    for epoch in (0, 4, 6, 11):
        np.testing.assert_array_equal(regen_call_mask(600, epoch), jax_call_mask(600, epoch))
    assert int(regen_call_mask(600)[1:].sum()) == 120


@pytest.mark.parametrize("stochastic", [False, True])
def test_ddpm_sample_matches_jax(stochastic):
    """Same analytic eps_fn on both sides; the stochastic update takes
    its noise from ``noise_seq`` (the frameworks' RNGs differ)."""
    rng = np.random.default_rng(7)
    x_init = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((T, 2, 4, 8, 4)).astype(np.float32)
    mask = jax_call_mask(T)
    want = np.asarray(ddpm_sample(
        NoiseSchedule.linear(T), lambda x, t: 0.3 * x + 0.01 * t[:, None, None, None],
        jax.random.PRNGKey(0), jnp.asarray(x_init), stochastic=stochastic,
        call_mask=mask, noise_seq=jnp.asarray(noise),
    ))
    from worddiffusion_tpu_torch.diffusion.sampler import ddpm_sample as torch_ddpm

    got = torch_ddpm(
        PortSchedule.linear(T), lambda x, t: 0.3 * x + 0.01 * t[:, None, None, None],
        torch.from_numpy(x_init), stochastic=stochastic, call_mask=mask,
        noise_seq=torch.from_numpy(noise),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_word_sampler_matches_jax_pipeline():
    """Tolerances: latents fp32 after 30 steps -> 1e-4 of their scale;
    uint8 pixels within 1 (truncation at a boundary); frame ids equal
    wherever the JAX top-2 logit margin is not a near-tie."""
    unet_p, vae_p, ocr_v = _weights()
    x_init = np.random.default_rng(5).standard_normal((2, 8, 32, 4)).astype(np.float32)
    ctx = Tokenizer.from_name("eng_main", 10).encode_batch(WORDS)
    lat_j, img_j, logits_j = _jax_pipeline(unet_p, vae_p, ocr_v, ctx,
                                           np.asarray(WRITERS, np.int32), x_init)

    sampler = _port_sampler(unet_p, vae_p, ocr_v)
    lat = sampler.denoise(WORDS, WRITERS, torch.from_numpy(x_init))
    img, ids = sampler.decode(lat)
    lat, img, ids = lat.numpy(), img.numpy(), ids.numpy()

    np.testing.assert_allclose(lat, lat_j, rtol=1e-4, atol=1e-4 * np.abs(lat_j).max())
    assert img.dtype == np.uint8 and img.shape == (2, 64, 256, 3)
    assert np.abs(img.astype(int) - img_j.astype(int)).max() <= 1
    assert ids.dtype == np.int32 and ids.shape == (2, 64)
    top2 = np.sort(logits_j, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3 * np.abs(logits_j).max()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids[clear], logits_j.argmax(-1)[clear])


class _ScriptedSampler:
    """Stands in for WordSampler: images are a function of the word, and
    the frame ids spell the word only for words in ``readable``."""

    device = torch.device("cpu")
    exp = port_cfg(EXP)

    def __init__(self, readable):
        self.readable = readable
        self.writer_ids = []

    @staticmethod
    def image(word):
        seed = sum(map(ord, word))
        return np.random.default_rng(seed).integers(0, 256, (64, 256, 3), dtype=np.uint8)

    def sample_async(self, words, writer_ids, generator, phosc=None):
        assert phosc is None  # EXP takes no PHOSC
        self.writer_ids.extend(int(w) for w in writer_ids)
        ids = np.ones((len(words), 16), np.int32)  # all blank ('_' is index 1)
        for b, w in enumerate(words):
            if w in self.readable:
                ids[b, 0:2 * len(w):2] = [OCR_ENG.index(c) for c in w]
        imgs = np.stack([self.image(w) for w in words])
        return torch.from_numpy(imgs), torch.from_numpy(ids)


def test_regenerator_round_trip(tmp_path):
    words = ["ok", "no", "yes", "maybe", "sure"]
    samples = [Sample(f"a01-{i}.png", str(i % 2), w) for i, w in enumerate(words)]
    sampler = _ScriptedSampler(readable={"ok", "yes", "sure"})
    regen = Regenerator(sampler, out_dir=str(tmp_path), sid_change=2, keep_rejected=True)
    stats = regen.run(samples, batch_size=2)  # 3 batches, the last padded
    assert (stats.generated, stats.accepted, stats.skipped_existing) == (5, 3, 0)
    assert sampler.writer_ids == [2, 3, 2, 3, 2, 2]
    accepted = {f"a01-{i}_{i % 2}_{w}.png" for i, w in enumerate(words) if w in sampler.readable}
    assert set(os.listdir(tmp_path)) - {"rejected"} == accepted
    assert set(os.listdir(tmp_path / "rejected")) == {"a01-1_1_no.png", "a01-3_1_maybe.png"}
    for name in accepted | {"rejected/a01-1_1_no.png"}:
        word = name.rsplit("_", 1)[1][:-4]
        back = np.asarray(Image.open(tmp_path / name))
        np.testing.assert_array_equal(back, _ScriptedSampler.image(word))

    again = Regenerator(_ScriptedSampler(readable=set()), out_dir=str(tmp_path)).run(
        samples, batch_size=2)
    assert (again.generated, again.accepted, again.skipped_existing) == (2, 0, 3)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (3, 4, 2), (3, 4, 4)])
def test_png_writer_reads_back(tmp_path, shape):
    from worddiffusion_tpu_torch.utils.images import save_single_images

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    (path,) = save_single_images(img[None], ["x.png"], str(tmp_path))
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, img.reshape(back.shape))


def test_collapse_and_decode_collapses_before_dropping_blanks():
    ids = np.array([[2 + 26 + 0, 2 + 26 + 0, 1, 2 + 26 + 0, 0, 1, 1]])  # a a _ a ' ' _ _
    assert collapse_and_decode(ids, OCR_ENG) == ["aa"]
