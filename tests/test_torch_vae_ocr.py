"""The port's VAE decoder and CTC recognizer against the JAX modules,
fp32, with weights carried by ``jax_vae_to_torch`` / ``jax_ocr_to_torch``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from worddiffusion_tpu.configs.config import VAEConfig
from worddiffusion_tpu.models import ocr as jocr
from worddiffusion_tpu.models import vae as jvae
from test_torch_copies import port_cfg
from worddiffusion_tpu_torch.models.convert import (
    jax_ocr_to_torch, jax_vae_to_torch, state_dict_to_torch,
)
from worddiffusion_tpu_torch.models.ocr import CTCRecognizer
from worddiffusion_tpu_torch.models.vae import AutoencoderKL, decode_from_latent

torch.set_num_threads(1)

# 4 levels of base 32: an 8x32 latent decodes to 64x256
VAE_CFG = VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                    dtype="float32")
PORT_VAE_CFG = port_cfg(VAE_CFG)
OCR_WIDTHS = (8, 16, 16, 16, 32)


def _random_tree(shapes, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32), shapes
    )


def _vae_params(seed=0):
    # the tree does not depend on the image size: trace at 16x16
    shapes = jax.eval_shape(
        jvae.AutoencoderKL(VAE_CFG).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(1),
    )
    return _random_tree(shapes, seed)


def test_vae_state_dict_round_trips_through_diffusers_keys():
    p = _vae_params()
    back = jvae.convert_diffusers_vae(jax_vae_to_torch(p, PORT_VAE_CFG), VAE_CFG)
    flat_p = jax.tree_util.tree_flatten_with_path(p)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_p] == [k for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))


def test_vae_decoder_matches_jax():
    p = _vae_params(seed=1)
    z = np.random.default_rng(2).standard_normal((2, 8, 32, 4)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, z: jvae.decode_from_latent(jvae.AutoencoderKL(VAE_CFG), p, z)
    )(p, z))
    vae = AutoencoderKL(PORT_VAE_CFG)
    vae.load_state_dict(
        state_dict_to_torch(jax_vae_to_torch(p, PORT_VAE_CFG, decoder_only=True)), strict=True
    )
    with torch.no_grad():
        got = decode_from_latent(vae.eval(), torch.from_numpy(z)).numpy()
    assert got.shape == (2, 64, 256, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_ctc_recognizer_matches_jax():
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 32, 1)).astype(np.float32)
    jm = jocr.CTCRecognizer(num_classes=54, widths=OCR_WIDTHS, dtype=jnp.float32)
    v = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), 4, scale=0.2)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    m = CTCRecognizer(num_classes=54, widths=OCR_WIDTHS, dtype=torch.float32)
    m.load_state_dict(state_dict_to_torch(jax_ocr_to_torch(v)), strict=True)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8, 54)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
