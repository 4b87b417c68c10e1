"""Port layers (worddiffusion_tpu_torch/models/{layers,encoders,attention}.py)
against their JAX counterparts on the same weights and inputs, fp32.

Weights are random (numpy, seeded) over the JAX parameter tree, so the
zero-initialised output convs carry signal too, and are carried across
with the reference-key exporter's helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.models import attention as jattn
from worddiffusion_tpu.models import encoders as jenc
from worddiffusion_tpu.models import layers as jlayers
from worddiffusion_tpu.models.convert import (
    _inv_attn, _inv_conv, _inv_dense, _inv_norm, _inv_spatial_transformer,
)
from worddiffusion_tpu.configs.config import UNetConfig
from worddiffusion_tpu_torch.models import attention, encoders, layers
from worddiffusion_tpu_torch.models.convert import state_dict_to_torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _randomize(tree, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda l: (0.1 * rng.standard_normal(l.shape)).astype(np.float32), tree
    )


def _init(module, *args):
    return _randomize(module.init(jax.random.PRNGKey(0), *args))


def _load(module, sd):
    module.load_state_dict(state_dict_to_torch(sd), strict=True)
    return module.eval()


def _strip(prefix, sd):
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 17, 599], np.int32)
    want = np.asarray(jlayers.timestep_embedding(jnp.asarray(t), dim))
    got = layers.timestep_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_char_positional_encoding():
    want = np.asarray(jlayers.char_positional_encoding(42, 32))
    got = layers.char_positional_encoding(42, 32).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("c", [64, 16])
def test_group_norm32(c):
    x = np.random.default_rng(0).standard_normal((2, 4, 8, c)).astype(np.float32) * 3 + 1
    p = _init(jlayers.GroupNorm32(), x)
    want = jlayers.GroupNorm32().apply(p, x)
    out = {}
    _inv_norm(p["params"], "gn", out)
    gn = _load(layers.GroupNorm32(c), _strip("gn", out))
    assert gn.num_groups == min(32, c) and gn.eps == 1e-5
    got = gn(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [10, 12])  # 12 > max_seq_len: no positional encoding
def test_character_encoder(L):
    ids = np.random.default_rng(1).integers(0, 54, (2, L)).astype(np.int32)
    jm = jenc.CharacterEncoder(54, 32, max_seq_len=10, dtype=jnp.float32)
    p = _init(jm, ids)["params"]
    want = jm.apply({"params": p}, ids)
    sd = {"embedding.weight": np.asarray(p["embedding"]["embedding"])}
    for lin in ("linear_query", "linear_key", "linear_value"):
        _inv_dense(p["attention"][lin], f"attention.{lin}", sd)
    enc = _load(encoders.CharacterEncoder(54, 32, 10, torch.float32), sd)
    got = enc(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("with_context", [True, False])
def test_cross_attention(with_context):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32) if with_context else None
    jm = jattn.CrossAttention(32, 24 if with_context else None, heads=2, dim_head=16,
                              dtype=jnp.float32)
    p = _init(jm, x, ctx)
    want = jm.apply(p, x, ctx)
    sd = {}
    _inv_attn(p["params"], "a", sd)
    m = _load(attention.CrossAttention(32, 24 if with_context else None, 2, 16), _strip("a", sd))
    got = m(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn1_cross", [True, False])
def test_spatial_transformer(attn1_cross):
    """GroupNorm -> proj_in -> block (shared norm2 or norm1 self-attn,
    then the FF sub-layer through ops.ffn) -> zero-init proj_out."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 8, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jm = jattn.SpatialTransformer(32, n_heads=2, d_head=16, context_dim=32,
                                  attn1_cross=attn1_cross, dtype=jnp.float32)
    p = _init(jm, x, ctx)
    want = jm.apply(p, x, ctx)
    sd = {}
    _inv_spatial_transformer(p["params"], "s", UNetConfig(attn1_cross=attn1_cross), 1, sd)
    m = _load(attention.SpatialTransformer(32, 2, 16, 1, 32, attn1_cross=attn1_cross,
                                           dtype=torch.float32), _strip("s", sd))
    got = m(_nchw(x), torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_feed_forward_tanh_gelu():
    x = np.random.default_rng(5).standard_normal((2, 5, 16)).astype(np.float32)
    jm = jlayers.FeedForward(16, dtype=jnp.float32)
    p = _init(jm, x)["params"]
    want = jm.apply({"params": p}, x)
    sd = {}
    _inv_dense(p["GEGLU_0"]["Dense_0"], "net.0.proj", sd)
    _inv_dense(p["Dense_0"], "net.2", sd)
    got = _load(layers.FeedForward(16), sd)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_upsample_downsample(kind):
    x = np.random.default_rng(6).standard_normal((2, 4, 8, 16)).astype(np.float32)
    jcls, name = (jlayers.Upsample, "conv") if kind == "up" else (jlayers.Downsample, "op")
    jm = jcls(16, dtype=jnp.float32)
    p = _init(jm, x)["params"]
    want = jm.apply({"params": p}, x)
    sd = {}
    _inv_conv(p["Conv2D_0"], name, sd)
    tm = layers.Upsample(16) if kind == "up" else layers.Downsample(16)
    got = _load(tm, sd)(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
