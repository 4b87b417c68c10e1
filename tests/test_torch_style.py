"""The port's writer-style encoder (``models/style.py``) against the JAX
``StyleEncoder`` on the same parameters (carried across by
``models.convert.jax_style_to_torch``; the GroupNorm affines randomised
away from flax's identity init) and the same numpy-seeded inputs, fp32:
the forward within 1e-4 of the output's largest value, and one jitted-JAX
triplet ``adamw`` step (optax's defaults, the style CLI's optimizer) against
``cli.train_style.train_step``: the loss within 1e-5, the gradients (see
``test_train_step_matches_jax``), the parameters as Adam's first step allows.
Also the layout: 48 GroupNorms, flax's SAME padding at stride 2, and the
converters both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from worddiffusion_tpu.models import style as jstyle
from worddiffusion_tpu_torch.cli.train_style import make_optimizer, train_step
from worddiffusion_tpu_torch.models import style
from worddiffusion_tpu_torch.models.convert import (jax_style_to_torch, state_dict_to_torch,
                                                    torch_style_to_jax)
from worddiffusion_tpu_torch.models.layers import GroupNorm32

# a gradient leaf's largest error over its largest value (at least 1e-3 of the
# largest gradient of any leaf), and the median over the leaves
GRAD_TOL, GRAD_MEDIAN_TOL = 1e-2, 1e-4
OUT_DIM = 16
LR = 1e-4


def _randomise_norms(params, rng):
    def visit(node):
        if isinstance(node, dict) and "scale" in node:
            return {"scale": rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32),
                    "bias": rng.normal(0, 0.3, node["bias"].shape).astype(np.float32)}
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return np.asarray(node)
    return visit(params)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    # three grey levels with noise: anchors, positives and negatives whose
    # features differ well beyond fp32 rounding
    levels = np.array([0.7, 0.6, 0.1, 0.0, -0.7, -0.6], np.float32)[:, None, None, None]
    x = np.clip(levels + rng.uniform(-0.2, 0.2, (6, 32, 64, 3)), -1, 1).astype(np.float32)
    jenc = jstyle.StyleEncoder(out_dim=OUT_DIM, dtype=jnp.float32)
    params = {"params": _randomise_norms(
        jax.device_get(jenc.init(jax.random.PRNGKey(3), x[:1]))["params"], rng)}
    a, p, n = x[:2], x[2:4], x[4:]
    tx = optax.adamw(LR)

    @jax.jit
    def step(params):
        def loss_fn(q):
            return jstyle.triplet_loss(jenc.apply(q, a), jenc.apply(q, p), jenc.apply(q, n), 0.2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, grads, optax.apply_updates(params, updates), jenc.apply(params, x)

    loss, grads, after, out = jax.device_get(step(params))
    return dict(x=x, params=params, loss=loss, grads=grads, after=after, out=out)


def _port(params, dtype=torch.float32):
    enc = style.StyleEncoder(out_dim=OUT_DIM, dtype=dtype)
    enc.load_state_dict(state_dict_to_torch(jax_style_to_torch(params)), strict=True)
    return enc


def _close(ours, theirs, tol, floor=1e-12):
    """max |ours - theirs| <= tol x the larger of theirs' largest and
    ``floor``."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = max(float(np.abs(theirs).max()), floor)
    assert float(np.abs(ours - theirs).max()) <= tol * scale


def test_forward_matches_jax(setup):
    enc = _port(setup["params"])
    with torch.no_grad():
        out = enc(torch.from_numpy(setup["x"]))
    _close(out, setup["out"], 1e-4)
    norms = [m for m in enc.modules() if isinstance(m, GroupNorm32)]
    assert len(norms) == 48 and {m.eps for m in norms} == {1e-6}
    assert {(m.num_channels, m.num_groups) for m in norms if m.num_channels == 64} == {(64, 32)}
    assert max(m.num_channels for m in norms) == 2048


def test_train_step_matches_jax(setup):
    """One triplet step: the loss, the gradients, then the AdamW update.
    The triplet gradient is a difference of feature gradients through 53
    layers, so its fp32 error grows with depth (measured: the worst leaf
    0.82% of its largest, s1b0.c3's bias; the median leaf 1.2e-5); a conv
    bias that a one-channel group's GroupNorm follows has an exact zero
    gradient, hence the floor at 1e-3 of the largest gradient of any leaf."""
    x, params = setup["x"], setup["params"]
    enc = _port(params)
    optimizer = make_optimizer(enc, LR)
    t = torch.from_numpy(x)
    loss = train_step(enc, optimizer, t[:2], t[2:4], t[4:], 0.2)
    assert abs(float(loss) - float(setup["loss"])) <= 1e-5 * abs(float(setup["loss"]))
    grads = torch_style_to_jax({k: p.grad for k, p in enc.named_parameters()})
    after = torch_style_to_jax(enc.state_dict())
    gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(setup["grads"]))
    errors = []
    for g_port, g, a, b in zip(*(jax.tree_util.tree_leaves(tr) for tr in (
            grads, setup["grads"], after, setup["after"]))):
        g, b = np.asarray(g), np.asarray(b)
        scale = max(float(np.abs(g).max()), 1e-3 * gmax)
        errors.append(float(np.abs(np.asarray(g_port) - g).max()) / scale)
        clear = np.abs(g) >= 10 * GRAD_TOL * scale
        assert np.abs(a - b).max() <= 2 * LR
        if clear.any():
            assert np.abs(a - b)[clear].max() <= 1e-3 * LR
    assert max(errors) <= GRAD_TOL and float(np.median(errors)) <= GRAD_MEDIAN_TOL


def test_converters_round_trip(setup):
    enc = _port(setup["params"])
    back = torch_style_to_jax(enc.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(setup["params"])):
        assert np.array_equal(a, np.asarray(b))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(setup["params"]))


def test_stride_two_padding_is_flax_same():
    """Odd sizes (the fixture's are even): the stem pads (3, 3), the pool
    and the stage entries (1, 1) where flax's SAME does."""
    rng = np.random.default_rng(1)
    for h, w in ((33, 47),):
        x = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
        jenc = jstyle.StyleEncoder(dtype=jnp.float32)
        params = jax.device_get(jenc.init(jax.random.PRNGKey(0), x))
        want = np.asarray(jax.jit(jenc.apply)(params, x))
        enc = style.StyleEncoder(dtype=torch.float32)
        enc.load_state_dict(state_dict_to_torch(jax_style_to_torch(params)), strict=True)
        with torch.no_grad():
            got = enc(torch.from_numpy(x))
        _close(got, want, 1e-4)


def test_triplet_loss_and_style_dict_match_jax():
    rng = np.random.default_rng(2)
    a, p, n = (rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3))
    assert np.isclose(float(style.triplet_loss(*map(torch.from_numpy, (a, p, n)))),
                      float(jstyle.triplet_loss(a, p, n)), rtol=1e-6)
    x = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    jenc = jstyle.StyleEncoder(out_dim=4, dtype=jnp.float32)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), x[:1]))
    enc = style.StyleEncoder(out_dim=4, dtype=torch.float32)
    enc.load_state_dict(state_dict_to_torch(jax_style_to_torch(params)), strict=True)
    by_writer = {"a": x[:3], "b": x[3:]}
    ours = style.build_style_dict(enc, by_writer, batch_size=2)
    theirs = jstyle.build_style_dict(jenc, params, by_writer, batch_size=2)
    for w in by_writer:
        _close(ours[w], theirs[w], 1e-4)
