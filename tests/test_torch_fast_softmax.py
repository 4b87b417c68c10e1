"""``UNetConfig.fast_softmax=True``, the JAX model's bf16 softmax order, in
the port against the JAX package on the CPU.

JAX's ``_attend(fast_softmax=True)`` keeps the scores and the max-subtract in
fp32, then rounds ``e = exp(s - m)``, its fp32 row sum ``S`` and ``p = e / S``
to bf16 before an fp32 ``p · v``. The port's plain version
(``ops.attention.attention_reference(fast=True)``) computes the same order;
the Function's backward differentiates it; the UNet switches it on in the
attentions that take JAX's ``_attend`` (unfolded, not the maps path).

- The plain fast version against JAX's jitted ``_attend(fast_softmax=True)``
  on bf16 inputs ([B, H, N, D] against [B, N, H, D]): bitwise where a row has
  at most 42 keys (the UNet's contexts); over 300 keys within 2 bf16 ulps
  of JAX's output, as the default mode is within 1 (XLA sums S and p · v in
  another order: one ulp of the output, and S may round to the other
  neighbour, which moves p by one ulp). Its q, k and v gradients against
  JAX's jitted gradients within 2e-2 of each gradient's largest entry (bf16
  gradients through the same casts, reduced in other orders).
- A tiny bf16 UNet with ``fast_softmax=True`` (q and k projections scaled up,
  so that the scores spread and the bf16 roundings differ): each attention
  call, on the inputs the port's UNet gives it, bitwise JAX's fast
  ``_attend`` on the same inputs and nearer it than JAX's default softmax
  (which it differs from); the whole output within the 5% of
  ``test_torch_unet.py::test_unet_matches_jax_bf16_loose``. The whole
  output is not held nearer JAX's True output than its False one: the
  frameworks' other bf16 roundings (bias adds, SiLU, the FF hidden) move it
  by more than the switch does (about 1.1e-2 against 0.7e-2 in L2 at this
  size), in directions the switch does not share.
- The fp32 UNet's parameter gradients with ``fast_softmax=True`` against
  JAX's jitted gradients within the bounds of ``test_torch_train.py`` (1e-4
  of each gradient's largest entry, floored at 1e-2 of the largest anywhere).
- An ``iam_fold``-shaped model (every attention folded) and a
  ``return_attn`` model give bitwise the same output with the switch on and
  off, as JAX's do: neither path reads it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.models.attention import _attend
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from test_torch_unet import CFG, _inputs, _params, _port, _run
from worddiffusion_tpu_torch.models.convert import jax_unet_to_torch
from worddiffusion_tpu_torch.ops import attention

torch.set_num_threads(1)

BF16 = dataclasses.replace(CFG, dtype="bfloat16")
jit_attend = jax.jit(_attend, static_argnums=(3, 4))


def _ulps(got, want):
    """|got - want| in bf16 ulps of want."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) / ulp


def _qkv(b, h, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (nq, nk, nk))


def _port_layout(a):
    """[B, N, H, D] numpy -> bf16 [B, H, N, D], the kernel's layout."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().transpose(1, 2).contiguous()


def _jax_out(q, k, v, scale, fast):
    out = jit_attend(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale, fast)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape,ulps", [
    ((2, 2, 64, 42, 16), 0), ((2, 4, 40, 13, 8), 0), ((1, 2, 256, 300, 32), 2),
], ids=["iam", "ragged", "long"])
def test_plain_fast_matches_jax_attend(shape, ulps):
    b, h, nq, nk, d = shape
    q, k, v = _qkv(*shape, seed=nk)
    scale = d ** -0.5
    want = _jax_out(q, k, v, scale, True)
    got = attention.attention_reference(*map(_port_layout, (q, k, v)), scale, fast=True)
    assert got.dtype == torch.bfloat16
    got = got.transpose(1, 2).float().numpy()
    assert _ulps(got, want).max() <= ulps, _ulps(got, want).max()
    # the switch switches: the default order gives other values
    default = attention.attention_reference(*map(_port_layout, (q, k, v)), scale)
    assert not np.array_equal(default.transpose(1, 2).float().numpy(), got)
    assert _ulps(default.transpose(1, 2).float().numpy(),
                 _jax_out(q, k, v, scale, False)).max() <= min(ulps, 1)


def test_fast_gradients_match_jax_attend():
    """The Function's backward (the plain fast version recomputed under
    autograd) against JAX's jitted gradient of the fast ``_attend``."""
    q, k, v = _qkv(2, 2, 64, 42, 16, seed=5)
    dout = np.random.default_rng(6).standard_normal((2, 64, 2, 16)).astype(np.float32)
    scale = 0.25

    def loss(qq, kk, vv):
        out = _attend(qq, kk, vv, scale, fast_softmax=True)
        return jnp.sum(out.astype(jnp.float32) * dout)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    leaves = [_port_layout(a).requires_grad_() for a in (q, k, v)]
    n0 = attention.bwd_calls
    out = attention.fused_attention(*leaves, scale, True)
    out.backward(_port_layout(dout))
    assert attention.bwd_calls == n0 + 1
    for name, leaf, w in zip("qkv", leaves, want):
        g = leaf.grad.transpose(1, 2).float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max(), err_msg=name)


def _sharpened(params, factor=10.0):
    """The attentions' q and k projections scaled by ``factor``: scores
    spread over a few units, so that the bf16 roundings of the two orders
    differ (at the tiny model's 0.05-scale weights every row is near
    uniform and both orders round alike)."""
    def leaf(path, v):
        keys = {str(getattr(p, "key", p)) for p in path}
        return v * factor if keys & {"to_q", "to_k"} else v

    return jax.tree_util.tree_map_with_path(leaf, params)


def test_unet_fast_softmax_takes_jax_order():
    cfg = dataclasses.replace(BF16, fast_softmax=True)
    params = _sharpened(_params(cfg))
    inp = _inputs(1)
    calls = []
    fused = attention.fused_attention

    def recorded(q, k, v, scale, fast=False):
        out = fused(q, k, v, scale, fast)
        calls.append((q, k, v, scale, fast, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "fused_attention", recorded)
        got = _run(_port(cfg, params), *inp)
    assert len(calls) == 8 and all(c[4] is True for c in calls)
    switched = 0
    for q, k, v, scale, _, out in calls:
        args = [np.asarray(t.transpose(1, 2).float()) for t in (q, k, v)]
        fast, default = (_jax_out(*args, scale, f) for f in (True, False))
        out = out.transpose(1, 2).float().numpy()
        np.testing.assert_array_equal(out, fast)
        if not np.array_equal(fast, default):
            switched += 1
            assert np.abs(out - fast).sum() < np.abs(out - default).sum()
    assert switched == len(calls), switched
    want = np.asarray(jax.jit(JaxUNet(cfg).apply)(params, *inp))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.05 * scale, (np.abs(got - want).max(), scale)
    # the switch reaches the output
    assert not np.array_equal(got, _run(_port(BF16, params), *inp))


def test_unet_fast_softmax_gradients_match_jax():
    cfg = dataclasses.replace(CFG, fast_softmax=True)
    params = _params(cfg)
    x, t, ctx, wid = _inputs()

    def loss(p):
        return jnp.sum(JaxUNet(cfg).apply(p, x, t, ctx, wid) ** 2)

    want = jax_unet_to_torch(jax.jit(jax.grad(loss))(params), cfg)
    model = _port(cfg, params).train()
    n0 = attention.bwd_calls
    out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx).long(),
                torch.from_numpy(wid).long())
    out.square().sum().backward()
    assert attention.bwd_calls == n0 + 8
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 1e-2 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(named[k].grad.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("option", ["attn_fold_context", "return_attn"])
def test_fast_softmax_ignored_on_the_fold_and_maps_paths(option):
    """Every attention of the tiny UNet folds (10 context tokens x 2 heads
    <= 32 channels), or every one sows its maps: the switch leaves the
    output (and the maps) bitwise unchanged, in the port and in JAX."""
    cfg = dataclasses.replace(BF16, **{option: True})
    params = _sharpened(_params(cfg))
    inp = _inputs(1)
    apply = {f: jax.jit(lambda p, *a, m=JaxUNet(dataclasses.replace(cfg, fast_softmax=f)):
                        m.apply(p, *a, mutable=["intermediates"]) if cfg.return_attn
                        else m.apply(p, *a))
             for f in (False, True)}
    jax_out = {f: jax.tree_util.tree_leaves(apply[f](params, *inp)) for f in apply}
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax_out[False], jax_out[True]))
    port_out = {}
    for f in (False, True):
        with torch.no_grad():
            out = _port(dataclasses.replace(cfg, fast_softmax=f), params)(
                *(torch.from_numpy(a) for a in inp[:2]), torch.from_numpy(inp[2]).long(),
                torch.from_numpy(inp[3]).long())
        port_out[f] = [out[0], *out[1].values()] if cfg.return_attn else [out]
    assert len(port_out[True]) == (9 if cfg.return_attn else 1)
    for a, b in zip(port_out[False], port_out[True]):
        assert torch.equal(a, b)
