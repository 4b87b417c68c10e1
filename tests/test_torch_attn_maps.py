"""``UNetConfig.return_attn``: the port's attention maps against the JAX
model's sown ``intermediates`` (fp32 ``softmax(q kᵀ · scale)`` [B, H, Nq,
Nk] of every attention), for the cross-attention UNet, the self-attention
one and a context-folded one (which does not fold while it sows, as JAX);
the ops-level plain path; and ``utils.metrics.trace``. fp32, 1e-6
absolute on probabilities."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from worddiffusion_tpu.models.unet import UNet as JaxUNet
from test_torch_unet import CFG, _inputs, _params, _port
from worddiffusion_tpu_torch.ops import attention
from worddiffusion_tpu_torch.utils.metrics import trace

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", [dict(), dict(attn1_cross=False),
                                     dict(attn_fold_context=True)],
                         ids=["cross", "self", "fold"])
def test_maps_match_jax_intermediates(variant):
    cfg = dataclasses.replace(CFG, return_attn=True, **variant)
    params = _params(cfg)
    inp = _inputs(2)
    want, state = jax.jit(lambda p, *a: JaxUNet(cfg).apply(p, *a, mutable=["intermediates"]))(
        params, *inp)
    sown = {"/".join(k.key for k in path[:-1]): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]}
    model = _port(cfg, params)
    with torch.no_grad():
        eps, maps = model(*(torch.from_numpy(a) for a in inp[:2]),
                          torch.from_numpy(inp[2]).long(), torch.from_numpy(inp[3]).long())
    np.testing.assert_allclose(eps.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert sorted(maps) == sorted(sown) and len(maps) == 8
    for k, m in maps.items():
        assert m.dtype == torch.float32 and m.shape == sown[k].shape, k
        np.testing.assert_allclose(m.numpy(), sown[k], rtol=0, atol=1e-6, err_msg=k)
    nk = maps["mid_attn/block_0/attn1/attn"].shape[-1]
    assert nk == (64 if variant.get("attn1_cross") is False else 10)  # self: Nq = Nk
    # the maps are handed over, not kept: a later call starts clean
    assert all(a.attn_map is None for _, a in model._attn_names)


def test_attention_with_probs_plain_path():
    """On the CPU: B.4's plain output and the plain maps, rows summing to 1."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 33, 16, generator=g).to(torch.bfloat16) for _ in range(3))
    k, v = k[:, :, :7].contiguous(), v[:, :, :7].contiguous()
    out, p = attention.attention_with_probs(q, k, v, 0.25)
    torch.testing.assert_close(out, attention.attention_reference(q, k, v, 0.25), rtol=0, atol=0)
    assert p.shape == (2, 4, 33, 7) and p.dtype == torch.float32
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 4, 33))
    torch.testing.assert_close(p, attention.attention_probs_reference(q, k, 0.25))


def test_return_attn_model_samples_and_trains_on_cpu():
    """The sampler and the train step take a return_attn model's tuple (the
    maps are ignored); on the CPU the maps path is differentiable."""
    cfg = dataclasses.replace(CFG, return_attn=True)
    model = _port(cfg, _params(cfg)).train()
    x, t, ctx, wid = (torch.from_numpy(a) for a in _inputs())
    eps, maps = model(x, t, ctx.long(), wid.long())
    eps.square().mean().backward()
    assert model.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight.grad is not None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in data["traceEvents"])
